"""Device mesh helpers.

The reference's "platform bootstrap" (``Common/ComputeState.cpp:14-104``)
enumerates OpenCL platforms and picks the first GPU; the JAX
equivalent enumerates the JAX device space and builds a 1-D (or named N-D)
``jax.sharding.Mesh`` over it.  All distributed operators take the mesh +
axis name rather than discovering devices themselves.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "x"


def make_mesh(num_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    devs = jax.devices()
    if num_devices is None:
        num_devices = len(devs)
    if num_devices > len(devs):
        raise ValueError(
            f"requested {num_devices} devices, only {len(devs)} visible")
    return Mesh(np.array(devs[:num_devices]), (axis,))


def shard_1d(x, mesh: Mesh, axis: str = DATA_AXIS):
    """Place a 1-D array sharded along the mesh axis."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))


def device_banner(mesh: Mesh | None = None) -> str:
    """Platform/device info print, parity with ComputeState's banner
    (Common/ComputeState.cpp:46-63)."""
    lines = [f"jax {jax.__version__} backend={jax.default_backend()}"]
    for d in (mesh.devices.flatten() if mesh is not None else jax.devices()):
        lines.append(f"  device {d.id}: {d.device_kind} ({d.platform})")
    return "\n".join(lines)
