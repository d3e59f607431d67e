"""Process runtime: the compile cache and the multi-process bootstrap.

The reference is single-process (SURVEY.md §2 parallelism inventory); a
deployment over several hosts runs one process per host, and each must join
a coordination service before any collective compiles.  This wraps
`jax.distributed.initialize` with the engine's conventions plus a minimal
health-check — the failure-detection hook the reference lacked entirely
(SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time

# The checkout root: the compile cache lives at a fixed path under it.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed.  Otherwise the cache goes to ``<checkout>/.jax_cache``
    — a fixed path, because the path is part of what a later process must
    find again."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def _env_coordinator() -> str | None:
    return os.environ.get("JAX_COORDINATOR_ADDRESS") or None


@dataclasses.dataclass
class RuntimeInfo:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int
    coordinator: str | None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> RuntimeInfo:
    """Join (or skip, single-host) the distributed runtime.

    Multi-process mode is entered when any argument is given explicitly OR
    ``JAX_COORDINATOR_ADDRESS`` is set; with no cluster environment to
    detect, the launcher then also passes ``num_processes`` and
    ``process_id``.  Safe to call on a single host: becomes a no-op
    describing the local topology.
    """
    import jax

    multi = (coordinator_address is not None
             or num_processes not in (None, 1)
             or _env_coordinator() is not None)
    if multi:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return RuntimeInfo(
        process_id=jax.process_index(),
        num_processes=jax.process_count(),
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
        coordinator=coordinator_address or _env_coordinator(),
    )


# mesh -> compiled heartbeat executable; reusing the compiled collective
# keeps repeated health checks (the normal monitoring pattern) from paying
# a jit compile per call — and keeps the compile OUT of the timed window.
# Bounded FIFO for the same reason as dist_sort._SHARD_FN_CACHE: entries
# pin a Mesh + executable, and a monitor that rebuilds meshes per check
# would otherwise grow it without limit.
_HEARTBEAT_CACHE: dict = {}
_HEARTBEAT_CACHE_MAX = 16


def _compiled_heartbeat(mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = id(mesh)
    hit = _HEARTBEAT_CACHE.get(key)
    # the cached entry retains the mesh, so its id cannot be recycled
    if hit is not None and hit[0] is mesh:
        return hit[1]

    axis = mesh.axis_names[0]
    D = mesh.devices.size

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P(axis), out_specs=P(axis))
    def _heartbeat(t):
        return jnp.reshape(jax.lax.psum(jnp.sum(t), axis), (1,))

    arg = jax.ShapeDtypeStruct(
        (D,), jnp.int32, sharding=NamedSharding(mesh, P(axis)))
    compiled = jax.jit(_heartbeat).lower(arg).compile()
    while len(_HEARTBEAT_CACHE) >= _HEARTBEAT_CACHE_MAX:
        _HEARTBEAT_CACHE.pop(next(iter(_HEARTBEAT_CACHE)))
    _HEARTBEAT_CACHE[key] = (mesh, compiled)
    return compiled


def health_check(mesh=None, timeout_s: float = 30.0) -> dict:
    """All-reduce a per-device heartbeat across the mesh with a REAL
    collective (lax.psum inside shard_map over the mesh axis), so the
    reduction crosses every device link: a hung or dead host surfaces as a
    timeout
    or a wrong count here rather than a silent stall inside a later
    collective.  The psum runs in a daemon thread so ``timeout_s`` bounds
    the wait even when a peer never shows up.

    The collective is AOT-compiled (and cached per mesh) BEFORE the timer
    starts: a compile must never read as a dead peer.
    """
    import threading

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from . import mesh as mesh_lib

    if mesh is None:
        mesh = mesh_lib.make_mesh()
    axis = mesh.axis_names[0]
    D = mesh.devices.size

    # One token per device, sharded over the mesh axis; each shard psums
    # over the axis → every device must participate for the sum to arrive.
    # Setup failures (wedged backend, compile error) are exactly what a
    # health check exists to report — status dict, never a raise.
    try:
        tokens = jax.device_put(
            jnp.ones((D,), jnp.int32), NamedSharding(mesh, P(axis)))
        heartbeat = _compiled_heartbeat(mesh)
    except Exception as e:  # noqa: BLE001
        return {"ok": False, "error": f"heartbeat setup failed: {e}"}

    t0 = time.time()
    result: dict = {}

    def _run():
        try:
            out = np.asarray(heartbeat(tokens))
            result["total"] = int(out[0])
        except Exception as e:  # noqa: BLE001
            result["error"] = str(e)

    th = threading.Thread(target=_run, daemon=True)
    th.start()
    th.join(timeout_s)
    elapsed = round(time.time() - t0, 3)
    if th.is_alive():
        return {"ok": False, "error": f"heartbeat timed out after "
                f"{timeout_s}s (dead or hung peer)", "elapsed_s": elapsed}
    if "error" in result:
        return {"ok": False, "error": result["error"], "elapsed_s": elapsed}
    ok = result.get("total") == D
    return {"ok": bool(ok), "devices": D,
            "heartbeat_total": result.get("total"),
            "process_count": jax.process_count(),
            "elapsed_s": elapsed}
