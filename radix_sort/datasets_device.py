"""Device-side dataset generation.

Functional twins of the host generators in datasets.py, built from
jax.random/iota so benchmark data is materialized directly in device
memory, with no host-to-device copy of the input.

``Random`` (fixed-seed mt19937 parity) intentionally has no device twin —
mt19937 bit-parity is a host-oracle concern; benchmarks use the uniform
generator for that distribution instead.
"""

from __future__ import annotations

import numpy as np

from . import dtypes


def generate(name: str, dtype, n: int, seed: int = 0):
    """Device-resident dataset by distribution name.  Returns a jnp array.

    Supported names mirror datasets.py: Zeros, RandomDistributed, Random
    (approximated by uniform bits — see module docstring), Range,
    InvertedRange.
    """
    import jax
    import jax.numpy as jnp

    d = np.dtype(dtype)
    u = dtypes.unsigned_container(d)

    if name == "Zeros":
        return jnp.zeros(n, dtype=d)
    if name in ("RandomDistributed", "Random"):
        bits = jax.random.bits(
            jax.random.key(seed), (n,),
            dtype=jnp.uint32 if u.itemsize == 4 else jnp.uint64)
        if d.kind == "f":
            out = jax.random.uniform(jax.random.key(seed), (n,),
                                     dtype=d, minval=-1e9, maxval=1e9)
        else:
            out = dtypes.jax_bitcast(bits, d) if d.kind == "i" \
                else bits.astype(d)
        if name == "RandomDistributed" and n >= 2:
            if d.kind == "f":
                # match the host twin (datasets.py): plant the dtype extremes
                # at the ends so the inf edge cases are exercised on device.
                out = out.at[0].set(d.type(-np.inf)).at[n - 1].set(
                    d.type(np.inf))
            else:
                info = np.iinfo(d)
                out = out.at[0].set(d.type(info.min)).at[n - 1].set(
                    d.type(info.max))
        return out
    if name in ("Range", "InvertedRange"):
        base = jnp.arange(n, dtype=u if d.kind != "f" else d)
        if d.kind == "i":
            base = dtypes.jax_bitcast(
                base + dtypes._np_scalar(u, np.iinfo(d).min), d)
        elif d.kind == "u":
            base = base.astype(d)
        return base[::-1] if name == "InvertedRange" else base
    raise ValueError(f"unknown dataset {name!r}")


ALL_NAMES = ("Zeros", "RandomDistributed", "Random", "Range",
             "InvertedRange")
