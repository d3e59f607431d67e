"""Multi-pass LSD radix sort — the engine's centerpiece.

A JAX re-design of ``RadixSortGPU<T>`` (``src/RadixSortGPU.h:36-124``).
Where the reference runs 8-16 host-synchronized kernel rounds (≈48 sync
points per sort, SURVEY.md §3.3), the whole sort here is ONE jitted XLA
region: pad → bias → passes (rank + scatter with ping-pong buffers realized
by XLA buffer donation) → unbias → slice.  Upload/download, padding and
ping-pong management all live inside the compiler.

Engines:
  - ``xla_sort``:  wraps ``jax.lax.sort`` (XLA's own sort) — the production
    path.
  - ``xla_radix``: the full LSD radix pipeline built from ops/ranking.py —
    portable, used to validate the radix machinery bit-exactly.
  - ``auto``:      resolves to ``xla_sort``.

All engines route keys through the order-preserving unsigned transform
(dtypes.to_sortable_unsigned — the reference's OFFSET bias,
``src/RadixSortGPU.cpp:436``), so i32/i64/u32/u64 (and f32/f64) share one
code path and one ordering semantics.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes
from ..config import SortConfig, DEFAULT_CONFIG
from ..status import EngineError, OperationStatus
from . import ranking


def _require_x64_if_needed(dtype):
    if np.dtype(dtype).itemsize == 8 and not jax.config.jax_enable_x64:
        raise EngineError(
            OperationStatus.INITIALIZATION_FAILED,
            "64-bit keys need jax_enable_x64 "
            "(jax.config.update('jax_enable_x64', True))",
        )


def _pad_1d(x: jnp.ndarray, padded: int, fill):
    n = x.shape[0]
    if n == padded:
        return x
    return jnp.concatenate(
        [x, jnp.full((padded - n,), fill, dtype=x.dtype)], axis=0
    )


def _radix_pipeline(keys_u: jnp.ndarray, payloads, config: SortConfig,
                    total_bits: int):
    """The hot loop (reference ``calculate``, src/RadixSortGPU.cpp:311-346):
    for each pass, rank by the pass digit and scatter keys + payloads.
    ``keys_u`` must already be padded to (B*M,) unsigned."""
    R = config.radix
    M = config.block_elems
    B = keys_u.shape[0] // M
    num_passes = total_bits // config.bits_per_pass
    seq = keys_u.shape[0] >= (1 << 22)

    arrays = (keys_u,) + tuple(payloads)
    for p in range(num_passes):
        shift = p * config.bits_per_pass
        ku = arrays[0]
        digits = ((ku >> dtypes._np_scalar(np.dtype(ku.dtype), shift))
                  & dtypes._np_scalar(np.dtype(ku.dtype), R - 1))
        digits = digits.astype(jnp.int32).reshape(B, M)
        dest, _, _ = ranking.stable_dest(digits, R, sequential_blocks=seq)
        arrays = ranking.apply_destinations(dest.reshape(-1), arrays)
    return arrays[0], arrays[1:]


def _radix_engine_biased(keys_u, payloads, config: SortConfig):
    """Trace-level radix sort of biased unsigned keys: pad → passes → slice.
    Usable inside jit/shard_map (n = static shape)."""
    n = keys_u.shape[0]
    total_bits = dtypes.key_bits(keys_u.dtype)
    padded = config.padded_size(n)
    sent = dtypes._np_scalar(np.dtype(keys_u.dtype),
                             dtypes.sentinel_max_unsigned(keys_u.dtype))
    ku = _pad_1d(keys_u, padded, sent)
    pls = tuple(_pad_1d(p, padded, 0) for p in payloads)
    ku, pls = _radix_pipeline(ku, pls, config, total_bits)
    return ku[:n], tuple(p[:n] for p in pls)


def sort_biased_kv(keys_u, payloads, config: SortConfig = DEFAULT_CONFIG):
    """Engine-dispatched sort of already-biased unsigned keys + payload
    tuple.  Trace-level (no jit wrapper): the building block the distributed
    layer calls inside shard_map."""
    if _dispatch_engine(config.engine) == "xla_radix":
        return _radix_engine_biased(keys_u, tuple(payloads), config)
    return _xla_sort_engine(keys_u, payloads, keys_u.shape[0])


@functools.partial(jax.jit, static_argnames=("config", "n"))
def _sort_biased_jit(keys_u, payloads, config: SortConfig, n: int):
    return _radix_engine_biased(keys_u, payloads, config)


def _xla_sort_engine(keys_u, payloads, n):
    # Key-only sorts need no stability (equal keys are bit-identical), so
    # they take the unstable sort.  Payload-carrying sorts keep the stable
    # contract.
    if payloads and np.dtype(keys_u.dtype).itemsize == 4:
        # Two-key stability-by-uniqueness: sort (key, position) unstably.
        # The composite key is unique, so its one consistent order IS the
        # stable order, bit-identical to is_stable=True.  Position is
        # per-call local (shard-local under shard_map), which matches the
        # per-shard stability contract.
        iota = jax.lax.iota(jnp.uint32, keys_u.shape[0])
        out = jax.lax.sort((keys_u, iota) + tuple(payloads), num_keys=2,
                           is_stable=False)
        return out[0], out[2:]
    out = jax.lax.sort((keys_u,) + tuple(payloads), num_keys=1,
                       is_stable=bool(payloads))
    return out[0], out[1:]


ENGINES = ("auto", "xla_sort", "xla_radix")


def _dispatch_engine(engine: str) -> str:
    """Resolve "auto" to a concrete engine; any name outside ``ENGINES``
    raises.  XLA's own sort is the one production path: on the GPU it can
    lower to a CUB radix sort.  ``xla_radix`` is the portable LSD pipeline
    kept as the reference radix implementation."""
    if engine not in ENGINES:
        raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                          f"unknown engine {engine!r}; expected one of "
                          f"{ENGINES}")
    return "xla_sort" if engine == "auto" else engine


def _sort_impl(keys: jnp.ndarray, payloads, config: SortConfig):
    if keys.ndim != 1:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"keys must be 1-D, got shape {keys.shape}")
    _require_x64_if_needed(keys.dtype)
    n = keys.shape[0]
    orig_dtype = np.dtype(keys.dtype)
    keys_u = dtypes.to_sortable_unsigned(keys)
    if _dispatch_engine(config.engine) == "xla_radix":
        ku, pls = _sort_biased_jit(keys_u, tuple(payloads), config, n)
    else:
        ku, pls = _xla_sort_engine(keys_u, payloads, n)
    return dtypes.from_sortable_unsigned(ku, orig_dtype), pls


def sort(keys: jnp.ndarray, config: SortConfig = DEFAULT_CONFIG,
         engine: str | None = None) -> jnp.ndarray:
    """Key-only sort (ascending, stable by construction)."""
    if engine is not None:
        config = dataclasses.replace(config, engine=engine)
    out, _ = _sort_impl(keys, (), config)
    return out


def sort_kv(keys: jnp.ndarray, values: Any,
            config: SortConfig = DEFAULT_CONFIG,
            engine: str | None = None):
    """Key-value sort: ``values`` is a pytree of 1-D arrays with the same
    length as ``keys``; every leaf is permuted alongside the keys.

    This makes the reference's *vestigial* permutation machinery real: its
    reorder kernel allocated and ping-ponged permutation buffers but never
    used them (#define PERMUT commented out, src/RadixSortGPU.cpp:578,
    SURVEY.md §2 capability notes)."""
    if engine is not None:
        config = dataclasses.replace(config, engine=engine)
    leaves, treedef = jax.tree.flatten(values)
    for leaf in leaves:
        if leaf.shape[0] != keys.shape[0]:
            raise EngineError(
                OperationStatus.HOST_BUFFERS_FAILED,
                f"value leaf length {leaf.shape[0]} != keys {keys.shape[0]}")
    out_keys, out_leaves = _sort_impl(keys, tuple(leaves), config)
    return out_keys, jax.tree.unflatten(treedef, out_leaves)


def argsort(keys: jnp.ndarray, config: SortConfig = DEFAULT_CONFIG,
            engine: str | None = None) -> jnp.ndarray:
    """Stable argsort: the permutation the reference's PERMUT path intended."""
    iota = jnp.arange(keys.shape[0], dtype=jnp.int32)
    _, perm = sort_kv(keys, iota, config=config, engine=engine)
    return perm
