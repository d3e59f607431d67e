"""Prefix-scan utilities — public wrappers over the scan machinery.

The reference exposes its scan only as an internal kernel pair
(scanhistograms/pastehistograms, RadixSort.cl:125-197); here scans are
first-class operators since the whole engine is built on them (ranks,
partitions, compaction, segment boundaries).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exclusive_scan(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix sum of a 1-D array (jnp.cumsum, XLA's scan)."""
    return jnp.cumsum(x) - x


def inclusive_scan(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.cumsum(x)


def segment_boundaries(sorted_keys: jnp.ndarray):
    """Run-boundary mask and segment ids for a sorted key column: the
    building block of the sorted GROUP BY (ops/aggregate.py)."""
    n = sorted_keys.shape[0]
    if n == 0:
        z = jnp.zeros((0,), jnp.int32)
        return z.astype(bool), z
    first = jnp.ones((1,), bool)
    rest = sorted_keys[1:] != sorted_keys[:-1]
    is_new = jnp.concatenate([first, rest])
    seg_ids = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    return is_new, seg_ids


def segmented_exclusive_scan(x: jnp.ndarray,
                             seg_ids: jnp.ndarray) -> jnp.ndarray:
    """Exclusive scan that restarts at each segment boundary (seg_ids must
    be non-decreasing)."""
    n = x.shape[0]
    if n == 0:
        return x
    total = jnp.cumsum(x) - x
    # subtract the running total at each segment start
    first = jnp.concatenate([jnp.ones((1,), bool),
                             seg_ids[1:] != seg_ids[:-1]])
    seg_start_val = jax.ops.segment_sum(
        jnp.where(first, total, jnp.zeros((), total.dtype)), seg_ids,
        num_segments=n)
    return total - seg_start_val[seg_ids]
