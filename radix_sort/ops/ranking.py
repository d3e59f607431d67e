"""Stable-rank machinery: the heart of every radix pass.

This is a vectorized re-design of the reference's three device phases
(histogram → scan → reorder, ``src/kernels/RadixSort.cl:16,125,74``): instead
of workgroups accumulating local-memory histograms and scattering per item,
we compute, for every element, its *global stable destination*

    dest = global_base[digit] + block_prefix[block, digit] + within_rank

with vectorized one-hot reductions and cumulative sums.  The digit-major
(digit, then block, then position) ordering of the combined exclusive scan is
exactly the reference's radix-major histogram layout that makes the scatter
stable (``src/kernels/RadixSort.cl:69``, SURVEY.md §2 #2).

Blocks play the role of the reference's 1024 "virtual processors": each block
is a contiguous sublist, ranked independently, then stitched together by the
(tiny) cross-block exclusive scan — which is also exactly the decomposition
the multi-chip path reuses with chips in place of blocks (parallel/dist_sort).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def block_digit_counts(digits: jnp.ndarray, radix: int) -> jnp.ndarray:
    """Per-block digit histogram: (B, M) int32 digits → (B, R) int32 counts.

    One-hot compare + reduce; XLA fuses the broadcast into the reduction so
    the (B, M, R) one-hot is never materialized.  Histogram-kernel analogue
    (RadixSort.cl:16-71)."""
    iota = jnp.arange(radix, dtype=digits.dtype)
    return (digits[:, :, None] == iota).astype(jnp.int32).sum(axis=1)


def _block_rank_body(db: jnp.ndarray, radix: int):
    """Within one block: counts (R,) and exclusive within-bucket rank (M,)."""
    iota = jnp.arange(radix, dtype=db.dtype)
    oh = (db[:, None] == iota).astype(jnp.int32)          # (M, R)
    incl = jnp.cumsum(oh, axis=0)                         # (M, R)
    wr = jnp.take_along_axis(incl - oh, db[:, None].astype(jnp.int32),
                             axis=1)[:, 0]
    return incl[-1], wr


def stable_dest(digits: jnp.ndarray, radix: int,
                sequential_blocks: bool = True):
    """Global stable destinations for a bucketed reorder.

    Args:
      digits: (B, M) int32 bucket ids in [0, radix).
      radix: number of buckets R.
      sequential_blocks: iterate blocks with ``lax.map`` (O(M*R) live memory,
        for big inputs) instead of vectorized (O(B*M*R), faster for small).

    Returns:
      dest:   (B, M) int32 — flat destination index in [0, B*M).
      counts: (B, R) int32 — per-block digit histogram.
      total:  (R,)  int32 — global digit histogram.
    """
    digits = digits.astype(jnp.int32)
    if sequential_blocks and digits.shape[0] > 1:
        counts, wr = jax.lax.map(lambda db: _block_rank_body(db, radix), digits)
    else:
        counts, wr = jax.vmap(lambda db: _block_rank_body(db, radix))(digits)

    total = counts.sum(axis=0)                             # (R,)
    # Exclusive scan, digit-major then block — the stability-preserving
    # layout (RadixSort.cl:69): all digit-r elements of earlier blocks
    # precede digit-r elements of this block.
    global_base = jnp.cumsum(total, axis=0) - total        # (R,)
    block_prefix = jnp.cumsum(counts, axis=0) - counts     # (B, R)
    base = global_base[None, :] + block_prefix             # (B, R)
    dest = jnp.take_along_axis(base, digits, axis=1) + wr  # (B, M)
    return dest, counts, total


def apply_destinations(dest_flat: jnp.ndarray, arrays):
    """Scatter each array to its destinations: out[dest[i]] = a[i].

    The reorder-kernel analogue (RadixSort.cl:74-119).  ``unique_indices``
    holds by construction (dest is a permutation)."""
    return tuple(
        jnp.zeros_like(a).at[dest_flat].set(a, unique_indices=True)
        for a in arrays
    )
