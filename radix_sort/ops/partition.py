"""Stable partition / radix partition — the reusable reorder primitive.

One radix pass (histogram → scan → scatter) generalized to arbitrary bucket
ids: the same machinery the reference's per-pass reorder implements
(``src/kernels/RadixSort.cl:74-119``), exposed as a first-class operator
because filter, hash join, hash aggregate and the distributed shuffle are all
"partition by some digit" at heart (SURVEY.md §7 M3-M4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import ranking


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def stable_partition(bucket_ids: jnp.ndarray, arrays, num_buckets: int,
                     block_elems: int = 1 << 16, method: str = "sort"):
    """Stably reorder ``arrays`` so rows with equal ``bucket_ids`` become
    contiguous, buckets in ascending id order.

    Returns (reordered_arrays, bucket_counts, bucket_starts) where
    ``bucket_starts`` is the exclusive prefix of counts — the bucket
    boundaries downstream operators (join probe, shuffle send) slice on.

    method="sort": stable ``lax.sort`` keyed on the bucket id, payloads
    riding as extra operands.
    method="rank": the radix rank+scatter pipeline (the reference-shaped
    path; a cumsum rank then one scatter per array).
    method="auto" (what the operators pass): resolves to "sort".
    """
    n = bucket_ids.shape[0]
    ids = bucket_ids.astype(jnp.int32)
    if resolve_method(method) == "sort":
        out = jax.lax.sort((ids,) + tuple(arrays), num_keys=1,
                           is_stable=True)
        out = tuple(out[1:])
        total = _counts_big(ids, num_buckets, n)
        starts = jnp.cumsum(total) - total
        return out, total, starts

    m = min(block_elems, _next_pow2(max(n, 1)))
    padded = -(-max(n, 1) // m) * m
    if padded != n:
        pad = jnp.full((padded - n,), num_buckets, dtype=jnp.int32)
        ids = jnp.concatenate([ids, pad])
        arrays = tuple(
            jnp.concatenate([a, jnp.zeros((padded - n,), dtype=a.dtype)])
            for a in arrays
        )
    db = ids.reshape(padded // m, m)
    dest, _, total = ranking.stable_dest(
        db, num_buckets + 1, sequential_blocks=padded >= (1 << 22))
    out = ranking.apply_destinations(dest.reshape(-1), tuple(arrays))
    out = tuple(a[:n] for a in out)
    total = total[:num_buckets]
    starts = jnp.cumsum(total) - total
    return out, total, starts


def _counts_big(ids: jnp.ndarray, num_buckets: int, n: int) -> jnp.ndarray:
    """Bucket histogram without materializing an (n, R) one-hot: blockwise
    one-hot reductions (XLA fuses the compare into the sum per block)."""
    if n == 0:
        return jnp.zeros((num_buckets,), jnp.int32)
    m = min(n, 1 << 15)
    padded = -(-n // m) * m
    idp = jnp.concatenate(
        [ids, jnp.full((padded - n,), num_buckets, jnp.int32)]) \
        if padded != n else ids
    blocks = idp.reshape(padded // m, m)
    counts = ranking.block_digit_counts(blocks, num_buckets + 1)
    return counts.sum(axis=0)[:num_buckets]


def compact_prefix_slots(arrays, counts: jnp.ndarray, slot_len: int):
    """Compact S fixed-length slots whose valid rows are each slot's prefix
    into one contiguous prefix (order preserved across and within slots).

    ``arrays`` are (S * slot_len,); slot s's valid rows are its first
    ``counts[s]``.  Returns (arrays, total) with every valid row packed at
    the front; rows past ``total`` are unspecified.

    This is the all_to_all receive layout (exchange.slot_valid_mask) and
    the shape of every sub-chunk stitch — compact_mask on such input pays
    a full stable sort for what is slot bookkeeping.  Here: S overlapping
    ``dynamic_update_slice`` writes in ascending slot order, each
    overwriting the previous slot's padding tail — one HBM pass.
    """
    counts = counts.astype(jnp.int32)
    S = counts.shape[0]
    offs = jnp.cumsum(counts, dtype=jnp.int32) - counts
    outs = []
    for a in arrays:
        slots = a.reshape(S, slot_len)
        # +slot_len so the last write never clamps (offs[s] <= s*slot_len).
        buf = jnp.zeros((S * slot_len + slot_len,), a.dtype)
        for s in range(S):
            buf = jax.lax.dynamic_update_slice(buf, slots[s], (offs[s],))
        outs.append(buf[:S * slot_len])
    return tuple(outs), jnp.sum(counts, dtype=jnp.int32,
                                promote_integers=False)


METHODS = ("auto", "sort", "rank")


def resolve_method(method: str) -> str:
    """The concrete partition method for ``method``; "auto" is "sort"."""
    if method not in METHODS:
        raise ValueError(f"unknown partition method {method!r}; expected "
                         f"one of {METHODS}")
    return "sort" if method == "auto" else method


def compact_mask(mask: jnp.ndarray, arrays, block_elems: int = 1 << 16,
                 method: str = "sort"):
    """Stable compaction: rows with mask=True move to the front, preserving
    order; returns (compacted_arrays, kept_count).  This is stable_partition
    with buckets (kept=0, dropped=1).

    ``method`` is passed to :func:`stable_partition`."""
    bucket = jnp.where(mask, 0, 1).astype(jnp.int32)
    out, counts, _ = stable_partition(bucket, arrays, 2,
                                      block_elems=block_elems,
                                      method=method)
    return out, counts[0]


def radix_partition(keys_u: jnp.ndarray, arrays, bits: int, shift: int = 0,
                    block_elems: int = 1 << 16):
    """Partition rows by a key digit: the building block of the partitioned
    hash join and of the cross-chip shuffle (digit selects the destination
    partition/chip)."""
    radix = 1 << bits
    digits = (keys_u >> shift) & (radix - 1)
    return stable_partition(digits.astype(jnp.int32), arrays, radix,
                            block_elems=block_elems)
