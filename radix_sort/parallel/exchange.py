"""Ragged all-to-all exchange — the distributed radix shuffle's transport.

The reference has no cross-device transport at all (SURVEY.md §2 parallelism
inventory); this is the first-class component the north star adds: rows
labelled with a destination device are exchanged over the mesh axis with
XLA's ``all_to_all`` collective (NCCL on GPUs).

XLA collectives need static shapes, so raggedness is handled with the
fixed-capacity discipline (SURVEY.md §7 hard part 3): each (source, dest)
pair gets a ``capacity``-row slot; local rows are stably partitioned by
destination (the engine's own radix machinery), packed into the (D, C) send
buffer padded with ``fill``, and exchanged.  Per-pair counts travel in the
same all_to_all, and capacity overflow is detected and psum-reduced so every
chip agrees.  Skew-aware destination assignment lives one level up
(dist_sort.py); here the contract is just "respect ``dest``".

All functions must run inside ``shard_map`` over ``axis``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import partition


def ragged_all_to_all(arrays, dest: jnp.ndarray, num_devices: int,
                      capacity: int, axis: str, fills,
                      drop_mask: jnp.ndarray | None = None):
    """Exchange rows of ``arrays`` (tuple of (n,) locals) to devices given by
    ``dest`` (int32 in [0, D)).

    Returns (recv_arrays, recv_counts, overflow):
      recv_arrays: tuple of (D * capacity,) arrays — slot-major: rows from
        source s occupy [s*capacity, s*capacity + recv_counts[s]); the rest
        of each slot is ``fills[i]`` padding.  Within a slot, source order is
        preserved (stable partition) — the property that keeps multi-chip
        sorts stable.
      recv_counts: (D,) int32 valid rows per source slot.
      overflow: bool scalar (globally reduced) — some pair exceeded capacity.
    """
    D = num_devices
    # Rows with drop_mask=True are routed to a virtual bucket past the
    # last device and never packed — the overlapped shuffle
    # (dist_sort.py) exchanges one value-range sub-chunk at a time.
    nb = D
    if drop_mask is not None:
        dest = jnp.where(drop_mask, jnp.int32(D), dest)
        nb = D + 1
    out, counts, starts = partition.stable_partition(dest, arrays, nb)
    return packed_all_to_all(out, counts[:D], starts[:D], D, capacity,
                             axis, fills)


def packed_all_to_all(parted, counts, starts, num_devices: int,
                      capacity: int, axis: str, fills):
    """Exchange ALREADY-partitioned rows: destination d's rows sit at
    ``parted[i][starts[d] : starts[d] + counts[d]]`` (any stable partition
    with contiguous per-destination runs — possibly a slice view of a
    larger multi-bucket partition, so one partition can feed several
    exchanges, e.g. the overlapped shuffle's G sub-chunks).  Same return
    contract as :func:`ragged_all_to_all`."""
    D, C = num_devices, capacity
    overflow_local = jnp.any(counts > C)

    # Pack: send[d, :] = parted[starts[d] : starts[d]+C], masked past
    # counts[d].  One CONTIGUOUS dynamic slice per destination (vmapped →
    # an XLA gather with C-length slices), not a (D*C,)-element gather —
    # element gather runs at ~1.4 GB/s on this chip (docs/DESIGN.md §2.2)
    # and this is the multi-chip hot path.
    j = jnp.arange(C, dtype=jnp.int32)[None, :]                 # (1, C)
    in_slot = j < counts[:, None]                               # (D, C)

    send_bufs = []
    for a, fill in zip(parted, fills):
        # pad by C so starts[d]+C never clamps (dynamic_slice clamps OOB
        # starts, which would silently shift the valid rows).
        a_pad = jnp.concatenate(
            [a, jnp.full((C,), fill, dtype=a.dtype)])
        take = jax.vmap(
            lambda s, arr=a_pad: jax.lax.dynamic_slice_in_dim(arr, s, C))
        buf = take(starts)                                      # (D, C)
        buf = jnp.where(in_slot, buf, jnp.asarray(fill, dtype=a.dtype))
        send_bufs.append(buf)

    recv_bufs = tuple(
        jax.lax.all_to_all(b, axis, split_axis=0, concat_axis=0, tiled=True)
        for b in send_bufs
    )
    recv_counts = jax.lax.all_to_all(counts, axis, split_axis=0,
                                     concat_axis=0, tiled=True)
    overflow = jax.lax.psum(overflow_local.astype(jnp.int32), axis) > 0
    return (tuple(r.reshape(D * C) for r in recv_bufs),
            recv_counts.astype(jnp.int32), overflow)


def slot_valid_mask(num_devices: int, capacity: int,
                    recv_counts: jnp.ndarray) -> jnp.ndarray:
    """(D*C,) bool mask of real rows in a ragged_all_to_all result."""
    j = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    return (j < recv_counts[:, None]).reshape(-1)
