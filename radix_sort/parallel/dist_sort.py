"""Distributed sort over a device mesh — the multi-chip radix shuffle.

The single-device reference caps at 2^25 keys in one GPU's memory
(``src/Parameters.h:29``); this layer is the multi-device answer (SURVEY.md §2
parallelism inventory, §7 M4): keys sharded over a 1-D mesh are sorted
globally with one skew-aware shuffle:

  1. sample     — every chip contributes strided key samples; an all_gather +
                  replicated sort picks D-1 splitters (global quantile
                  estimates).
  2. assign     — each key's destination chip comes from its splitter
                  interval.  Keys *equal* to a splitter (heavy skew — e.g.
                  the Zeros distribution, where every key is identical) are
                  spread across the tied chip range by *global rank among
                  equals* (psum prefix + local cumsum), so degenerate
                  distributions still balance — the skew-aware repartitioning
                  the north star requires.
  3. shuffle    — ragged_all_to_all (exchange.py) with fixed per-pair
                  capacity; overflow is detected globally.
  4. local sort — ONE stable two-key sort on (validity, key); slot-major
                  recv order makes the result globally stable and valid
                  rows form a sorted contiguous prefix.
  5. rebalance  — (dense mode) a second fixed-capacity exchange lands
                  exactly N/D sorted rows on each chip; because the valid
                  prefixes are destination-monotone, its partition is O(D)
                  window arithmetic + an overlapping-DUS unpack, not a
                  sort.

Everything is one jit region per call; collectives compile to
all_to_all/all_gather/psum via shard_map.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import dtypes
from ..config import SortConfig, DEFAULT_CONFIG
from ..ops import partition as part_ops, sort as sort_ops
from . import exchange, mesh as mesh_lib

# jitted shard functions cached per call geometry: repeated dist_sort calls
# (sweeps, escalation retries) must not rebuild/recompile the XLA program.
# Bounded FIFO: each entry pins a Mesh + XLA executables, and long-lived
# sweep/notebook processes would otherwise grow it without limit.  Entries
# store (mesh, jitted) so an id() recycled after eviction cannot hit.
_SHARD_FN_CACHE: dict = {}
_SHARD_FN_CACHE_MAX = 64


def _strided_samples(x: jnp.ndarray, count: int) -> jnp.ndarray:
    n = x.shape[0]
    stride = max(1, n // count)
    s = x[::stride][:count]
    if s.shape[0] < count:  # tiny chunks: repeat to fixed size
        s = jnp.pad(s, (0, count - s.shape[0]), mode="edge")
    return s


def _choose_splitters(all_samples: jnp.ndarray, num_devices: int):
    """D-1 evenly spaced order statistics of the gathered samples."""
    s = jnp.sort(all_samples)
    m = all_samples.shape[0]
    idx = (jnp.arange(1, num_devices, dtype=jnp.int32) * m) // num_devices
    return s[idx]


def _segment_ffill(seeded: jnp.ndarray, is_set: jnp.ndarray) -> jnp.ndarray:
    """Forward-fill ``seeded`` values (valid where ``is_set``) — a
    log-depth associative scan, no gathers."""
    def comb(a, b):
        fa, va = a
        fb, vb = b
        return jnp.logical_or(fa, fb), jnp.where(fb, vb, va)

    _, filled = jax.lax.associative_scan(comb, (is_set, seeded))
    return filled


def _assign_destinations(chunk_u: jnp.ndarray, splitters: jnp.ndarray,
                         num_devices: int, axis: str) -> jnp.ndarray:
    """Destination chip per key, with tie spreading by global rank.

    Fully vectorized (no Python loop over splitters): per-key tie group ids
    come from rank-vs-splitters comparisons; ranks among equals come from
    one stable sort + segment scan; per-group table values are forward-
    filled along the sorted order.  Trace size and collective count are
    O(1) in D; per-key work is O(D) fused compares + two local sorts —
    scalable to 256-chip meshes where the old per-splitter unrolling
    (O(D^2) traced ops, O(n·D) cumsums) was pathological."""
    D = num_devices
    n = chunk_u.shape[0]
    if D == 1:
        return jnp.zeros((n,), jnp.int32)
    S = D - 1
    # lo = #splitters < k, hi = #splitters <= k; untied keys go to chip lo.
    lo = jnp.sum(splitters[None, :] < chunk_u[:, None],
                 axis=1).astype(jnp.int32)
    hi = jnp.sum(splitters[None, :] <= chunk_u[:, None],
                 axis=1).astype(jnp.int32)
    tied = lo != hi
    # group id = index of the (first) splitter equal to the key; untied
    # keys get the sentinel group S and are ignored downstream.
    j = jnp.where(tied, jnp.minimum(lo, S - 1), S)

    my = jax.lax.axis_index(axis)
    iota = jnp.arange(n, dtype=jnp.int32)
    # Sort keys by group id; within a group the original order survives
    # (stable), so position - segment_start = local rank among equals.
    sj, sidx = jax.lax.sort((j, iota), num_keys=1, is_stable=True)
    seg_start = jnp.concatenate(
        [jnp.ones((1,), bool), sj[1:] != sj[:-1]])
    start_pos = _segment_ffill(jnp.where(seg_start, iota, 0), seg_start)
    rank_sorted = iota - start_pos

    # Per-group tie counts fall out of the sorted segment boundaries
    # (searchsorted over the sorted group ids — O(S log n), no n-sized
    # one-hot); ONE collective shares them.
    starts_tbl = jnp.searchsorted(
        sj, jnp.arange(S + 1, dtype=sj.dtype), side="left"
    ).astype(jnp.int32)                                          # (S+1,)
    group_counts = jnp.diff(jnp.append(starts_tbl, jnp.int32(n)))
    local_counts = group_counts[:S]
    counts_mat = jax.lax.all_gather(local_counts, axis)      # (mesh, S)
    # NB mesh size, not interval count: num_devices here may be D*G
    # logical intervals (overlapped shuffle) on a smaller physical mesh.
    P_mesh = counts_mat.shape[0]
    # int32 pinned: under jax_enable_x64 the default sum promotes to int64
    # and the seed scatter below would unsafely cast int64 -> int32 (a
    # JAX-announced future error on every 64-bit dist_sort).
    prev_vec = jnp.sum(
        jnp.where(jnp.arange(P_mesh)[:, None] < my, counts_mat, 0),
        axis=0, dtype=jnp.int32, promote_integers=False)
    total_vec = jnp.maximum(
        jnp.sum(counts_mat, axis=0, dtype=jnp.int32,
                promote_integers=False), 1)

    # Per-splitter tied chip range [lo_s, hi_s] (duplicated splitters give
    # every tied copy the same value range).  All (S, S) — tiny.
    lo_s = jnp.sum(splitters[None, :] < splitters[:, None],
                   axis=1).astype(jnp.int32)
    hi_s = jnp.sum(splitters[None, :] <= splitters[:, None],
                   axis=1).astype(jnp.int32)
    width = hi_s - lo_s                                          # +1 chips

    # Broadcast the four per-group tables to per-key values along the
    # sorted order: scatter each non-empty group's row onto its segment
    # start (≤ S+1 tiny updates; empty groups are routed out of bounds,
    # which XLA drops), then forward-fill.  No n-sized gathers (XLA
    # gather/scatter are off-limits on hot paths — CLAUDE.md) — the only
    # index ops here touch O(S) elements.
    tbl = jnp.stack([prev_vec, total_vec, lo_s, width], axis=1)  # (S, 4)
    tbl = jnp.concatenate([tbl, jnp.zeros((1, 4), jnp.int32)])   # group S
    seed_pos = jnp.where(group_counts > 0, starts_tbl, n)        # n = OOB
    seeds = jnp.zeros((n, 4), jnp.int32).at[seed_pos].set(
        tbl, mode="drop")
    filled = _segment_ffill(seeds, seg_start[:, None])
    prev_f, total_f, lo_f, width_f = (filled[:, 0], filled[:, 1],
                                      filled[:, 2], filled[:, 3])

    grank = prev_f + rank_sorted
    # dest = lo + grank // ceil(total / W): capacity form of the even
    # spread.  The product form grank * W wraps int32 once global tied
    # count x interval width reaches 2^31 (e.g. 2^24 tied keys on a
    # 256-interval mesh) and silently breaks destination monotonicity in
    # grank — the stability contract.  The capacity form never multiplies:
    # grank < total and cap >= total / W keep every term in int32, spread
    # stays monotone in grank, and each destination takes at most cap.
    w1 = width_f + 1
    cap = jnp.maximum((total_f + w1 - 1) // jnp.maximum(w1, 1), 1)
    spread_sorted = lo_f + grank // cap
    # untied sentinel rows carry 0s; masked out below

    # Scatter the spreads back to original key order with a second sort
    # (sort-by-original-index == inverse permutation).
    _, spread = jax.lax.sort((sidx, spread_sorted), num_keys=1,
                             is_stable=False)
    dest = jnp.where(tied, spread, lo)
    return jnp.clip(dest, 0, D - 1)


def _local_sorted_valid_first(ku, payloads, valid, config):
    """Sort received rows with validity as the leading criterion: valid
    rows first (key-major, source-order-stable), padding after.

    On the xla_sort engine this is ONE stable two-key ``lax.sort`` over
    ``(invalid, key)`` — fusing what would otherwise be a compact_mask
    partition pass (itself a full stable sort) followed by the key sort.
    A plain key-only sort cannot replace it: valid rows whose key equals
    the max sentinel would interleave with later sources' padding rows and
    break the valid-prefix contract."""
    if sort_ops._dispatch_engine(config.engine) == "xla_sort":
        invalid = jnp.where(valid, jnp.int32(0), jnp.int32(1))
        out = jax.lax.sort((invalid, ku) + tuple(payloads), num_keys=2,
                           is_stable=True)
        return out[1], tuple(out[2:])
    arrays = (ku,) + tuple(payloads)
    out, _ = part_ops.compact_mask(valid, arrays)
    ku2, payloads2 = out[0], out[1:]
    ks, ps = sort_ops.sort_biased_kv(ku2, payloads2, config)
    return ks, ps


def _dist_sort_shard(chunk_u, payloads, *, D, axis, capacity, samples,
                     config, dense_capacity, overlap_chunks=1):
    sent = dtypes._np_scalar(np.dtype(chunk_u.dtype),
                             dtypes.sentinel_max_unsigned(chunk_u.dtype))
    n = chunk_u.shape[0]
    G = overlap_chunks

    # 1-2: splitters and destinations.  With G > 1 the key space is cut
    # into D*G intervals: interval s maps to chip s // G, sub-chunk s % G.
    smp = _strided_samples(chunk_u, samples)
    all_smp = jax.lax.all_gather(smp, axis, tiled=True)
    splitters = _choose_splitters(all_smp, D * G)
    sidx = _assign_destinations(chunk_u, splitters, D * G, axis)
    dest = sidx // G

    fills = (sent,) + tuple(jnp.zeros((), p.dtype) for p in payloads)

    if G == 1:
        # 3: shuffle.
        (recv, recv_counts, overflow) = exchange.ragged_all_to_all(
            (chunk_u,) + tuple(payloads), dest, D, capacity, axis, fills)
        valid = exchange.slot_valid_mask(D, capacity, recv_counts)

        # 4: local stable sort, valid rows first.
        ks, ps = _local_sorted_valid_first(recv[0], recv[1:], valid,
                                           config)
        v_count = jnp.sum(recv_counts)
    else:
        # 3-4 overlapped (the north-star comm/compute overlap): exchange
        # one value-range sub-chunk while the previous sub-chunk's rows
        # sort locally.  Sub-chunk g's all_to_all has no data dependency
        # on sub-chunk g-1's sort, so XLA's async-collective scheduler
        # overlaps them.  Sub-chunks are ascending value ranges, so the
        # per-chunk sorted results CONCATENATE into the chip's sorted
        # run — no final merge.
        #
        # ONE (sub, dest)-major stable partition up front feeds all G
        # exchanges (each sub-chunk's destinations are a contiguous
        # bucket range); per-g drop_mask partitions would redo the full
        # local sort G times — G× the dominant local data movement.
        sub = sidx % G
        parted, cnts_all, starts_all = part_ops.stable_partition(
            sub * D + dest, (chunk_u,) + tuple(payloads), D * G)
        parts = []
        part_counts = []
        overflow = jnp.zeros((), bool)
        for g in range(G):
            (recv, rcounts, ovf) = exchange.packed_all_to_all(
                parted, cnts_all[g * D:(g + 1) * D],
                starts_all[g * D:(g + 1) * D], D, capacity, axis, fills)
            validg = exchange.slot_valid_mask(D, capacity, rcounts)
            ksg, psg = _local_sorted_valid_first(recv[0], recv[1:],
                                                 validg, config)
            parts.append((ksg,) + tuple(psg))
            part_counts.append(jnp.sum(rcounts))
            overflow = jnp.logical_or(overflow, ovf)
        # stitch: valid prefixes of each sorted sub-chunk, in g order.
        # Each part holds its valid rows as a contiguous prefix (the fused
        # valid-first sort above), so the stitch is a slot-prefix
        # compaction — one DUS pass where a compact_mask partition would
        # pay a full sort network over the G·m concat.
        m = parts[0][0].shape[0]
        cat = tuple(jnp.concatenate([p[i] for p in parts])
                    for i in range(1 + len(payloads)))
        stitched, _ = part_ops.compact_prefix_slots(
            cat, jnp.stack(part_counts), m)
        # Clamp to the global row count: the rebalance's destination
        # windows hold at most D*per_dev global rows — and a chip can
        # never hold more than the global N valid rows, so the slice
        # loses nothing.
        L = min(G * m, D * dense_capacity)
        ks, ps = stitched[0][:L], tuple(a[:L] for a in stitched[1:])
        v_count = sum(part_counts[1:], part_counts[0])

    # 5: rebalance to a dense shard of exactly n rows per chip.  ks/ps
    # hold their valid rows as a contiguous prefix (both branches above),
    # and global positions are monotone in (chip, local row) — so the rows
    # bound for destination d are ALREADY a contiguous slice of the valid
    # prefix: counts/starts fall out of O(D) window arithmetic and the
    # general ragged exchange's partition pass (a full stable sort by
    # destination) is skipped entirely.  Position arithmetic is int32:
    # valid for global N < 2^31 (the per-chip cap is 2^27; document-level
    # bound, not a runtime check).
    counts_all = jax.lax.all_gather(v_count, axis)                  # (D,)
    my = jax.lax.axis_index(axis)
    g0 = jnp.sum(jnp.where(jnp.arange(D) < my, counts_all, 0),
                 dtype=jnp.int32, promote_integers=False)
    vc = jnp.minimum(v_count, ks.shape[0]).astype(jnp.int32)
    drange = jnp.arange(D, dtype=jnp.int32)
    lo2 = jnp.clip(drange * n - g0, 0, vc)
    hi2 = jnp.clip((drange + 1) * n - g0, 0, vc)
    # counts2 <= n = dense_capacity (a destination window is n positions
    # wide), so this exchange cannot overflow.
    counts2 = hi2 - lo2
    (recv2, recv2_counts, overflow2) = exchange.packed_all_to_all(
        (ks,) + tuple(ps), counts2, lo2, D, dense_capacity, axis, fills)
    # Unpack: source s's valid prefix lands at the running offset (slot-
    # prefix compaction).  Every global position in my window has exactly
    # one owner, so the prefixes sum to exactly n valid rows — one HBM
    # pass replaces the old sort-based compact_mask.
    unpacked, _ = part_ops.compact_prefix_slots(recv2, recv2_counts,
                                                dense_capacity)
    ks_final = unpacked[0][:n]
    ps_final = tuple(a[:n] for a in unpacked[1:])
    return (ks_final,) + ps_final + (
        jnp.logical_or(overflow, overflow2).astype(jnp.int32),)


def dist_sort_kv(keys: jnp.ndarray, values: Any = None,
                 mesh: Mesh | None = None, axis: str = mesh_lib.DATA_AXIS,
                 capacity_factor: float = 2.5, samples_per_device: int = 64,
                 config: SortConfig = DEFAULT_CONFIG,
                 overlap_chunks: int = 2):
    """Globally sort sharded ``keys`` (and permute ``values`` alongside)
    over the mesh.  Returns (keys, values, overflow) with the same global
    shape/sharding; ``overflow`` True means a shuffle slot overflowed
    (retry with a larger ``capacity_factor``).

    ``overlap_chunks`` > 1 (default 2) splits the shuffle into that many
    value-range sub-chunks whose all_to_all exchanges overlap the previous
    sub-chunk's local sort (comm/compute overlap; results concatenate, no
    merge).  Set 1 to disable.

    Arbitrary n is padded to D ⋅ ceil(n/D) with the max sentinel (reference
    padding discipline, src/RadixSortGPU.cpp:269-297) and sliced back.
    """
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    D = mesh.devices.size
    n = keys.shape[0]
    padded_n = -(-max(n, D) // D) * D

    orig_dtype = np.dtype(keys.dtype)
    ku = dtypes.to_sortable_unsigned(keys)
    sent = dtypes._np_scalar(np.dtype(ku.dtype),
                             dtypes.sentinel_max_unsigned(ku.dtype))
    ku = sort_ops._pad_1d(ku, padded_n, sent)
    leaves, treedef = jax.tree.flatten(values) if values is not None else ((), None)
    leaves = tuple(sort_ops._pad_1d(l, padded_n, 0) for l in leaves)

    per_dev = padded_n // D
    # Overlap only helps when there is wire time to hide; at D=1 the
    # sub-chunk pipeline is pure overhead (measured 2.2x at G=2 on the
    # D=1 CPU mesh with scripts/dist_overhead_probe.py).
    G = max(1, overlap_chunks) if D > 1 else 1
    samples = min(samples_per_device * G, per_dev)

    # Fixed-capacity shuffle with host-level escalation: start with the
    # expected-load capacity; if any (src, dst) slot overflowed (heavy skew,
    # e.g. all-equal keys where stability forces contiguous-rank placement),
    # retry larger.  The final attempt (capacity = per_dev) can never
    # overflow — a source only has per_dev rows (regardless of sub-chunk).
    base_cap = max(1, min(per_dev,
                          int(np.ceil(capacity_factor * per_dev / (D * G)))))
    attempts = sorted({base_cap, min(per_dev, base_cap * 4), per_dev})

    spec = P(axis)
    num_leaves = len(leaves)
    for capacity in attempts:
        cache_key = (id(mesh), axis, D, capacity, samples, config,
                     per_dev, num_leaves, G)
        hit = _SHARD_FN_CACHE.get(cache_key)
        jitted = hit[1] if hit is not None and hit[0] is mesh else None
        if jitted is None:
            fn = functools.partial(
                _dist_sort_shard, D=D, axis=axis, capacity=capacity,
                samples=samples, config=config, dense_capacity=per_dev,
                overlap_chunks=G)
            shard_fn = jax.shard_map(
                lambda k, pl: fn(k, pl),
                mesh=mesh,
                in_specs=(spec, tuple(spec for _ in range(num_leaves))),
                out_specs=tuple([spec] * (1 + num_leaves)) + (P(),),
            )
            jitted = jax.jit(shard_fn)
            while len(_SHARD_FN_CACHE) >= _SHARD_FN_CACHE_MAX:
                _SHARD_FN_CACHE.pop(next(iter(_SHARD_FN_CACHE)))
            _SHARD_FN_CACHE[cache_key] = (mesh, jitted)
        out = jitted(ku, leaves)
        ks, ps, overflow = out[0], out[1:-1], out[-1]
        if not bool(overflow > 0):
            break
    ks = dtypes.from_sortable_unsigned(ks[:n], orig_dtype)
    ps = tuple(p[:n] for p in ps)
    values_out = jax.tree.unflatten(treedef, ps) if treedef is not None else None
    return ks, values_out, overflow > 0


def dist_sort(keys: jnp.ndarray, **kwargs) -> jnp.ndarray:
    ks, _, overflow = dist_sort_kv(keys, None, **kwargs)
    return ks
