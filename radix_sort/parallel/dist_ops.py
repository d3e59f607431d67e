"""Distributed query operators: hash-partitioned aggregate and join.

BASELINE.json config 5 ("multi-host join+aggregate+sort query ... distributed
radix shuffle"): tables row-sharded over the mesh are re-partitioned
by a multiplicative hash of the key — every equal key lands on exactly one
chip — then the single-chip operators (ops/aggregate.py, ops/join.py) run
per shard.  The shuffle is the same fixed-capacity ragged all_to_all as the
distributed sort.

Results are returned as a :class:`ShardedTable`: globally sharded columns of
per-chip slots plus a per-chip valid-row count (group/match counts differ per
chip, and XLA shapes are static).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import dtypes
from ..config import SortConfig, DEFAULT_CONFIG
from ..ops import aggregate as agg_ops, join as join_ops, partition as part_ops
from ..ops import topk as topk_ops
from ..table import Table
from . import exchange, mesh as mesh_lib


@dataclasses.dataclass
class ShardedTable:
    """Columns are global arrays of shape (D * slot_capacity,), row-sharded;
    shard d's valid rows are the first shard_rows[d] of its slot."""

    columns: dict
    shard_rows: jnp.ndarray  # (D,) int32
    slot_capacity: int

    def to_numpy(self) -> dict:
        """Valid rows of every shard, in shard order.  Each shard is cut to
        its valid rows on its device, so padding never crosses to the
        host."""
        rows = np.asarray(self.shard_rows)
        out = {}
        for k, v in self.columns.items():
            parts = {}
            for s in v.addressable_shards:
                d = (s.index[0].start or 0) // self.slot_capacity
                parts[d] = np.asarray(s.data[:int(rows[d])])
            out[k] = np.concatenate([parts[d] for d in sorted(parts)])
        return out


_GOLDEN32 = np.uint32(0x9E3779B9)
_GOLDEN64 = np.uint64(0x9E3779B97F4A7C15)

# call geometry -> (mesh, jitted shard fn), like dist_sort._SHARD_FN_CACHE:
# repeated dist-operator calls (sweeps, escalation retries) must not
# rebuild/recompile the XLA program.  Bounded FIFO; entries retain the mesh
# so a recycled id() cannot hit.
_DIST_FN_CACHE: dict = {}
_DIST_FN_CACHE_MAX = 64


def _cached_jit(cache_key, mesh, build):
    hit = _DIST_FN_CACHE.get(cache_key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    jitted = jax.jit(build())
    while len(_DIST_FN_CACHE) >= _DIST_FN_CACHE_MAX:
        _DIST_FN_CACHE.pop(next(iter(_DIST_FN_CACHE)))
    _DIST_FN_CACHE[cache_key] = (mesh, jitted)
    return jitted


def _capacity_attempts(base: int, per_dev: int):
    """Host-level shuffle-capacity escalation schedule (same discipline as
    dist_sort): expected-load first, 4x for skew, then the cannot-overflow
    bound (a source only has per_dev rows)."""
    return sorted({max(1, min(per_dev, base)),
                   max(1, min(per_dev, base * 4)), max(1, per_dev)})


def _hash_dest_sub(keys, num_devices: int, num_sub: int = 1):
    """Multiplicative (Fibonacci) hash of the biased key → (destination
    chip, overlap sub-chunk).  Equal keys map to equal (chip, sub-chunk)
    pairs — the partitioned-hash-join invariant, extended so per-sub-chunk
    local operators see every row of a group and their outputs simply
    concatenate.  Chip comes from the hash's top 16 bits, sub-chunk from
    the next 16 (independent enough for load-splitting)."""
    u = dtypes.to_sortable_unsigned(keys)
    if np.dtype(u.dtype).itemsize == 8:
        h = u * _GOLDEN64
        bits = 64
    else:
        # widen u8/u16 keys first: `u16 * uint32` promotes to uint32, so a
        # 16-bit shift would keep the product's LOW half and forfeit the
        # high-bit avalanche multiplicative hashing depends on
        u = u.astype(jnp.uint32)
        h = u * _GOLDEN32
        bits = 32
    top = (h >> dtypes._np_scalar(np.dtype(h.dtype), bits - 16)).astype(
        jnp.uint32)
    dest = (top % np.uint32(num_devices)).astype(jnp.int32)
    if num_sub == 1:
        return dest, jnp.zeros_like(dest)
    nxt = ((h >> dtypes._np_scalar(np.dtype(h.dtype), bits - 32))
           & dtypes._np_scalar(np.dtype(h.dtype), 0xFFFF)).astype(jnp.uint32)
    return dest, (nxt % np.uint32(num_sub)).astype(jnp.int32)


def _hash_dest(keys, num_devices: int) -> jnp.ndarray:
    """Destination chip only (compat wrapper around _hash_dest_sub)."""
    return _hash_dest_sub(keys, num_devices)[0]


def _shuffle_table_chunks(table_cols: Mapping, valid, key: str, D, axis,
                          capacity, overlap_chunks: int = 1):
    """Hash-shuffle rows in ``overlap_chunks`` independently exchanged
    sub-chunks; returns a list of (cols dict, kept count, overflow) per
    sub-chunk.

    ONE (sub, dest)-major stable partition up front feeds every exchange
    (the dist_sort overlap discipline, dist_sort.py::_dist_sort_shard):
    sub-chunk g's all_to_all has no data dependency on sub-chunk g-1's
    local aggregate/probe compute, so XLA's async-collective scheduler
    overlaps exchange with compute — the north star's "exchange overlapped
    with per-chip sort/probe compute" for the hash operators."""
    G = max(1, overlap_chunks)
    names = tuple(sorted(table_cols))
    arrays = tuple(table_cols[n] for n in names)
    dest, sub = _hash_dest_sub(table_cols[key], D, G)
    # Padding rows are never shipped: they route to the virtual bucket
    # past the last (sub, dest) pair (no packed slot, no dead wire
    # traffic) — received rows are valid by construction, so slot validity
    # alone (from recv_counts) identifies live rows.
    bucket = jnp.where(valid, sub * D + dest, jnp.int32(G * D))
    fills = tuple(jnp.zeros((), a.dtype) for a in arrays)
    parted, cnts, starts = part_ops.stable_partition(bucket, arrays,
                                                     G * D + 1)
    out = []
    for g in range(G):
        recv, rcounts, ovf = exchange.packed_all_to_all(
            parted, cnts[g * D:(g + 1) * D], starts[g * D:(g + 1) * D],
            D, capacity, axis, fills)
        # Received rows are valid by construction (padding never ships),
        # so each source slot's valid rows are its prefix — slot-prefix
        # compaction is one DUS pass, not a sort-based compact_mask.
        compacted, kept = part_ops.compact_prefix_slots(recv, rcounts,
                                                        capacity)
        out.append((dict(zip(names, compacted)), kept, ovf))
    return out


def dist_hash_aggregate(table: Table, key: str,
                        aggs: Mapping, mesh: Mesh | None = None,
                        axis: str = mesh_lib.DATA_AXIS,
                        capacity_factor: float = 2.5,
                        config: SortConfig = DEFAULT_CONFIG,
                        overlap_chunks: int = 2):
    """GROUP BY over a row-sharded table.  Returns (ShardedTable, overflow).

    Shuffle-capacity overflow (hash skew: few distinct keys concentrate on
    few chips) escalates host-side like dist_sort — the final attempt's
    capacity equals the per-source row count and cannot overflow.

    ``overlap_chunks`` > 1 (the default) splits the shuffle into hash
    sub-ranges whose all_to_all exchanges overlap the previous sub-chunk's
    local aggregation; equal keys share a sub-chunk, so per-chunk group
    sets are disjoint and simply concatenate."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    D = mesh.devices.size
    G = max(1, overlap_chunks)
    cap_rows = table.capacity
    if cap_rows % D:
        raise ValueError(f"table capacity {cap_rows} must be divisible by "
                         f"mesh size {D} (pad the table)")
    per_dev = cap_rows // D
    base_cap = int(np.ceil(capacity_factor * per_dev / (D * G)))
    aggs_t = tuple(sorted((n, tuple(v)) for n, v in aggs.items()))
    col_names = tuple(sorted(table.columns))
    out_names = _agg_out_names(table, key, aggs)

    for capacity in _capacity_attempts(base_cap, per_dev):
        slot_cap = G * D * capacity  # stitched per-chunk agg capacities

        def build(capacity=capacity):
            def shard_fn(cols, num_rows):
                local_valid = (jnp.arange(per_dev, dtype=jnp.int32)
                               + jax.lax.axis_index(axis) * per_dev
                               ) < num_rows
                chunks = _shuffle_table_chunks(
                    cols, local_valid, key, D, axis, capacity, G)
                parts, part_rows = [], []
                overflow = jnp.zeros((), bool)
                for scols, kept, ovf in chunks:
                    out = agg_ops.hash_aggregate(
                        Table(scols, num_rows=kept), key, aggs,
                        config=config)
                    parts.append(out)
                    part_rows.append(out.num_rows)
                    overflow = jnp.logical_or(overflow, ovf)
                # stitch: valid group rows of each sub-chunk, in g order
                # (groups are disjoint across sub-chunks by hashing).  Each
                # part's valid rows are its prefix (Table contract), so the
                # stitch is a slot-prefix compaction — one DUS pass.
                m = parts[0].capacity
                cat = tuple(
                    jnp.concatenate([p.columns[n] for p in parts])
                    for n in out_names)
                packed, total = part_ops.compact_prefix_slots(
                    cat, jnp.stack(part_rows), m)
                return (dict(zip(out_names, packed)), total[None],
                        jax.lax.psum(overflow.astype(jnp.int32), axis))

            return jax.shard_map(
                shard_fn, mesh=mesh,
                in_specs=({n: P(axis) for n in table.columns}, P()),
                out_specs=({n: P(axis) for n in out_names}, P(axis), P()),
            )

        jitted = _cached_jit(
            ("agg", id(mesh), axis, capacity, per_dev, key, aggs_t, config,
             col_names, G), mesh, build)
        out_cols, rows, overflow = jitted(dict(table.columns),
                                          table.num_rows)
        if not bool(overflow > 0):
            break
    return (ShardedTable(out_cols, rows.astype(jnp.int32), slot_cap),
            overflow > 0)


def _agg_out_names(table, key, aggs):
    return tuple(sorted({key, *aggs.keys()}))


def dist_top_k(table: Table, key: str, k: int, *, largest: bool = True,
               mesh: Mesh | None = None, axis: str = mesh_lib.DATA_AXIS,
               config: SortConfig = DEFAULT_CONFIG) -> Table:
    """Global ORDER BY key (DESC if largest) LIMIT k over a row-sharded table.

    No shuffle and no capacity escalation: each chip selects its local
    top-min(k, rows/chip) candidates (ops/topk.py), the k·D candidate rows
    ride ONE ``all_gather`` (tiny — k is static and small), and the final
    selection runs replicated.  Returns a replicated :class:`Table` of
    capacity k.

    Tie semantics: deterministic (chip index, then local rank) — global
    first-occurrence order is NOT preserved across chips, unlike the
    single-chip ``topk_table``.
    """
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    D = mesh.devices.size
    if table.capacity % D:
        raise ValueError(f"table capacity {table.capacity} must be divisible "
                         f"by mesh size {D} (pad the table)")
    per_dev = table.capacity // D
    if k > table.capacity:
        raise ValueError(f"k={k} exceeds table capacity {table.capacity}")
    kl = min(k, per_dev)
    names = tuple(sorted(table.columns))

    def build():
        def shard_fn(cols, num_rows):
            me = jax.lax.axis_index(axis)
            local_rows = jnp.clip(num_rows - me * per_dev, 0, per_dev)
            local = Table(dict(cols), num_rows=local_rows)
            cand = topk_ops.topk_table(local, key, kl, largest=largest,
                                       config=config)
            gcols = {n: jax.lax.all_gather(cand.columns[n], axis, tiled=True)
                     for n in names}
            grows = jax.lax.all_gather(cand.num_rows, axis)  # (D,)
            slot_valid = (jnp.arange(D * kl, dtype=jnp.int32) % kl
                          ) < jnp.repeat(grows, kl)
            ku = dtypes.to_sortable_unsigned(gcols[key])
            inv_score = ~(ku if largest else ~ku)  # ascending = best-first
            # empty candidate slots sort last: worst primary score, plus
            # validity as SECONDARY key so slots never displace real rows
            # that tie with them on score
            sent = dtypes._np_scalar(np.dtype(inv_score.dtype),
                                     dtypes.sentinel_max_unsigned(
                                         inv_score.dtype))
            inv_score = jnp.where(slot_valid, inv_score, sent)
            invalid = jnp.where(slot_valid, 0, 1).astype(jnp.int32)
            packed = jax.lax.sort(
                (inv_score, invalid) + tuple(gcols[n] for n in names),
                num_keys=2, is_stable=True)  # D*kl >= k by construction
            out = {n: packed[2 + i][:k] for i, n in enumerate(names)}
            return out, jnp.minimum(num_rows, k)

        # check_vma=False: every output is derived solely from all_gather'd
        # candidates and the replicated num_rows, but the static VMA checker
        # cannot see through the multi-operand lax.sort to prove it.
        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=({n: P(axis) for n in names}, P()),
            out_specs=({n: P() for n in names}, P()),
            check_vma=False,
        )

    jitted = _cached_jit(
        ("topk", id(mesh), axis, k, per_dev, key, largest, config, names),
        mesh, build)
    out_cols, total = jitted(dict(table.columns), table.num_rows)
    return Table(out_cols, num_rows=total)


def dist_hash_join(probe: Table, build: Table, key: str,
                   mesh: Mesh | None = None,
                   axis: str = mesh_lib.DATA_AXIS,
                   capacity_factor: float = 2.5,
                   max_duplicates: int = 1,
                   suffixes=("", "_r"),
                   config: SortConfig = DEFAULT_CONFIG,
                   overlap_chunks: int = 2):
    """Distributed inner join of row-sharded tables.
    Returns (ShardedTable, stats) with psum'd match_count and overflow.

    ``overlap_chunks`` > 1 (the default) splits BOTH tables' shuffles into
    the same hash sub-ranges (equal keys meet in the same sub-chunk on the
    same chip), so sub-chunk g's exchange overlaps sub-chunk g-1's local
    build+probe compute and per-chunk match sets concatenate."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    D = mesh.devices.size
    G = max(1, overlap_chunks)
    for t, nm in ((probe, "probe"), (build, "build")):
        if t.capacity % D:
            raise ValueError(f"{nm} capacity {t.capacity} not divisible by "
                             f"mesh size {D}")
    p_per, b_per = probe.capacity // D, build.capacity // D
    p_base = int(np.ceil(capacity_factor * p_per / (D * G)))
    b_base = int(np.ceil(capacity_factor * b_per / (D * G)))

    # output column names: computed like ops/join.py
    out_names = []
    for n in probe.column_names:
        out_names.append(n + suffixes[0])
    for n in build.column_names:
        out_names.append(n + suffixes[1] if (n + suffixes[0]) in out_names
                         else n)

    # Shuffle-capacity escalation (dist_sort discipline), probe and build
    # in lockstep; ONLY shuffle overflow escalates — join-internal overflow
    # (duplicate fanout past max_duplicates) is not fixable by larger
    # exchange slots, so it is reported, not retried.
    p_attempts = _capacity_attempts(p_base, p_per)
    b_attempts = _capacity_attempts(b_base, b_per)
    n_attempts = max(len(p_attempts), len(b_attempts))
    for i in range(n_attempts):
        p_cap = p_attempts[min(i, len(p_attempts) - 1)]
        b_cap = b_attempts[min(i, len(b_attempts) - 1)]
        out_slot_cap = G * D * p_cap * max_duplicates

        def build_fn(p_cap=p_cap, b_cap=b_cap):
            def shard_fn(p_cols, p_rows, b_cols, b_rows):
                me = jax.lax.axis_index(axis)
                pv = (jnp.arange(p_per, dtype=jnp.int32)
                      + me * p_per) < p_rows
                bv = (jnp.arange(b_per, dtype=jnp.int32)
                      + me * b_per) < b_rows
                p_chunks = _shuffle_table_chunks(p_cols, pv, key, D, axis,
                                                 p_cap, G)
                b_chunks = _shuffle_table_chunks(b_cols, bv, key, D, axis,
                                                 b_cap, G)
                parts, part_rows = [], []
                matches = jnp.zeros((), jnp.int32)
                shuffle_over = jnp.zeros((), bool)
                join_over = jnp.zeros((), bool)
                for (ps, p_kept, p_over), (bs, b_kept, b_over) in zip(
                        p_chunks, b_chunks):
                    out, stats = join_ops.hash_join(
                        Table(ps, num_rows=p_kept),
                        Table(bs, num_rows=b_kept),
                        key, max_duplicates=max_duplicates,
                        suffixes=suffixes, config=config)
                    parts.append(out)
                    part_rows.append(out.num_rows)
                    matches = matches + stats["match_count"]
                    shuffle_over = shuffle_over | p_over | b_over
                    join_over = join_over | stats["overflow"]
                # stitch per-chunk match sets (disjoint by hashing); valid
                # rows are each part's prefix — slot-prefix compaction.
                m = parts[0].capacity
                cat = tuple(
                    jnp.concatenate([p.columns[n] for p in parts])
                    for n in out_names)
                packed, total = part_ops.compact_prefix_slots(
                    cat, jnp.stack(part_rows), m)
                return (dict(zip(out_names, packed)), total[None],
                        jax.lax.psum(matches, axis),
                        jax.lax.psum(shuffle_over.astype(jnp.int32), axis),
                        jax.lax.psum(join_over.astype(jnp.int32), axis))

            return jax.shard_map(
                shard_fn, mesh=mesh,
                in_specs=({n: P(axis) for n in probe.columns}, P(),
                          {n: P(axis) for n in build.columns}, P()),
                out_specs=({n: P(axis) for n in out_names}, P(axis), P(),
                           P(), P()),
            )

        jitted = _cached_jit(
            ("join", id(mesh), axis, p_cap, b_cap, p_per, b_per, key,
             max_duplicates, tuple(suffixes), config, G,
             tuple(sorted(probe.columns)), tuple(sorted(build.columns))),
            mesh, build_fn)
        out_cols, rows, matches, shuffle_over, join_over = jitted(
            dict(probe.columns), probe.num_rows,
            dict(build.columns), build.num_rows)
        if not bool(shuffle_over > 0):
            break
    overflow = (shuffle_over > 0) | (join_over > 0)
    stats = {"match_count": matches, "overflow": overflow}
    return ShardedTable(out_cols, rows.astype(jnp.int32), out_slot_cap), stats
