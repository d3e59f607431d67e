"""Hash aggregate (GROUP BY) — BASELINE.json config 3.

Design: instead of a hash table with random probes, aggregation is
*sort-based*: sort rows by the group key, then
reduce runs of equal keys (SURVEY.md §7 M3 "radix-partition then
per-partition reduce").  Output capacity equals input capacity (worst case:
all keys distinct); ``num_rows`` carries the dynamic group count; groups are
emitted in ascending key order (deterministic — stronger than a hash
contract).

Reduction strategy (scatter-free; the engine was first built for a device
whose scatter was slow, docs/DESIGN.md §2): ``jax.ops.segment_*``
(scatter-adds) are avoided on the hot path.  Instead:

  - sum/count: cumulative sums evaluated at run ends; per-group value =
    adjacent difference after compaction.
  - min/max: segmented scan via ``lax.associative_scan`` with reset flags.
  - compaction of the run-end rows to the front: one stable ``lax.sort``
    keyed on not-run-end — the same fast movement primitive the partition
    op uses.

``method="segment"`` keeps the scatter-based reference formulation for
cross-validation in tests.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes
from ..config import SortConfig, DEFAULT_CONFIG
from ..table import Table
from . import sort as sort_ops

AGG_OPS = ("count", "sum", "min", "max", "mean")


def _type_extreme(dtype, max_side: bool):
    d = np.dtype(dtype)
    if d.kind == "f":
        v = np.inf if max_side else -np.inf
    else:
        info = np.iinfo(d)
        v = info.max if max_side else info.min
    return jnp.asarray(v, dtype=d)


def _segmented_scan(vals, is_new, op):
    """Inclusive segmented scan (resets at run starts) for any associative
    elementwise ``op`` — used for min/max always, and for float sums
    (restarting per group keeps precision independent of the global prefix,
    unlike a whole-array cumsum)."""
    def combine(a, b):
        r1, v1 = a
        r2, v2 = b
        return (jnp.logical_or(r1, r2), jnp.where(r2, v2, op(v1, v2)))

    _, out = jax.lax.associative_scan(combine, (is_new, vals))
    return out


def _sorted_rows(table: Table, key: str, needed_cols, config: SortConfig):
    """Sort rows by (biased key, padding-last); returns sorted key image,
    payload dict, and validity.

    Uses XLA's UNSTABLE sort: every aggregation here is order-free within a
    group (count/sum/min/max/mean), so stability buys nothing.  The
    group-compaction sort downstream stays stable to preserve ascending
    group order."""
    keys = table[key]
    valid_in = table.valid_mask()
    ku = dtypes.to_sortable_unsigned(keys)
    sent = dtypes._np_scalar(np.dtype(ku.dtype),
                             dtypes.sentinel_max_unsigned(ku.dtype))
    ku = jnp.where(valid_in, ku, sent)
    names = tuple(sorted(needed_cols))
    # invalid flag as a SECONDARY sort key: the unstable sort may otherwise
    # interleave padding rows among real keys equal to the sentinel value,
    # which would split their group at the run-boundary scan.
    invalid = jnp.where(valid_in, 0, 1).astype(jnp.int32)
    operands = (ku, invalid) + tuple(table[c] for c in names)
    out = jax.lax.sort(operands, num_keys=2, is_stable=False)
    ku_sorted = out[0]
    valid = out[1] == 0
    payload_sorted = dict(zip(names, out[2:]))
    return ku_sorted, payload_sorted, valid


def hash_aggregate(table: Table, key: str,
                   aggs: Mapping[str, Tuple[str, str | None]],
                   config: SortConfig = DEFAULT_CONFIG,
                   method: str = "scan") -> Table:
    """GROUP BY ``key`` with aggregations ``aggs`` (out_name -> (op, col);
    col may be None for "count")."""
    for out_name, (op, _) in aggs.items():
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregation {op!r} for {out_name!r}")
    if method == "segment":
        return _hash_aggregate_segment(table, key, aggs, config)

    cap = table.capacity
    keys_dtype = table[key].dtype
    needed_cols = sorted({c for (_, c) in aggs.values() if c is not None})
    ku_sorted, payload, valid = _sorted_rows(table, key, needed_cols, config)

    if cap == 0:
        return Table({key: table[key],
                      **{n: jnp.zeros((0,), jnp.int32) for n in aggs}},
                     num_rows=0)

    idx = jnp.arange(cap, dtype=jnp.int32)
    is_new = jnp.logical_and(
        valid,
        jnp.logical_or(idx == 0,
                       jnp.concatenate([jnp.ones((1,), bool),
                                        ku_sorted[1:] != ku_sorted[:-1]])))
    nxt_differs = jnp.concatenate(
        [ku_sorted[1:] != ku_sorted[:-1], jnp.ones((1,), bool)])
    nxt_invalid = jnp.concatenate([~valid[1:], jnp.ones((1,), bool)])
    run_end = jnp.logical_and(valid,
                              jnp.logical_or(nxt_differs, nxt_invalid))
    num_groups = jnp.sum(is_new.astype(jnp.int32))

    # Columns evaluated at run ends; cumulative ones are diffed after
    # compaction.
    end_cols = {"__key__": ku_sorted}
    diff_cols = set()
    for out_name, (op, col) in aggs.items():
        if op == "count":
            end_cols[out_name] = jnp.cumsum(valid.astype(jnp.int32))
            diff_cols.add(out_name)
        elif op in ("sum", "mean"):
            v = payload[col]
            z = jnp.where(valid, v, jnp.zeros((), v.dtype))
            if np.dtype(v.dtype).kind == "f":
                # per-group restart keeps float precision local
                end_cols[out_name] = _segmented_scan(z, is_new, jnp.add)
            else:
                # int wraparound makes the global-cumsum diff exact mod 2^w
                end_cols[out_name] = jnp.cumsum(z)
                diff_cols.add(out_name)
            if op == "mean":
                end_cols[out_name + "__cnt__"] = jnp.cumsum(
                    valid.astype(jnp.int32))
                diff_cols.add(out_name + "__cnt__")
        elif op in ("min", "max"):
            v = payload[col]
            fill = _type_extreme(v.dtype, max_side=(op == "min"))
            z = jnp.where(valid, v, fill)
            fn = jnp.minimum if op == "min" else jnp.maximum
            end_cols[out_name] = _segmented_scan(z, is_new, fn)

    # Compact run-end rows to the front: a stable binary partition.
    from . import partition as part_ops

    names = sorted(end_cols)
    packed, _ = part_ops.compact_mask(
        run_end, tuple(end_cols[n] for n in names), method="auto")
    compacted = dict(zip(names, packed))

    def finalize(name):
        c = compacted[name]
        if name in diff_cols:
            prev = jnp.concatenate([jnp.zeros((1,), c.dtype), c[:-1]])
            return c - prev
        return c

    out_cols = {key: dtypes.from_sortable_unsigned(
        compacted["__key__"], keys_dtype)}
    for out_name, (op, _) in aggs.items():
        if op == "mean":
            s = finalize(out_name)
            cnt = finalize(out_name + "__cnt__")
            out_cols[out_name] = s / jnp.maximum(cnt, 1)
        else:
            out_cols[out_name] = finalize(out_name)
    return Table(out_cols, num_rows=num_groups)


def distinct(table: Table, key: str,
             config: SortConfig = DEFAULT_CONFIG) -> Table:
    """SELECT DISTINCT ON (key): one row per distinct key value — the FIRST
    occurrence's full row — emitted in ascending key order.

    Same scatter-free machinery as the aggregate: one STABLE sort of all
    columns by the biased key (stability = first-occurrence semantics; the
    valid-prefix invariant keeps real sentinel-valued keys ahead of padding
    within a tie run), run-start detection, then run-start compaction via a
    second stable sort.  Output capacity equals input capacity; ``num_rows``
    carries the distinct count.
    """
    cap = table.capacity
    if cap == 0:
        return Table(dict(table.columns), num_rows=0)
    valid_in = table.valid_mask()
    ku = dtypes.to_sortable_unsigned(table[key])
    sent = dtypes._np_scalar(np.dtype(ku.dtype),
                             dtypes.sentinel_max_unsigned(ku.dtype))
    ku = jnp.where(valid_in, ku, sent)
    names = table.column_names
    invalid = jnp.where(valid_in, 0, 1).astype(jnp.int32)
    out = jax.lax.sort(
        (ku, invalid) + tuple(table.columns[n] for n in names),
        num_keys=1, is_stable=True)
    ku_sorted, valid = out[0], out[1] == 0
    cols_sorted = out[2:]

    idx = jnp.arange(cap, dtype=jnp.int32)
    is_new = jnp.logical_and(
        valid,
        jnp.logical_or(idx == 0,
                       jnp.concatenate([jnp.ones((1,), bool),
                                        ku_sorted[1:] != ku_sorted[:-1]])))
    num_distinct = jnp.sum(is_new.astype(jnp.int32))
    # run-start compaction: a stable binary partition
    from . import partition as part_ops

    packed, _ = part_ops.compact_mask(is_new, cols_sorted, method="auto")
    return Table(dict(zip(names, packed)), num_rows=num_distinct)


# ---- scatter-based reference formulation (tests cross-validate) ----------

def _segment_reduce(op, vals, seg_ids, num_segments, valid):
    if op == "count":
        return jax.ops.segment_sum(valid.astype(jnp.int32), seg_ids,
                                   num_segments=num_segments)
    v = vals
    if op in ("sum", "mean"):
        z = jnp.where(valid, v, jnp.zeros((), dtype=v.dtype))
        s = jax.ops.segment_sum(z, seg_ids, num_segments=num_segments)
        if op == "sum":
            return s
        c = jax.ops.segment_sum(valid.astype(v.dtype), seg_ids,
                                num_segments=num_segments)
        return s / jnp.maximum(c, 1)
    if op == "min":
        z = jnp.where(valid, v, _type_extreme(v.dtype, True))
        return jax.ops.segment_min(z, seg_ids, num_segments=num_segments)
    if op == "max":
        z = jnp.where(valid, v, _type_extreme(v.dtype, False))
        return jax.ops.segment_max(z, seg_ids, num_segments=num_segments)
    raise ValueError(op)


def _hash_aggregate_segment(table, key, aggs, config):
    cap = table.capacity
    keys_dtype = table[key].dtype
    needed_cols = sorted({c for (_, c) in aggs.values() if c is not None})
    ku_sorted, payload, valid = _sorted_rows(table, key, needed_cols, config)
    idx = jnp.arange(cap, dtype=jnp.int32)
    is_new = jnp.logical_and(
        valid,
        jnp.logical_or(idx == 0,
                       jnp.concatenate([jnp.ones((1,), bool),
                                        ku_sorted[1:] != ku_sorted[:-1]])))
    seg_ids = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    seg_ids = jnp.where(valid, seg_ids, max(cap - 1, 0))
    num_groups = jnp.sum(is_new.astype(jnp.int32))
    group_keys_u = jax.ops.segment_max(
        jnp.where(is_new, ku_sorted, jnp.zeros((), ku_sorted.dtype)),
        seg_ids, num_segments=max(cap, 1))
    out_cols = {key: dtypes.from_sortable_unsigned(group_keys_u, keys_dtype)}
    for out_name, (op, in_col) in aggs.items():
        vals = payload[in_col] if in_col is not None else ku_sorted
        out_cols[out_name] = _segment_reduce(op, vals, seg_ids,
                                             max(cap, 1), valid)
    return Table(out_cols, num_rows=num_groups)
