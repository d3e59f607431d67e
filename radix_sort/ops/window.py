"""Window (analytic) functions and segmented sort.

Beyond-reference capability (the reference sorts flat arrays only —
src/RadixSortGPU.h:36-124); a query engine needs the SQL window family:
ROW_NUMBER / RANK / DENSE_RANK, running aggregates, LAG / LEAD and
FIRST_VALUE over (PARTITION BY, ORDER BY), plus CUB-style segmented sort.

Design: ONE multi-operand ``lax.sort`` per window call orders rows by
(validity, partition, order, input-position) — the trailing iota operand
makes the unstable sort a stable lexicographic sort AND doubles as the
forward permutation.  Every window output is then a run-boundary mask plus
a segmented ``associative_scan`` in the sorted domain (no scatter/gather;
results return to input order via a second sort keyed on the permutation —
docs/DESIGN.md §2).  All shapes static; padding rows ride along as their own
trailing partition and never perturb valid rows' results.
"""

from __future__ import annotations

from typing import Any, Mapping

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes
from ..config import SortConfig, DEFAULT_CONFIG
from ..status import EngineError, OperationStatus
from ..table import Table
from .aggregate import _segmented_scan


def _boundary(first_true: bool, changed: jnp.ndarray) -> jnp.ndarray:
    head = jnp.full((1,), first_true, bool)
    return jnp.concatenate([head, changed])


def _shift_right(x: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    """x shifted k positions toward higher indices, front-filled."""
    k = min(k, x.shape[0])
    pad = jnp.full((k,), fill, x.dtype)
    return jnp.concatenate([pad, x[:x.shape[0] - k]]) if k else x


def _shift_left(x: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    k = min(k, x.shape[0])
    pad = jnp.full((k,), fill, x.dtype)
    return jnp.concatenate([x[k:], pad]) if k else x


# ---------------------------------------------------------------------------
# segmented sort
# ---------------------------------------------------------------------------

def segmented_sort_kv(seg_ids: jnp.ndarray, keys: jnp.ndarray,
                      values: Any = None,
                      config: SortConfig = DEFAULT_CONFIG):
    """Sort ``keys`` (stably, ascending) within each segment of a
    non-decreasing ``seg_ids`` column; segment layout is unchanged.

    The CUB/`DeviceSegmentedSort` capability done with one sort: instead of
    one kernel launch per segment, a single lexicographic
    (segment, key, position) sort over the whole array — batch-size-one
    segments and million-row segments cost the same single XLA sort.

    Returns ``(sorted_keys, sorted_values)`` (``sorted_values`` is None when
    ``values`` is None).
    """
    n = keys.shape[0]
    if seg_ids.shape[0] != n:
        raise EngineError(
            OperationStatus.HOST_BUFFERS_FAILED,
            f"seg_ids length {seg_ids.shape[0]} != keys {n}")
    leaves, treedef = jax.tree.flatten(values)
    su = dtypes.to_sortable_unsigned(seg_ids)
    ku = dtypes.to_sortable_unsigned(keys)
    iota = jnp.arange(n, dtype=jnp.int32)
    out = jax.lax.sort((su, ku, iota) + tuple(leaves), num_keys=3,
                       is_stable=False)
    sorted_keys = dtypes.from_sortable_unsigned(out[1], keys.dtype)
    if values is None:
        return sorted_keys, None
    return sorted_keys, jax.tree.unflatten(treedef, out[3:])


def segmented_sort(seg_ids: jnp.ndarray, keys: jnp.ndarray,
                   config: SortConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """Key-only :func:`segmented_sort_kv`."""
    out, _ = segmented_sort_kv(seg_ids, keys, None, config)
    return out


# ---------------------------------------------------------------------------
# window functions
# ---------------------------------------------------------------------------

#: spec kinds → number of operands they take from the spec tuple
_ZERO_ARG = ("row_number", "rank", "dense_rank", "cum_count")
_COL_ARG = ("cum_sum", "cum_min", "cum_max", "first_value")
_SHIFT_ARG = ("lag", "lead")


def _normalize_spec(name, spec):
    if isinstance(spec, str):
        spec = (spec,)
    kind = spec[0]
    if kind in _ZERO_ARG:
        if len(spec) != 1:
            raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                              f"window spec {name}: {kind} takes no args")
        return (kind,)
    if kind in _COL_ARG:
        if len(spec) != 2:
            raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                              f"window spec {name}: {kind} takes (col,)")
        return (kind, spec[1])
    if kind in _SHIFT_ARG:
        if len(spec) < 2 or len(spec) > 4:
            raise EngineError(
                OperationStatus.INITIALIZATION_FAILED,
                f"window spec {name}: {kind} takes (col[, offset[, fill]])")
        col = spec[1]
        offset = int(spec[2]) if len(spec) > 2 else 1
        fill = spec[3] if len(spec) > 3 else 0
        if offset < 1:
            raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                              f"window spec {name}: offset must be >= 1")
        return (kind, col, offset, fill)
    raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                      f"window spec {name}: unknown kind {kind!r}")


def window(partition: jnp.ndarray, order: jnp.ndarray,
           specs: Mapping[str, tuple],
           columns: Mapping[str, jnp.ndarray] | None = None,
           valid: jnp.ndarray | None = None,
           config: SortConfig = DEFAULT_CONFIG) -> dict:
    """Compute a batch of window outputs over (PARTITION BY ``partition``,
    ORDER BY ``order`` ascending), all from ONE sort.

    ``specs`` maps output name → spec tuple:
      ``("row_number",)``            1-based position within partition
      ``("rank",)``                  SQL RANK (ties share, gaps after)
      ``("dense_rank",)``            SQL DENSE_RANK (ties share, no gaps)
      ``("cum_count",)``             alias of row_number
      ``("cum_sum", col)``           running sum of ``columns[col]``
      ``("cum_min", col)`` / ``("cum_max", col)``
      ``("first_value", col)``       partition-first value in order
      ``("lag", col[, k[, fill]])``  value k rows earlier in the partition
      ``("lead", col[, k[, fill]])`` value k rows later

    ``valid`` (optional bool mask) demotes masked rows to a trailing
    partition of their own so garbage tail values can never interleave with
    real partitions.  Results are returned aligned to the INPUT row order.
    """
    n = partition.shape[0]
    specs = {name: _normalize_spec(name, s) for name, s in specs.items()}
    columns = dict(columns or {})
    needed = sorted({s[1] for s in specs.values() if len(s) > 1})
    for c in needed:
        if c not in columns:
            raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                              f"window: spec references missing column {c!r}")
        if columns[c].shape[0] != n:
            raise EngineError(
                OperationStatus.HOST_BUFFERS_FAILED,
                f"window: column {c!r} length {columns[c].shape[0]} != {n}")
    if n == 0:
        return {name: _empty_output(s, columns) for name, s in specs.items()}

    pu = dtypes.to_sortable_unsigned(partition)
    ou = dtypes.to_sortable_unsigned(order)
    iota = jnp.arange(n, dtype=jnp.int32)
    inv = (jnp.zeros((n,), jnp.int32) if valid is None
           else jnp.where(valid, 0, 1).astype(jnp.int32))
    payload = tuple(columns[c] for c in needed)
    out = jax.lax.sort((inv, pu, ou, iota) + payload, num_keys=4,
                       is_stable=False)
    inv_s, pu_s, ou_s, perm = out[0], out[1], out[2], out[3]
    cols_s = dict(zip(needed, out[4:]))

    part_new = _boundary(True, (pu_s[1:] != pu_s[:-1])
                         | (inv_s[1:] != inv_s[:-1]))
    order_new = part_new | _boundary(True, ou_s[1:] != ou_s[:-1])
    ones = jnp.ones((n,), jnp.int32)
    rn = _segmented_scan(ones, part_new, jnp.add)            # 1-based

    results = []
    for name, s in specs.items():
        kind = s[0]
        if kind in ("row_number", "cum_count"):
            r = rn
        elif kind == "rank":
            # forward-fill row_number from the start of each tie run
            r = _segmented_scan(rn, order_new, lambda a, b: a)
        elif kind == "dense_rank":
            r = _segmented_scan(order_new.astype(jnp.int32), part_new,
                                jnp.add)
        elif kind == "cum_sum":
            r = _segmented_scan(cols_s[s[1]], part_new, jnp.add)
        elif kind == "cum_min":
            r = _segmented_scan(cols_s[s[1]], part_new, jnp.minimum)
        elif kind == "cum_max":
            r = _segmented_scan(cols_s[s[1]], part_new, jnp.maximum)
        elif kind == "first_value":
            r = _segmented_scan(cols_s[s[1]], part_new, lambda a, b: a)
        else:  # lag / lead
            _, col, k, fill = s
            v = cols_s[col]
            if kind == "lag":
                shifted = _shift_right(v, k, fill)
                in_seg = rn > k
            else:
                shifted = _shift_left(v, k, fill)
                # row i+k is in the same partition iff no boundary opened
                # in (i, i+k]: compare partition run ids k apart.
                run_id = jnp.cumsum(part_new.astype(jnp.int32), axis=0)
                in_seg = _shift_left(run_id, k, -1) == run_id
            r = jnp.where(in_seg, shifted, jnp.asarray(fill, v.dtype))
        results.append(r)

    # back to input order: perm is a permutation, so an unstable sort keyed
    # on it is exact — no scatter.
    unsorted = jax.lax.sort((perm,) + tuple(results), num_keys=1,
                            is_stable=False)[1:]
    return dict(zip(specs.keys(), unsorted))


def _empty_output(spec, columns):
    if len(spec) > 1:
        return jnp.zeros((0,), columns[spec[1]].dtype)
    return jnp.zeros((0,), jnp.int32)


def table_window(table: Table, partition: str, order: str,
                 specs: Mapping[str, tuple],
                 config: SortConfig = DEFAULT_CONFIG) -> Table:
    """:func:`window` over a :class:`Table`: appends one column per spec.

    Padding rows (beyond ``num_rows``) are isolated into their own trailing
    partition via the validity mask, so tail garbage equal to a live
    partition key cannot inflate ranks of real rows.
    """
    specs_n = {name: _normalize_spec(name, s) for name, s in specs.items()}
    needed = {s[1] for s in specs_n.values() if len(s) > 1}
    cols = {c: table[c] for c in needed}
    out = window(table[partition], table[order], specs_n, cols,
                 valid=table.valid_mask(), config=config)
    return table.with_columns(**out)
