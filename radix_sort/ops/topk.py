"""Ordered selection: top-k (ORDER BY ... LIMIT k) over keys and tables.

The reference's public surface stops at the full sort; a query-execution
engine also needs the ordered-selection family.  Design:

  - small k rides ``jax.lax.top_k`` — XLA's native selection network (no
    scatter, ties resolved toward lower indices, i.e. *stable* selection);
  - large k (> capacity/4) falls back to the engine's sort + a static
    slice, which is cheaper than selecting most of the array and keeps the
    payload gather to k rows.

All key dtypes route through the order-preserving unsigned transform
(``dtypes.to_sortable_unsigned``) like every other operator, so i32/u64/f32
... share one ordering semantics.  Reference parity anchor: the reference
exposes only full sorts (src/RadixSortGPU.h:36-124); this module is part of
the operator-set extension mandated by BASELINE.json.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes
from ..config import SortConfig, DEFAULT_CONFIG
from ..status import EngineError, OperationStatus
from ..table import Table
from . import sort as sort_ops


def _scores(keys_u: jnp.ndarray, largest: bool) -> jnp.ndarray:
    """Unsigned image where 'better' is numerically larger."""
    return keys_u if largest else ~keys_u


def _check_k(k: int, n: int):
    if not isinstance(k, (int, np.integer)) or k < 0:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"k must be a non-negative static int, got {k!r}")
    if k > n:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"k={k} exceeds capacity {n}")


def _top_k_impl(keys_u, payloads, k: int, largest: bool,
                config: SortConfig):
    """Core: biased unsigned keys + payload tuple -> (keys_u[k], payloads[k]).

    Output order: best-first (descending key for largest, ascending for
    smallest); ties broken by original position (stable) on both paths.
    """
    n = keys_u.shape[0]
    _check_k(k, n)
    if k == 0:
        return keys_u[:0], tuple(p[:0] for p in payloads)
    if k <= max(1, n // 4):
        score = _scores(keys_u, largest)
        # lax.top_k: ties resolved in favor of lower indices -> the
        # selection (and its payload gather) is stable.
        _, idx = jax.lax.top_k(score, k)
        return (jnp.take(keys_u, idx, axis=0),
                tuple(jnp.take(p, idx, axis=0) for p in payloads))
    # Large k: full engine sort + static slice.  Sorting the COMPLEMENT of
    # the score ascends best-first with ties in original order (reversing an
    # ascending stable sort would reverse tie order instead).
    inv_sorted, pls = sort_ops.sort_biased_kv(~_scores(keys_u, largest),
                                              tuple(payloads), config=config)
    score_sorted = ~inv_sorted[:k]
    return (score_sorted if largest else ~score_sorted,
            tuple(p[:k] for p in pls))


def top_k(keys: jnp.ndarray, k: int, *, largest: bool = True,
          config: SortConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """The k largest (or smallest) keys, best-first, stable on ties."""
    ku = dtypes.to_sortable_unsigned(keys)
    out, _ = _top_k_impl(ku, (), k, largest, config)
    return dtypes.from_sortable_unsigned(out, np.dtype(keys.dtype))


def top_k_kv(keys: jnp.ndarray, values, k: int, *, largest: bool = True,
             config: SortConfig = DEFAULT_CONFIG):
    """Top-k with a payload pytree; every leaf rides the same selection."""
    leaves, treedef = jax.tree.flatten(values)
    for leaf in leaves:
        if leaf.shape[0] != keys.shape[0]:
            raise EngineError(
                OperationStatus.HOST_BUFFERS_FAILED,
                f"value leaf length {leaf.shape[0]} != keys {keys.shape[0]}")
    ku = dtypes.to_sortable_unsigned(keys)
    out, out_leaves = _top_k_impl(ku, tuple(leaves), k, largest, config)
    return (dtypes.from_sortable_unsigned(out, np.dtype(keys.dtype)),
            jax.tree.unflatten(treedef, out_leaves))


def topk_table(table: Table, key: str, k: int, *, largest: bool = True,
               config: SortConfig = DEFAULT_CONFIG) -> Table:
    """Table-level ORDER BY key (DESC if largest) LIMIT k.

    Padding rows always lose: their score is forced to the minimum, and
    because valid rows form a prefix (table.py invariant) the stable tie
    break keeps real minimum-scored rows ahead of padding.  Output capacity
    is k (static); ``num_rows`` = min(k, input rows).
    """
    _check_k(k, table.capacity)
    ku = dtypes.to_sortable_unsigned(table[key])
    score = _scores(ku, largest)
    score = jnp.where(table.valid_mask(), score,
                      jnp.zeros((), dtype=score.dtype))
    names = table.column_names
    payloads = tuple(table.columns[nm] for nm in names)
    # Selection runs on the score image; original columns (including the
    # key, in its original dtype) ride as payload.
    _, out = _top_k_impl(score, payloads, k, True, config)
    return Table(dict(zip(names, out)),
                 num_rows=jnp.minimum(table.num_rows, k))
