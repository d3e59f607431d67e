"""Fluent query layer over Table — the user-facing face of the execution
engine.

The reference's public surface is one sort call; a query-execution engine's
surface is composable operators.  ``Query`` chains lazily and executes on
``.collect()`` as one jit-able pipeline built from the engine's operators:

    q = (Query(table)
         .filter("k", "lt", 500)
         .group_by("k", n=("count", None), s=("sum", "x"))
         .join(other, on="k")
         .sort_by("k"))
    result = q.collect()          # Table

Every operator is sort-based (stable partition / sort-based
aggregate / sort-probe join), so a whole chain stays shape-static and
compiles to a single XLA program.
"""

from __future__ import annotations



from .config import SortConfig, DEFAULT_CONFIG
from .table import Table


class Query:
    def __init__(self, table: Table, config: SortConfig = DEFAULT_CONFIG):
        self._table = table
        self._config = config
        self._steps = []
        self._stats = {}

    # ---- operators (lazy) -------------------------------------------------
    def filter(self, column: str, op: str, value) -> "Query":
        self._steps.append(("filter", (column, op, value)))
        return self

    def filter_mask(self, fn) -> "Query":
        """fn: Table -> bool mask array."""
        self._steps.append(("filter_mask", (fn,)))
        return self

    def select(self, *columns) -> "Query":
        if len(columns) == 1 and not isinstance(columns[0], str):
            columns = tuple(columns[0])
        self._steps.append(("select", (columns,)))
        return self

    def with_column(self, name: str, fn) -> "Query":
        """fn: Table -> new column array."""
        self._steps.append(("with_column", (name, fn)))
        return self

    def group_by(self, key: str, **aggs) -> "Query":
        """aggs: out_name=(op, input_column)."""
        self._steps.append(("group_by", (key, dict(aggs))))
        return self

    def join(self, other: Table, on: str, max_duplicates: int = 1,
             suffixes=("", "_r")) -> "Query":
        self._steps.append(("join", (other, on, max_duplicates, suffixes)))
        return self

    def distinct(self, column: str) -> "Query":
        """One row per distinct value of ``column`` (first occurrence),
        ascending order."""
        self._steps.append(("distinct", (column,)))
        return self

    def top_k(self, column: str, k: int, largest: bool = True) -> "Query":
        """ORDER BY column (DESC if largest) LIMIT k."""
        self._steps.append(("top_k", (column, k, largest)))
        return self

    def limit(self, n: int) -> "Query":
        """Keep the first n rows of the current result."""
        self._steps.append(("limit", (n,)))
        return self

    def window(self, partition: str, order: str, **specs) -> "Query":
        """Append window-function columns over (PARTITION BY ``partition``,
        ORDER BY ``order``): ``out_name=("row_number",)``, ``("rank",)``,
        ``("dense_rank",)``, ``("cum_sum", col)``, ``("cum_min"|"cum_max"|
        "first_value", col)``, ``("lag"|"lead", col[, k[, fill]])``."""
        self._steps.append(("window", (partition, order, dict(specs))))
        return self

    def sort_by(self, *keys: str, descending=False) -> "Query":
        """Sort by one or more key columns (first = most significant).
        ``descending`` is a bool for all keys or a per-key sequence.
        Multi-key order is realized LSD-style: successive stable sorts from
        the least-significant key — the same composition the radix sort
        itself uses per digit."""
        if len(keys) == 1 and not isinstance(keys[0], str):
            keys = tuple(keys[0])
        if isinstance(descending, bool):
            desc = (descending,) * len(keys)
        else:
            desc = tuple(descending)
            if len(desc) != len(keys):
                raise ValueError(
                    f"descending has {len(desc)} entries for {len(keys)} keys")
        for k, d in reversed(tuple(zip(keys, desc))):
            self._steps.append(("sort_by", (k, d)))
        return self

    # ---- execution --------------------------------------------------------
    def collect(self) -> Table:
        from .ops import aggregate as agg_ops
        from .ops import filter as filt_ops
        from .ops import join as join_ops
        from .ops import sort as sort_ops

        t = self._table
        for step, args in self._steps:
            if step == "filter":
                col, op, value = args
                t = filt_ops.filter_expr(t, col, op, value)
            elif step == "filter_mask":
                (fn,) = args
                t = filt_ops.filter_table(t, fn(t))
            elif step == "select":
                (cols,) = args
                t = t.select(cols)
            elif step == "with_column":
                name, fn = args
                t = t.with_columns(**{name: fn(t)})
            elif step == "group_by":
                key, aggs = args
                t = agg_ops.hash_aggregate(t, key, aggs,
                                           config=self._config)
            elif step == "distinct":
                (col,) = args
                t = agg_ops.distinct(t, col, config=self._config)
            elif step == "top_k":
                from .ops import topk as topk_ops
                col, k, largest = args
                t = topk_ops.topk_table(t, col, k, largest=largest,
                                        config=self._config)
            elif step == "limit":
                (n,) = args
                t = t.head(n)
            elif step == "join":
                other, on, max_dup, suffixes = args
                t, stats = join_ops.hash_join(
                    t, other, on, max_duplicates=max_dup,
                    suffixes=suffixes, config=self._config)
                self._stats["join"] = stats
            elif step == "window":
                from .ops import window as win_ops
                partition, order, specs = args
                t = win_ops.table_window(t, partition, order, specs,
                                         config=self._config)
            elif step == "sort_by":
                key, desc = args
                names = t.column_names
                payload = {n: t.columns[n] for n in names if n != key}
                # padding rows must stay at the tail: sort by biased key
                # with sentinel for invalid rows
                import jax.numpy as jnp
                import numpy as np

                from . import dtypes

                ku = dtypes.to_sortable_unsigned(t[key])
                if desc:
                    ku = ~ku  # order-reversing on the unsigned image
                sent = dtypes._np_scalar(
                    np.dtype(ku.dtype),
                    dtypes.sentinel_max_unsigned(ku.dtype))
                ku = jnp.where(t.valid_mask(), ku, sent)
                payload["__orig_key__"] = t[key]
                ks, pv = sort_ops.sort_kv(ku, payload, config=self._config)
                orig = pv.pop("__orig_key__")
                t = Table({key: orig, **pv}, num_rows=t.num_rows)
            else:  # pragma: no cover
                raise ValueError(step)
        return t

    @property
    def last_stats(self):
        return dict(self._stats)
