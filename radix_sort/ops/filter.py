"""Filter: predicate → stable compaction (BASELINE.json config 3).

Built on the same scan+scatter machinery as the sort (SURVEY.md §7 M3):
a filter is a stable partition into (kept, dropped) with the dropped tail
becoming padding.  Output capacity stays static (XLA-friendly); ``num_rows``
carries the dynamic kept count.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..table import Table
from . import partition


def filter_table(table: Table, mask: jnp.ndarray,
                 block_elems: int = 1 << 16) -> Table:
    """Keep rows where ``mask`` is True (padding rows are always dropped),
    preserving order."""
    mask = jnp.logical_and(mask, table.valid_mask())
    names = table.column_names
    arrays = tuple(table.columns[n] for n in names)
    out, kept = partition.compact_mask(mask, arrays, block_elems=block_elems,
                                       method="auto")
    return Table(dict(zip(names, out)), num_rows=kept)


def filter_expr(table: Table, column: str, op: str, value) -> Table:
    """Convenience comparison filter: op in {eq,ne,lt,le,gt,ge}."""
    col = table[column]
    fns = {
        "eq": jnp.equal, "ne": jnp.not_equal,
        "lt": jnp.less, "le": jnp.less_equal,
        "gt": jnp.greater, "ge": jnp.greater_equal,
    }
    if op not in fns:
        raise ValueError(f"unknown comparison {op!r}")
    return filter_table(table, fns[op](col, value))
