"""Radix-partitioned hash join (build + probe) — BASELINE.json config 4.

Design.  A classical hash join does random-access probes into a hash table;
here the probe is re-designed around the engine's own sort machinery
(SURVEY.md §7 M3):

  build:  radix-sort the build side by key (our LSD sort — this *is* the
          radix partitioning, taken to its fixed point).
  probe:  for every probe row, binary-search the sorted build keys with a
          vectorized, sort-friendly ``searchsorted``; runs of duplicate build
          keys are expanded per match.
  emit:   matched pairs are compacted (same scan+scatter primitive as
          filter) into a static-capacity output table.

``radix_partition`` (ops/partition.py) is exposed separately and used by the
distributed join to split both tables by key digit across chips before this
single-chip kernel runs per partition (parallel/dist_ops.py).

Output sizing: inner-join output is data-dependent; capacity must be given
statically (``out_capacity``, default = probe capacity x ``expand``).  If the
true match count exceeds capacity the result reports ``overflow`` = True and
truncates — the same static-shape discipline the distributed shuffle uses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes
from ..config import SortConfig, DEFAULT_CONFIG
from ..table import Table
from . import sort as sort_ops


def _biased_with_sentinel(table: Table, key: str):
    u = dtypes.to_sortable_unsigned(table[key])
    sent = dtypes._np_scalar(np.dtype(u.dtype),
                             dtypes.sentinel_max_unsigned(u.dtype))
    return jnp.where(table.valid_mask(), u, sent)


def _merge_scan_join(probe: Table, build: Table, key: str,
                     out_capacity: int, suffixes, max_duplicates: int = 1):
    """Gather/scatter-free inner join (docs/DESIGN.md §2), any duplicate
    fanout:

      1. ONE stable multi-key sort of build+probe rows by (key, side) with
         every column as payload (build rows first among equal keys).
      2. for j in [0, max_duplicates): a segmented forward scan seeds the
         j-th build row of each key run and propagates its payload to the
         run's probe rows (lax.associative_scan — no gathers).
      3. the (n × D) candidate grid flattens position-major (probe order
         preserved, duplicates adjacent) and matched rows compact to the
         front with one more stable sort.

    Padding rows on either side never match (sentinel keys + validity).
    A key run with more than max_duplicates build rows raises the
    overflow flag (detected via the j==D seed — no extra pass).
    """
    D = max_duplicates
    P, B = probe.capacity, build.capacity
    n = P + B
    pu = _biased_with_sentinel(probe, key)
    bu = _biased_with_sentinel(build, key)
    keys_all = jnp.concatenate([bu, pu])
    # side: build=0 sorts before probe=1 within a key run.
    side = jnp.concatenate([jnp.zeros((B,), jnp.int32),
                            jnp.ones((P,), jnp.int32)])
    build_valid = jnp.concatenate([build.valid_mask(),
                                   jnp.zeros((P,), bool)])
    probe_valid = jnp.concatenate([jnp.zeros((B,), bool),
                                   probe.valid_mask()])

    operands = [keys_all, side, build_valid, probe_valid]
    b_names = build.column_names
    p_names = probe.column_names
    for nme in b_names:
        operands.append(jnp.concatenate(
            [build.columns[nme],
             jnp.zeros((P,), build.columns[nme].dtype)]))
    for nme in p_names:
        operands.append(jnp.concatenate(
            [jnp.zeros((B,), probe.columns[nme].dtype),
             probe.columns[nme]]))
    out = jax.lax.sort(tuple(operands), num_keys=2, is_stable=True)
    k_s, side_s, bval_s, pval_s = out[0], out[1], out[2], out[3]
    b_cols_s = dict(zip(b_names, out[4:4 + len(b_names)]))
    p_cols_s = dict(zip(p_names, out[4 + len(b_names):]))

    # run starts: first row of each distinct key.
    is_start = jnp.concatenate([jnp.ones((1,), bool), k_s[1:] != k_s[:-1]])
    is_build = jnp.logical_and(side_s == 0, bval_s)

    # in-run build index (exclusive) via one segmented sum.
    def seg_sum(a, b):
        ra, ca = a
        rb, cb = b
        return jnp.logical_or(ra, rb), jnp.where(rb, cb, ca + cb)

    _, bcnt_incl = jax.lax.associative_scan(
        seg_sum, (is_start, is_build.astype(jnp.int32)))
    bidx = bcnt_incl - is_build.astype(jnp.int32)

    def run_ffill(seed_mask, payloads):
        """Propagate the (unique-per-run) seeded row's payloads forward
        within each key run; returns (has, propagated...)."""
        def combine(a, b):
            reset_a, has_a = a[0], a[1]
            reset_b, has_b = b[0], b[1]
            out_reset = jnp.logical_or(reset_a, reset_b)
            out_has = jnp.where(reset_b, has_b,
                                jnp.logical_or(has_a, has_b))
            take_b = jnp.logical_or(reset_b, has_b)
            merged = [out_reset, out_has]
            for va, vb in zip(a[2:], b[2:]):
                merged.append(jnp.where(take_b, vb, va))
            return tuple(merged)

        res = jax.lax.associative_scan(
            combine, (is_start, seed_mask) + tuple(payloads))
        return res[1], res[2:]

    is_probe_row = jnp.logical_and(side_s == 1, pval_s)
    b_payloads = tuple(b_cols_s[nme] for nme in b_names)
    matched_cols = []          # per j: (matched, propagated build cols)
    for j in range(D):
        seed_j = jnp.logical_and(is_build, bidx == j)
        has_j, prop_j = run_ffill(seed_j, b_payloads)
        matched_cols.append((jnp.logical_and(is_probe_row, has_j),
                             prop_j))
    # run exceeded the duplicate cap: a (D)-th build exists and the run
    # has matched probe rows.
    has_over, _ = run_ffill(jnp.logical_and(is_build, bidx == D), ())
    dup_overflow = jnp.any(jnp.logical_and(is_probe_row, has_over)) \
        if D < B else jnp.zeros((), bool)

    # ---- emit: (n, D) candidates position-major, compact to the front.
    def stack(per_j):                                     # D × (n,) → (n*D,)
        return jnp.stack(per_j, axis=1).reshape(-1)

    matched = stack([m for m, _ in matched_cols])
    names_out = []
    vals_out = []
    for nme in p_names:
        names_out.append(nme + suffixes[0])
        vals_out.append(stack([p_cols_s[nme]] * D))
    for i, nme in enumerate(b_names):
        oname = nme + suffixes[1] if (nme + suffixes[0]) in names_out \
            else nme
        names_out.append(oname)
        vals_out.append(stack([mc[1][i] for mc in matched_cols]))

    n_match = jnp.sum(matched.astype(jnp.int32))
    # binary compaction of the matched candidates
    from . import partition as part_ops

    packed, _ = part_ops.compact_mask(matched, tuple(vals_out),
                                      method="auto")
    n_out = jnp.minimum(n_match, out_capacity)
    out_cols = {nm: v[:out_capacity] for nm, v in zip(names_out, packed)}
    stats = {"match_count": n_match,
             "overflow": jnp.logical_or(n_match > out_capacity,
                                        dup_overflow)}
    return Table(out_cols, num_rows=n_out), stats


def hash_join(probe: Table, build: Table, key: str,
              out_capacity: int | None = None,
              max_duplicates: int = 1,
              suffixes=("", "_r"),
              config: SortConfig = DEFAULT_CONFIG):
    """Inner join ``probe`` ⋈ ``build`` on column ``key``.

    ``max_duplicates`` bounds how many build rows may share one key (the
    per-key fanout); output capacity defaults to
    ``probe.capacity * max_duplicates``.  Every fanout now runs the
    gather-free merge-scan path.

    Returns ``(table, stats)`` where stats carries jit-safe device scalars
    ``match_count`` and ``overflow`` (true match count exceeded capacity or
    a key's duplicate run exceeded max_duplicates).
    """
    if out_capacity is None:
        out_capacity = probe.capacity * max_duplicates

    pk, bk = probe[key], build[key]
    if pk.dtype != bk.dtype:
        raise ValueError(f"join key dtypes differ: {pk.dtype} vs {bk.dtype}")

    return _merge_scan_join(probe, build, key, out_capacity, suffixes,
                            max_duplicates=max_duplicates)
