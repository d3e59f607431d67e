"""Window functions + segmented sort vs pure-Python oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radix_sort import dtypes
from radix_sort.ops import window as win
from radix_sort.query import Query
from radix_sort.status import EngineError
from radix_sort.table import Table


# ---------------------------------------------------------------------------
# oracles (plain Python, no numpy vectorization tricks to get wrong)
# ---------------------------------------------------------------------------

def _partitions(part):
    groups = {}
    for i, p in enumerate(part):
        groups.setdefault(p, []).append(i)
    return groups


def _ordered(part, order):
    """Per partition: row indices sorted by (order value, input position)."""
    return {p: sorted(idx, key=lambda i: (order[i], i))
            for p, idx in _partitions(part).items()}


def oracle_row_number(part, order):
    out = [0] * len(part)
    for rows in _ordered(part, order).values():
        for j, i in enumerate(rows):
            out[i] = j + 1
    return out


def oracle_rank(part, order, dense=False):
    out = [0] * len(part)
    for rows in _ordered(part, order).values():
        r = 0
        for j, i in enumerate(rows):
            if j == 0 or order[i] != order[rows[j - 1]]:
                r = j + 1 if not dense else r + 1
            out[i] = r
    return out


def oracle_cum(part, order, vals, op):
    out = [0] * len(part)
    for rows in _ordered(part, order).values():
        acc = None
        for i in rows:
            acc = vals[i] if acc is None else op(acc, vals[i])
            out[i] = acc
    return out


def oracle_shift(part, order, vals, k, fill, lead=False):
    out = [0] * len(part)
    for rows in _ordered(part, order).values():
        for j, i in enumerate(rows):
            src = j + k if lead else j - k
            out[i] = vals[rows[src]] if 0 <= src < len(rows) else fill
    return out


def _data(n=257, nparts=7, seed=0, dtype=np.int32):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, nparts, n).astype(dtype)
    order = rng.integers(0, 13, n).astype(np.int32)  # heavy ties
    vals = rng.integers(-50, 50, n).astype(np.int32)
    return part, order, vals


# ---------------------------------------------------------------------------
# window() array-level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pdtype", [np.int32, np.uint32, np.float32])
def test_row_number_rank_dense(pdtype):
    part, order, _ = _data(dtype=np.int32)
    part = part.astype(pdtype)
    out = win.window(jnp.asarray(part), jnp.asarray(order),
                     {"rn": ("row_number",), "rk": ("rank",),
                      "dr": ("dense_rank",), "cc": ("cum_count",)})
    np.testing.assert_array_equal(out["rn"], oracle_row_number(part, order))
    np.testing.assert_array_equal(out["cc"], oracle_row_number(part, order))
    np.testing.assert_array_equal(out["rk"], oracle_rank(part, order))
    np.testing.assert_array_equal(out["dr"],
                                  oracle_rank(part, order, dense=True))


def test_cumulative_aggregates():
    part, order, vals = _data(seed=3)
    out = win.window(jnp.asarray(part), jnp.asarray(order),
                     {"s": ("cum_sum", "v"), "mn": ("cum_min", "v"),
                      "mx": ("cum_max", "v"), "fv": ("first_value", "v")},
                     columns={"v": jnp.asarray(vals)})
    np.testing.assert_array_equal(
        out["s"], oracle_cum(part, order, vals, lambda a, b: a + b))
    np.testing.assert_array_equal(out["mn"], oracle_cum(part, order, vals, min))
    np.testing.assert_array_equal(out["mx"], oracle_cum(part, order, vals, max))
    first = oracle_cum(part, order, vals, lambda a, b: a)
    np.testing.assert_array_equal(out["fv"], first)


@pytest.mark.parametrize("k", [1, 2, 5, 400])
def test_lag_lead(k):
    part, order, vals = _data(seed=4)
    out = win.window(jnp.asarray(part), jnp.asarray(order),
                     {"lg": ("lag", "v", k, -999),
                      "ld": ("lead", "v", k, -999)},
                     columns={"v": jnp.asarray(vals)})
    np.testing.assert_array_equal(
        out["lg"], oracle_shift(part, order, vals, k, -999))
    np.testing.assert_array_equal(
        out["ld"], oracle_shift(part, order, vals, k, -999, lead=True))


def test_tie_heavy_single_partition():
    n = 200
    part = np.zeros(n, np.int32)
    order = np.zeros(n, np.int32)  # all tied
    out = win.window(jnp.asarray(part), jnp.asarray(order),
                     {"rn": ("row_number",), "rk": ("rank",),
                      "dr": ("dense_rank",)})
    np.testing.assert_array_equal(out["rn"], np.arange(1, n + 1))
    np.testing.assert_array_equal(out["rk"], np.ones(n))
    np.testing.assert_array_equal(out["dr"], np.ones(n))


def test_window_is_jit_safe():
    part, order, vals = _data(seed=5)

    @jax.jit
    def f(p, o, v):
        return win.window(p, o, {"rn": ("row_number",),
                                 "s": ("cum_sum", "v")},
                          columns={"v": v})

    out = f(jnp.asarray(part), jnp.asarray(order), jnp.asarray(vals))
    np.testing.assert_array_equal(out["rn"], oracle_row_number(part, order))


def test_window_empty():
    z = jnp.zeros((0,), jnp.int32)
    out = win.window(z, z, {"rn": ("row_number",), "s": ("cum_sum", "v")},
                     columns={"v": z})
    assert out["rn"].shape == (0,)
    assert out["s"].shape == (0,)


def test_window_spec_errors():
    p = jnp.zeros((4,), jnp.int32)
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("row_number", "extra")})
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("nope",)})
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("lag", "v", 0)}, columns={"v": p})
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("cum_sum", "missing")})


# ---------------------------------------------------------------------------
# Table / Query level: padding isolation
# ---------------------------------------------------------------------------

def test_table_window_padding_isolated():
    # tail garbage shares partition value 1 AND sorts before real rows'
    # order values — it must not perturb any valid row's rank.
    part = np.array([1, 2, 1, 2, 1, 1, 1, 1], np.int32)
    order = np.array([5, 1, 3, 2, 4, 0, 0, 0], np.int32)
    vals = np.arange(8, dtype=np.int32)
    t = Table({"p": jnp.asarray(part), "o": jnp.asarray(order),
               "v": jnp.asarray(vals)}, num_rows=5)
    out = win.table_window(t, "p", "o",
                           {"rn": ("row_number",), "s": ("cum_sum", "v")})
    pv, ov = part[:5], order[:5]
    np.testing.assert_array_equal(np.asarray(out["rn"])[:5],
                                  oracle_row_number(pv, ov))
    np.testing.assert_array_equal(
        np.asarray(out["s"])[:5],
        oracle_cum(pv, ov, vals[:5], lambda a, b: a + b))
    assert out.num_rows == 5


def test_query_window_chain():
    part, order, vals = _data(n=100, seed=7)
    t = Table({"p": jnp.asarray(part), "o": jnp.asarray(order),
               "v": jnp.asarray(vals)}, num_rows=100)
    res = (Query(t)
           .window("p", "o", rn=("row_number",), s=("cum_sum", "v"))
           .filter("rn", "le", 2)
           .collect())
    rn_all = np.array(oracle_row_number(part, order))
    expect = int((rn_all <= 2).sum())
    assert int(res.num_rows) == expect


# ---------------------------------------------------------------------------
# segmented sort
# ---------------------------------------------------------------------------

def test_segmented_sort_matches_per_segment_numpy():
    rng = np.random.default_rng(11)
    bounds = np.sort(rng.choice(np.arange(1, 500), 9, replace=False))
    seg_ids = np.searchsorted(bounds, np.arange(500), side="right")
    keys = rng.integers(-1000, 1000, 500).astype(np.int32)
    out = win.segmented_sort(jnp.asarray(seg_ids.astype(np.int32)),
                             jnp.asarray(keys))
    expect = keys.copy()
    for s in np.unique(seg_ids):
        m = seg_ids == s
        expect[m] = np.sort(keys[m])
    np.testing.assert_array_equal(out, expect)


def test_segmented_sort_kv_stable():
    seg = np.repeat(np.arange(4, dtype=np.int32), 16)
    keys = np.tile(np.array([3, 1, 3, 1], np.int32), 16)
    payload = np.arange(64, dtype=np.int32)
    ks, vs = win.segmented_sort_kv(jnp.asarray(seg), jnp.asarray(keys),
                                   jnp.asarray(payload))
    for s in range(4):
        m = seg == s
        idx = np.asarray(vs)[m]
        kk = keys[idx]
        assert (np.diff(kk) >= 0).all()
        for key in (1, 3):
            tied = idx[kk == key]
            assert (np.diff(tied) > 0).all(), "stability violated"
    np.testing.assert_array_equal(np.asarray(ks), keys[np.asarray(vs)])


def test_segmented_sort_float_keys():
    seg = np.repeat(np.arange(2, dtype=np.int32), 8)
    keys = np.array([1.5, -np.inf, np.inf, -0.0, 0.0, 2.0, -3.5, 1.5,
                     9.0, -9.0, 0.5, 0.25, -0.25, 7.0, -7.0, 3.0],
                    np.float32)
    out = np.asarray(win.segmented_sort(jnp.asarray(seg), jnp.asarray(keys)))
    for s in range(2):
        m = seg == s
        np.testing.assert_array_equal(out[m], np.sort(keys[m]))


def test_segmented_sort_length_mismatch():
    with pytest.raises(EngineError):
        win.segmented_sort(jnp.zeros((3,), jnp.int32),
                           jnp.zeros((4,), jnp.int32))
