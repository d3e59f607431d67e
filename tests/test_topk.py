"""Ordered-selection operators: top_k / top_k_kv / topk_table / distinct /
Table.head / Query.limit.

Oracles are numpy: a stable argsort on the biased-unsigned image defines
both the selected set AND the tie order, so the tests pin the stability
contract (ties resolved toward earlier rows) on both the lax.top_k path
(small k) and the sort path (large k).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from radix_sort import Query, Table, dtypes, top_k, top_k_kv
from radix_sort.ops import aggregate as agg_ops
from radix_sort.ops import topk as topk_ops
from radix_sort.status import EngineError


def _oracle_topk_idx(keys: np.ndarray, k: int, largest: bool) -> np.ndarray:
    ku = np.asarray(dtypes.to_sortable_unsigned(jnp.asarray(keys)))
    order = np.argsort(ku if not largest else ~ku, kind="stable")
    return order[:k]


@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("k", [0, 1, 7, 100, 900])  # 900 > n//4: sort path
def test_top_k_matches_oracle(key_dtype, k, largest):
    rng = np.random.default_rng(3)
    n = 1000
    if np.dtype(key_dtype).kind == "u":
        keys = rng.integers(0, 50, n).astype(key_dtype)  # heavy ties
    else:
        keys = rng.integers(-25, 25, n).astype(key_dtype)
    idx = _oracle_topk_idx(keys, k, largest)
    out = top_k(jnp.asarray(keys), k, largest=largest)
    np.testing.assert_array_equal(np.asarray(out), keys[idx])


@pytest.mark.parametrize("k", [5, 600])  # both dispatch paths
def test_top_k_kv_stable_ties(k):
    rng = np.random.default_rng(7)
    n = 1000
    keys = rng.integers(0, 8, n).astype(np.uint32)  # massive ties
    payload = np.arange(n, dtype=np.int32)
    idx = _oracle_topk_idx(keys, k, largest=True)
    ko, po = top_k_kv(jnp.asarray(keys), jnp.asarray(payload), k)
    np.testing.assert_array_equal(np.asarray(ko), keys[idx])
    # ties must resolve toward earlier rows on BOTH paths
    np.testing.assert_array_equal(np.asarray(po), payload[idx])


def test_top_k_float_total_order():
    keys = np.array([1.5, -np.inf, np.inf, -0.0, 0.0, 2.5, -3.25],
                    np.float32)
    out = top_k(jnp.asarray(keys), 3, largest=True)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.array([np.inf, 2.5, 1.5], np.float32))
    out = top_k(jnp.asarray(keys), 3, largest=False)
    np.testing.assert_array_equal(
        np.asarray(out), np.array([-np.inf, -3.25, -0.0], np.float32))


def test_top_k_pytree_payload_and_errors():
    keys = jnp.asarray(np.array([3, 1, 2], np.uint32))
    vals = {"a": jnp.arange(3, dtype=jnp.int32),
            "b": jnp.asarray(np.array([0.5, 1.5, 2.5], np.float32))}
    ko, vo = top_k_kv(keys, vals, 2)
    np.testing.assert_array_equal(np.asarray(ko), [3, 2])
    np.testing.assert_array_equal(np.asarray(vo["a"]), [0, 2])
    np.testing.assert_array_equal(np.asarray(vo["b"]), [0.5, 2.5])
    with pytest.raises(EngineError):
        top_k(keys, 4)  # k > capacity
    with pytest.raises(EngineError):
        top_k_kv(keys, jnp.arange(2, dtype=jnp.int32), 1)  # ragged payload


@pytest.mark.parametrize("k", [3, 80])
def test_topk_table_padding_loses(k):
    rng = np.random.default_rng(11)
    cap, nrows = 100, 60
    key = rng.integers(0, 10, cap).astype(np.int32)
    key[nrows:] = 127  # padding rows hold large garbage keys
    x = np.arange(cap, dtype=np.int32)
    t = Table({"k": jnp.asarray(key), "x": jnp.asarray(x)}, num_rows=nrows)
    out = topk_ops.topk_table(t, "k", k, largest=True)
    got = out.to_numpy()
    idx = _oracle_topk_idx(key[:nrows], min(k, nrows), largest=True)
    np.testing.assert_array_equal(got["k"], key[:nrows][idx])
    np.testing.assert_array_equal(got["x"], x[:nrows][idx])
    assert out.capacity == k


def test_topk_table_smallest_with_real_extreme_keys():
    # real rows that tie with the forced padding score must win
    cap, nrows = 8, 5
    key = np.array([7, 0, 3, 0, 5, 1, 1, 1], np.uint32)
    t = Table({"k": jnp.asarray(key),
               "r": jnp.arange(cap, dtype=jnp.int32)}, num_rows=nrows)
    out = topk_ops.topk_table(t, "k", 4, largest=False).to_numpy()
    np.testing.assert_array_equal(out["k"], [0, 0, 3, 5])
    np.testing.assert_array_equal(out["r"], [1, 3, 2, 4])


def test_distinct_first_occurrence(key_dtype):
    rng = np.random.default_rng(5)
    cap, nrows = 200, 150
    key = rng.integers(0, 20, cap).astype(key_dtype)
    row = np.arange(cap, dtype=np.int32)
    t = Table({"k": jnp.asarray(key), "row": jnp.asarray(row)},
              num_rows=nrows)
    out = agg_ops.distinct(t, "k").to_numpy()
    uniq, first_idx = np.unique(key[:nrows], return_index=True)
    np.testing.assert_array_equal(out["k"], uniq)
    np.testing.assert_array_equal(out["row"], row[first_idx])


def test_distinct_sentinel_key_rows_survive():
    # a real key equal to the padding sentinel must appear exactly once
    cap, nrows = 6, 4
    key = np.array([np.iinfo(np.uint32).max, 2,
                    np.iinfo(np.uint32).max, 2, 9, 9], np.uint32)
    t = Table({"k": jnp.asarray(key),
               "r": jnp.arange(cap, dtype=jnp.int32)}, num_rows=nrows)
    out = agg_ops.distinct(t, "k").to_numpy()
    np.testing.assert_array_equal(out["k"], [2, np.iinfo(np.uint32).max])
    np.testing.assert_array_equal(out["r"], [1, 0])


def test_head_and_query_limit():
    t = Table({"k": jnp.arange(10, dtype=jnp.int32)}, num_rows=7)
    h = t.head(4)
    assert h.capacity == 4
    np.testing.assert_array_equal(h.to_numpy()["k"], [0, 1, 2, 3])
    assert int(t.head(9).num_rows) == 7  # n > num_rows keeps num_rows
    with pytest.raises(EngineError):
        t.head(-1)
    out = Query(t).limit(3).collect().to_numpy()
    np.testing.assert_array_equal(out["k"], [0, 1, 2])


def test_query_chain_distinct_topk():
    rng = np.random.default_rng(13)
    n = 300
    k = rng.integers(0, 40, n).astype(np.int32)
    x = rng.integers(0, 100, n).astype(np.int32)
    t = Table({"k": jnp.asarray(k), "x": jnp.asarray(x)})
    out = (Query(t)
           .filter("x", "ge", 50)
           .distinct("k")
           .top_k("k", 5, largest=True)
           .collect().to_numpy())
    kept = k[x >= 50]
    uniq = np.unique(kept)
    np.testing.assert_array_equal(out["k"], uniq[::-1][:5])
