"""Query layer + columnar persistence."""

import numpy as np
import jax.numpy as jnp
import pytest

from radix_sort import io as rio
from radix_sort.query import Query
from radix_sort.table import Table


def _t():
    rng = np.random.default_rng(0)
    return Table.from_numpy({
        "k": rng.integers(0, 50, 1000).astype(np.uint32),
        "x": rng.integers(0, 10, 1000).astype(np.int32),
    })


def test_query_filter_groupby_sort():
    t = _t()
    out = (Query(t)
           .filter("k", "lt", 25)
           .group_by("k", n=("count", None), s=("sum", "x"))
           .sort_by("k")
           .collect())
    res = out.to_numpy()
    keys = np.asarray(t["k"])
    xs = np.asarray(t["x"])
    mask = keys < 25
    uk = np.unique(keys[mask])
    assert np.array_equal(res["k"], uk)
    exp_n = np.array([(keys[mask] == g).sum() for g in uk])
    exp_s = np.array([xs[mask][keys[mask] == g].sum() for g in uk])
    assert np.array_equal(res["n"], exp_n)
    assert np.array_equal(res["s"], exp_s)


def test_query_join_and_with_column():
    t = _t()
    build = Table.from_numpy({"k": np.arange(50, dtype=np.uint32),
                              "lbl": np.arange(50, dtype=np.int32) * 2})
    q = (Query(t)
         .with_column("x2", lambda tbl: tbl["x"] * 2)
         .join(build, on="k"))
    out = q.collect()
    res = out.to_numpy()
    assert np.array_equal(res["x2"], res["x"] * 2)
    assert np.array_equal(res["lbl"], res["k"].astype(np.int32) * 2)
    assert "join" in q.last_stats


def test_query_select_and_filter_mask():
    t = _t()
    out = (Query(t)
           .filter_mask(lambda tbl: (tbl["x"] % 2) == 0)
           .select(["x"])
           .collect())
    res = out.to_numpy()
    assert np.all(res["x"] % 2 == 0)
    xs = np.asarray(t["x"])
    assert res["x"].size == int((xs % 2 == 0).sum())


def test_sort_by_keeps_padding_at_tail():
    t = Table({"k": jnp.asarray(np.array([5, 1, 9, 77], np.uint32)),
               "v": jnp.asarray(np.array([50, 10, 90, 770], np.int32))},
              num_rows=3)
    out = Query(t).sort_by("k").collect()
    res = out.to_numpy()
    assert np.array_equal(res["k"], [1, 5, 9])
    assert np.array_equal(res["v"], [10, 50, 90])


def test_save_load_roundtrip(tmp_path):
    t = Table({"k": jnp.asarray(np.array([3, 1, 2, 9], np.uint32)),
               "v": jnp.asarray(np.array([1., 2., 3., 4.], np.float32))},
              num_rows=3)
    path = rio.save_table(t, str(tmp_path / "t"))
    back = rio.load_table(path)
    assert int(back.num_rows) == 3
    assert np.array_equal(np.asarray(back["k"]), np.asarray(t["k"]))
    assert back.capacity == 4


def test_batch_writer_iter(tmp_path):
    w = rio.BatchWriter(str(tmp_path / "runs"))
    for i in range(3):
        w.write(Table({"a": jnp.arange(4, dtype=jnp.int32) + i}))
    w.finish()
    batches = list(rio.iter_batches(str(tmp_path / "runs")))
    assert len(batches) == 3
    assert np.array_equal(np.asarray(batches[2]["a"]), [2, 3, 4, 5])


def test_multi_key_sort():
    t = Table.from_numpy({
        "a": np.array([2, 1, 2, 1, 2], np.uint32),
        "b": np.array([9, 5, 1, 7, 1], np.int32),
        "v": np.arange(5, dtype=np.int32),
    })
    out = Query(t).sort_by("a", "b").collect().to_numpy()
    order = np.lexsort((np.asarray(t["b"]), np.asarray(t["a"])))
    assert np.array_equal(out["a"], np.asarray(t["a"])[order])
    assert np.array_equal(out["b"], np.asarray(t["b"])[order])
    assert np.array_equal(out["v"], order)


def test_query_sort_by_descending():
    import numpy as np
    import jax.numpy as jnp
    from radix_sort import Query, Table

    rng = np.random.default_rng(31)
    g = rng.integers(0, 5, 64).astype(np.int32)
    x = rng.integers(-100, 100, 64).astype(np.int32)
    t = Table({"g": jnp.asarray(g), "x": jnp.asarray(x)}, num_rows=50)
    out = (Query(t).sort_by("g", "x", descending=[True, False])
           .collect().to_numpy())
    order = np.lexsort((x[:50], -g[:50]))  # g desc, x asc, stable
    np.testing.assert_array_equal(out["g"], g[:50][order])
    np.testing.assert_array_equal(out["x"], x[:50][order])
    # bool shorthand applies to every key
    out2 = Query(t).sort_by("x", descending=True).collect().to_numpy()
    ord2 = np.argsort(-x[:50].astype(np.int64), kind="stable")
    np.testing.assert_array_equal(out2["x"], x[:50][ord2])
