"""Table abstraction: pytree behavior, padding semantics, validation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radix_sort import EngineError
from radix_sort.table import Table


def _t():
    return Table.from_numpy({
        "k": np.array([3, 1, 2, 9], np.uint32),
        "v": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
    })


def test_basic_accessors():
    t = _t()
    assert t.capacity == 4
    assert t.column_names == ("k", "v")
    assert int(t.num_rows) == 4
    assert np.array_equal(t.to_numpy()["k"], [3, 1, 2, 9])


def test_num_rows_padding():
    t = Table({"k": jnp.arange(6, dtype=jnp.uint32)}, num_rows=4)
    assert np.array_equal(np.asarray(t.valid_mask()),
                          [True] * 4 + [False] * 2)
    assert t.to_numpy()["k"].shape == (4,)


def test_ragged_rejected():
    with pytest.raises(EngineError):
        Table({"a": jnp.zeros(3), "b": jnp.zeros(4)})


def test_2d_rejected():
    with pytest.raises(EngineError):
        Table({"a": jnp.zeros((3, 3))})


def test_empty_columns_rejected():
    with pytest.raises(EngineError):
        Table({})


def test_pytree_roundtrip_through_jit():
    t = _t()

    @jax.jit
    def f(tbl):
        return tbl.with_columns(k=tbl["k"] + 1)

    out = f(t)
    assert isinstance(out, Table)
    assert np.array_equal(out.to_numpy()["k"], [4, 2, 3, 10])
    assert out.capacity == 4


def test_select_and_with_columns():
    t = _t()
    s = t.select(["k"])
    assert s.column_names == ("k",)
    w = t.with_columns(z=jnp.ones(4, jnp.int32))
    assert "z" in w.column_names
