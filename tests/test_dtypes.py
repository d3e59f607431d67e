"""Order-preserving bit transforms — the OFFSET-bias equivalence
(src/RadixSortGPU.cpp:436) plus the float total-order extension."""

import numpy as np
import jax.numpy as jnp
import pytest

from radix_sort import dtypes


ALL = [np.uint32, np.int32, np.uint64, np.int64, np.float32, np.float64,
       np.uint16, np.int16]


@pytest.mark.parametrize("dt", ALL, ids=lambda d: np.dtype(d).name)
def test_numpy_transform_roundtrip_and_order(dt):
    d = np.dtype(dt)
    rng = np.random.default_rng(0)
    if d.kind == "f":
        vals = np.concatenate([
            rng.standard_normal(500).astype(d),
            np.array([0.0, -0.0, np.inf, -np.inf], dtype=d),
        ])
    else:
        info = np.iinfo(d)
        vals = rng.integers(info.min, info.max, size=500,
                            dtype=d if d.kind == "i" else d)
        vals = np.concatenate([vals, np.array([info.min, info.max, 0],
                                              dtype=d)])
    u = dtypes.np_to_sortable_unsigned(vals)
    assert u.dtype == dtypes.unsigned_container(d)
    back = dtypes.np_from_sortable_unsigned(u, d)
    assert np.array_equal(back.view(u.dtype), vals.view(u.dtype))  # bitwise
    # order preservation: unsigned order == source order
    order_u = np.argsort(u, kind="stable")
    sorted_src = vals[order_u]
    if d.kind == "f":
        # total order: -inf < ... < -0.0 < 0.0 < ... < inf
        finite = sorted_src[np.isfinite(sorted_src)]
        assert np.all(np.diff(finite) >= 0)
    else:
        assert np.all(np.diff(sorted_src.astype(object)) >= 0)


@pytest.mark.parametrize("dt", ALL, ids=lambda d: np.dtype(d).name)
def test_jax_transform_matches_numpy(dt):
    d = np.dtype(dt)
    rng = np.random.default_rng(1)
    if d.kind == "f":
        vals = rng.standard_normal(256).astype(d)
    elif d.kind == "i":
        vals = rng.integers(np.iinfo(d).min, np.iinfo(d).max, size=256,
                            dtype=d)
    else:
        vals = rng.integers(0, np.iinfo(d).max, size=256, dtype=d)
    ju = np.asarray(dtypes.to_sortable_unsigned(jnp.asarray(vals)))
    nu = dtypes.np_to_sortable_unsigned(vals)
    assert np.array_equal(ju, nu)
    jb = np.asarray(dtypes.from_sortable_unsigned(jnp.asarray(nu), d))
    assert np.array_equal(jb.view(nu.dtype), vals.view(nu.dtype))


def test_registry_names():
    assert dtypes.type_name(np.uint32) == "u32"
    assert dtypes.c_name(np.int64) == "int64_t"
    assert dtypes.key_bits(np.uint64) == 64
    assert dtypes.unsigned_container(np.float32) == np.dtype(np.uint32)
    assert dtypes.is_signed_int(np.int16)
    assert dtypes.is_float(np.float64)


def test_nan_total_order():
    vals = np.array([np.nan, 1.0, -np.nan, -1.0, np.inf, -np.inf],
                    dtype=np.float32)
    u = dtypes.np_to_sortable_unsigned(vals)
    s = vals[np.argsort(u, kind="stable")]
    # total order: -NaN < -inf < -1 < 1 < inf < NaN
    assert np.isnan(s[0]) and np.isnan(s[-1])
    assert s[1] == -np.inf and s[-2] == np.inf
