"""Native C++ host baselines (built via `make -C native`); skipped when the
shared library hasn't been compiled."""

import numpy as np
import pytest

from radix_sort.utils import native_baseline as nb

pytestmark = pytest.mark.skipif(not nb.available(),
                                reason="native library not built")


def test_std_sort_matches_numpy(key_dtype):
    rng = np.random.default_rng(0)
    info = np.iinfo(key_dtype)
    x = rng.integers(info.min, info.max, 10000, dtype=key_dtype)
    assert np.array_equal(nb.std_sort(x), np.sort(x))


def test_radix_sort_matches_numpy(key_dtype):
    rng = np.random.default_rng(1)
    info = np.iinfo(key_dtype)
    x = rng.integers(info.min, info.max, 10000, dtype=key_dtype)
    assert np.array_equal(nb.radix_sort(x), np.sort(x))


def test_radix_kv_stable():
    keys = np.array([5, 1, 5, 1, 5], np.uint32)
    vals = np.arange(5, dtype=np.uint32)
    k, v = nb.radix_sort_kv_u32(keys, vals)
    assert np.array_equal(k, [1, 1, 5, 5, 5])
    assert np.array_equal(v, [1, 3, 0, 2, 4])


def test_inputs_not_mutated():
    x = np.array([3, 1, 2], np.uint32)
    nb.radix_sort(x)
    assert np.array_equal(x, [3, 1, 2])
