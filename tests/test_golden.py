"""Golden model self-consistency: the CPU radix golden must match the
np.sort oracle — the same transitive-validation contract the reference uses
(src/CRadixSortTask.cpp:224-252: CPU radix is itself validated vs std::sort)."""

import numpy as np
import pytest

from radix_sort import datasets, golden


@pytest.mark.parametrize("n", [0, 1, 2, 33, 1024, 5000])
def test_cpu_radix_matches_oracle(key_dtype, n):
    for ds in datasets.make_datasets(key_dtype, seed=11):
        data = ds.generate(n)
        got = golden.cpu_radix_sort(data)
        exp = golden.oracle_sort(data)
        assert golden.validate_bit_exact(got, exp, n), (
            f"{ds.name} n={n} dtype={key_dtype}")


def test_cpu_radix_floats():
    rng = np.random.default_rng(0)
    data = rng.standard_normal(999).astype(np.float32)
    data[0] = -0.0
    data[1] = 0.0
    got = golden.cpu_radix_sort(data)
    exp = golden.oracle_sort(data)
    # np.sort treats -0.0 == 0.0 (unordered); our bit transform gives them a
    # total order (-0.0 < 0.0).  Compare as floats, not bits.
    assert np.array_equal(got, exp)


def test_validate_bit_exact_detects_mismatch():
    a = np.array([1, 2, 3], dtype=np.uint32)
    b = np.array([1, 2, 4], dtype=np.uint32)
    assert golden.validate_bit_exact(a, b, 2)
    assert not golden.validate_bit_exact(a, b, 3)


def test_oracle_argsort_stable():
    keys = np.array([2, 1, 2, 1, 1], dtype=np.uint32)
    perm = golden.oracle_argsort(keys)
    assert list(perm) == [1, 3, 4, 0, 2]
