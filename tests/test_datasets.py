"""Dataset generator behavior — parity with src/Dataset.h:21-169."""

import numpy as np

from radix_sort import datasets


def test_zeros(key_dtype):
    d = datasets.Zeros(key_dtype).generate(100)
    assert d.dtype == key_dtype
    assert np.all(d == 0)


def test_random_distributed_plants_min_max(key_dtype):
    d = datasets.RandomDistributed(key_dtype, seed=7).generate(1000)
    info = np.iinfo(key_dtype)
    # Reference plants global min at the front and max at the back
    # (src/Dataset.h:104-106).
    assert d[0] == info.min
    assert d[-1] == info.max
    assert d.dtype == key_dtype


def test_random_distributed_seed_reproducible(key_dtype):
    a = datasets.RandomDistributed(key_dtype, seed=3).generate(512)
    b = datasets.RandomDistributed(key_dtype, seed=3).generate(512)
    c = datasets.RandomDistributed(key_dtype, seed=4).generate(512)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_random_fixed_seed_deterministic(key_dtype):
    # Reference's `Random` is mt19937 with a fixed seed (src/Dataset.h:113-119).
    a = datasets.Random(key_dtype).generate(512)
    b = datasets.Random(key_dtype).generate(512)
    assert np.array_equal(a, b)
    if np.dtype(key_dtype).itemsize == 8:
        # mt19937 emits 32-bit words, so 64-bit keys stay below 2^32.
        assert np.all(a.astype(np.uint64) < (1 << 32))


def test_range_starts_at_type_min(key_dtype):
    d = datasets.Range(key_dtype).generate(16)
    info = np.iinfo(key_dtype)
    assert d[0] == info.min
    assert np.all(np.diff(d.astype(np.int64 if info.min < 0 else np.uint64))
                  == 1)


def test_inverted_range_is_reversed_range(key_dtype):
    r = datasets.Range(key_dtype).generate(64)
    inv = datasets.InvertedRange(key_dtype).generate(64)
    assert np.array_equal(inv, r[::-1])


def test_make_datasets_fanout(key_dtype):
    ds = datasets.make_datasets(key_dtype)
    names = [d.name for d in ds]
    assert names == ["Zeros", "RandomDistributed", "Random", "Range",
                     "InvertedRange"]


def test_empty_and_single():
    for cls in datasets.ALL_DATASETS:
        gen = cls(np.uint32, seed=0) if cls is datasets.RandomDistributed \
            else cls(np.uint32)
        assert gen.generate(0).shape == (0,)
        assert gen.generate(1).shape == (1,)
