"""ops/scan.py and datasets_device twins."""

import numpy as np
import jax.numpy as jnp
import pytest

from radix_sort import datasets, datasets_device
from radix_sort.ops import scan


def test_exclusive_scan_engines():
    x = np.random.default_rng(0).integers(0, 50, 1000).astype(np.int32)
    exp = np.cumsum(x) - x
    assert np.array_equal(np.asarray(scan.exclusive_scan(jnp.asarray(x))),
                          exp)


def test_segment_boundaries():
    keys = jnp.asarray(np.array([1, 1, 2, 5, 5, 5], np.uint32))
    is_new, seg = scan.segment_boundaries(keys)
    assert np.array_equal(np.asarray(is_new),
                          [True, False, True, True, False, False])
    assert np.array_equal(np.asarray(seg), [0, 0, 1, 2, 2, 2])


def test_segmented_exclusive_scan():
    x = jnp.asarray(np.array([1, 2, 3, 4, 5], np.int32))
    seg = jnp.asarray(np.array([0, 0, 1, 1, 1], np.int32))
    out = np.asarray(scan.segmented_exclusive_scan(x, seg))
    assert np.array_equal(out, [0, 1, 0, 3, 7])


@pytest.mark.parametrize("name", ["Zeros", "Range", "InvertedRange"])
def test_device_twins_match_host(name, key_dtype):
    host = {c.name: c for c in datasets.make_datasets(key_dtype)}[name]
    dev = datasets_device.generate(name, key_dtype, 257)
    assert np.array_equal(np.asarray(dev), host.generate(257))


def test_device_random_distributed_plants(key_dtype):
    dev = np.asarray(datasets_device.generate(
        "RandomDistributed", key_dtype, 512, seed=1))
    info = np.iinfo(key_dtype)
    assert dev[0] == info.min and dev[-1] == info.max
    assert dev.dtype == key_dtype


def test_device_unknown_rejected():
    with pytest.raises(ValueError):
        datasets_device.generate("Nope", np.uint32, 8)


def test_switch_dispatch_generates_each_distribution():
    """Regression for the round-1 sweep bug (ADVICE.md): a lax.switch branch
    list built with a bare closure over the loop variable makes EVERY branch
    generate the last name in ALL_NAMES, silently mislabeling benchmark
    rows.  The dispatch pattern (as used by scripts/benchmark.py, with the
    name bound at definition time) must generate each branch's own
    distribution."""
    import jax

    n = 64
    gen = jax.jit(lambda i, s: jax.lax.switch(
        i,
        [lambda s, nm=nm: datasets_device.generate(nm, np.uint32, n, seed=s)
         for nm in datasets_device.ALL_NAMES],
        s))
    outs = []
    for idx, nm in enumerate(datasets_device.ALL_NAMES):
        expect = np.asarray(datasets_device.generate(nm, np.uint32, n,
                                                     seed=0))
        got = np.asarray(gen(idx, 0))
        assert np.array_equal(got, expect), nm
        outs.append(got)
    # the five distributions are pairwise distinct at this n/seed
    for a in range(len(outs)):
        for b in range(a + 1, len(outs)):
            assert not np.array_equal(outs[a], outs[b])
