"""Sort engine correctness: the full matrix sweep the reference runs as its
"Main test" (tests/tests.cpp:90-113: 4 types x 5 datasets, bit-exact vs
std::sort), plus the kernel-level properties the reference only TODO'd
(SURVEY.md §4): stability, padding behavior, value permutation."""

import numpy as np
import jax.numpy as jnp
import pytest

from radix_sort import datasets, golden, sort, sort_kv, argsort
from radix_sort.config import SortConfig

ENGINES = ["xla_sort", "xla_radix"]

# Small-but-awkward sizes: empty-adjacent, sub-block, block-straddling.
SIZES = [1, 2, 255, 1024, 4096, 10_000]


@pytest.mark.parametrize("engine", ENGINES)
def test_matrix_sweep(key_dtype, engine):
    """4 dtypes x 5 distributions, bit-exact vs the oracle."""
    cfg = SortConfig(bits_per_pass=8, block_elems=1024, engine=engine)
    for ds in datasets.make_datasets(key_dtype, seed=5):
        data = ds.generate(3000)
        got = np.asarray(sort(jnp.asarray(data), config=cfg))
        exp = golden.oracle_sort(data)
        assert golden.validate_bit_exact(got, exp, data.size), (
            f"{ds.name} {key_dtype} {engine}")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n", SIZES)
def test_sizes(engine, n):
    cfg = SortConfig(bits_per_pass=8, block_elems=1024, engine=engine)
    data = datasets.RandomDistributed(np.uint32, seed=n).generate(n)
    got = np.asarray(sort(jnp.asarray(data), config=cfg))
    assert golden.validate_bit_exact(got, golden.oracle_sort(data), n)


def test_empty():
    out = sort(jnp.asarray(np.array([], dtype=np.uint32)))
    assert out.shape == (0,)


@pytest.mark.parametrize("engine", ENGINES)
def test_reference_radix16_config(engine):
    """The reference's own 4-bit/radix-16 configuration must work."""
    cfg = SortConfig(bits_per_pass=4, block_elems=1024, engine=engine)
    data = datasets.Random(np.uint32).generate(5000)
    got = np.asarray(sort(jnp.asarray(data), config=cfg))
    assert golden.validate_bit_exact(got, golden.oracle_sort(data), 5000)


@pytest.mark.parametrize("engine", ENGINES)
def test_kv_sort_permutes_payload(key_dtype, engine):
    cfg = SortConfig(bits_per_pass=8, block_elems=1024, engine=engine)
    data = datasets.RandomDistributed(key_dtype, seed=9).generate(2048)
    vals = np.arange(2048, dtype=np.int32)
    k, v = sort_kv(jnp.asarray(data), jnp.asarray(vals), config=cfg)
    perm = golden.oracle_argsort(data)
    assert np.array_equal(np.asarray(k), data[perm])
    assert np.array_equal(np.asarray(v), vals[perm])


@pytest.mark.parametrize("engine", ENGINES)
def test_stability(engine):
    """Equal keys keep input order — the contract that makes KV sort and the
    distributed shuffle deterministic.  Reference's scatter relied on this
    (RadixSort.cl:69) but never tested it."""
    cfg = SortConfig(bits_per_pass=8, block_elems=1024, engine=engine)
    keys = np.array([3, 1, 3, 1, 3, 1, 2, 2] * 300, dtype=np.uint32)
    idx = np.arange(keys.size, dtype=np.int32)
    _, got_idx = sort_kv(jnp.asarray(keys), jnp.asarray(idx), config=cfg)
    exp_idx = golden.oracle_argsort(keys)
    assert np.array_equal(np.asarray(got_idx), exp_idx)


@pytest.mark.parametrize("engine", ENGINES)
def test_kv_pytree_values(engine):
    cfg = SortConfig(bits_per_pass=8, block_elems=1024, engine=engine)
    keys = np.array([5, 3, 5, 1], dtype=np.uint32)
    vals = {"a": jnp.asarray(np.array([10, 20, 30, 40], np.int32)),
            "b": jnp.asarray(np.array([1.5, 2.5, 3.5, 4.5], np.float32))}
    k, v = sort_kv(jnp.asarray(keys), vals, config=cfg)
    assert np.array_equal(np.asarray(k), [1, 3, 5, 5])
    assert np.array_equal(np.asarray(v["a"]), [40, 20, 10, 30])
    assert np.allclose(np.asarray(v["b"]), [4.5, 2.5, 1.5, 3.5])


def test_argsort_matches_oracle(key_dtype):
    data = datasets.RandomDistributed(key_dtype, seed=2).generate(4000)
    perm = np.asarray(argsort(jnp.asarray(data), engine="xla_radix",
                              config=SortConfig(block_elems=1024,
                                                engine="xla_radix")))
    assert np.array_equal(perm, golden.oracle_argsort(data))


@pytest.mark.parametrize("engine", ENGINES)
def test_float_keys(engine):
    cfg = SortConfig(bits_per_pass=8, block_elems=1024, engine=engine)
    rng = np.random.default_rng(0)
    data = rng.standard_normal(3000).astype(np.float32)
    data[:3] = [np.inf, -np.inf, 0.0]
    got = np.asarray(sort(jnp.asarray(data), config=cfg))
    assert np.array_equal(got, np.sort(data))


def test_rejects_2d():
    from radix_sort import EngineError
    with pytest.raises(EngineError):
        sort(jnp.zeros((4, 4), dtype=jnp.uint32))


def test_unknown_engine_rejected():
    from radix_sort import EngineError
    with pytest.raises(EngineError):
        sort(jnp.zeros(8, dtype=jnp.uint32), engine="nope")


@pytest.mark.parametrize("dt", [np.uint16, np.int16, np.float64],
                         ids=["u16", "i16", "f64"])
def test_extended_dtypes(dt):
    rng = np.random.default_rng(0)
    if np.dtype(dt).kind == "f":
        data = rng.standard_normal(3000).astype(dt)
    else:
        info = np.iinfo(dt)
        data = rng.integers(info.min, info.max, 3000, dtype=dt)
    for eng in ("xla_sort", "xla_radix"):
        cfg = SortConfig(bits_per_pass=8, block_elems=1024, engine=eng)
        got = np.asarray(sort(jnp.asarray(data), config=cfg))
        assert np.array_equal(got, np.sort(data)), eng
