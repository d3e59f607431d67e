"""The XLA reorder paths: stable partition and compaction by both methods,
key-value and 64-bit sorts by both engines, and the engine and method
names that resolve to them — each against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radix_sort import datasets
from radix_sort.config import SortConfig
from radix_sort.ops import partition
from radix_sort.ops import sort as sort_ops
from radix_sort.status import EngineError

METHODS = ["sort", "rank"]
PAYLOAD_DTYPES = [np.int32, np.uint32, np.float32, np.int64, np.uint64,
                  np.float64]


def _random_payload(rng, dtype, n):
    d = np.dtype(dtype)
    if d.kind == "f":
        out = rng.standard_normal(n).astype(d)
        if n >= 2:
            out[0], out[-1] = -np.inf, np.inf
        return out
    info = np.iinfo(d)
    out = rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    if n >= 2:
        out[0], out[-1] = info.min, info.max
    return out


# -------------------------------------------------------------- partition

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("num_buckets", [2, 16, 256])
@pytest.mark.parametrize("n", [0, 1, 1001, (1 << 16) + 3])
def test_stable_partition_matches_numpy(method, num_buckets, n):
    rng = np.random.default_rng(n + num_buckets)
    ids = rng.integers(0, num_buckets, n).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)
    (out_ids, out_vals), counts, starts = partition.stable_partition(
        jnp.asarray(ids), (jnp.asarray(ids), jnp.asarray(vals)),
        num_buckets, method=method)
    perm = np.argsort(ids, kind="stable")
    want = np.bincount(ids, minlength=num_buckets)
    np.testing.assert_array_equal(np.asarray(out_ids), ids[perm])
    np.testing.assert_array_equal(np.asarray(out_vals), vals[perm])
    np.testing.assert_array_equal(np.asarray(counts), want)
    np.testing.assert_array_equal(np.asarray(starts), np.cumsum(want) - want)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", PAYLOAD_DTYPES,
                         ids=[np.dtype(d).name for d in PAYLOAD_DTYPES])
def test_compact_mask_payload_dtypes(method, dtype):
    n = 4099
    rng = np.random.default_rng(7)
    mask = rng.random(n) < 0.4
    vals = _random_payload(rng, dtype, n)
    (out,), kept = partition.compact_mask(jnp.asarray(mask),
                                          (jnp.asarray(vals),), method=method)
    assert int(kept) == int(mask.sum())
    out = np.asarray(out)
    assert out.dtype == np.dtype(dtype)
    # bit-exact, so signed zeros and infinities must survive the move
    np.testing.assert_array_equal(out[:int(kept)].view(np.uint8),
                                  vals[mask].view(np.uint8))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("num_buckets", [2, 16])
def test_partition_stable_under_heavy_duplicates(method, num_buckets):
    n = 20_000
    rng = np.random.default_rng(3)
    # 95% of rows share bucket 0; the rest spread over the other buckets
    ids = np.where(rng.random(n) < 0.95, 0,
                   rng.integers(0, num_buckets, n)).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)
    (out_ids, out_pos), counts, _ = partition.stable_partition(
        jnp.asarray(ids), (jnp.asarray(ids), jnp.asarray(pos)), num_buckets,
        method=method)
    out_ids, out_pos = np.asarray(out_ids), np.asarray(out_pos)
    assert np.all(np.diff(out_ids) >= 0)
    # within a bucket, input order is kept
    same = out_ids[1:] == out_ids[:-1]
    assert np.all(out_pos[1:][same] > out_pos[:-1][same])
    np.testing.assert_array_equal(np.asarray(counts),
                                  np.bincount(ids, minlength=num_buckets))


# ------------------------------------------------------------------ sorts

@pytest.mark.parametrize("engine", ["auto", "xla_radix"])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64], ids=["u32", "u64"])
@pytest.mark.parametrize("dataset", range(5), ids=[
    c.name for c in datasets.ALL_DATASETS])
def test_kv_sort_distributions(engine, dtype, dataset):
    n = (1 << 12) + 5
    keys = datasets.make_datasets(dtype, seed=11)[dataset].generate(n)
    vals = np.arange(n, dtype=np.int32)
    cfg = SortConfig(block_elems=1024, engine=engine)
    out_k, out_v = sort_ops.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                                    config=cfg)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(out_k), keys[perm])
    np.testing.assert_array_equal(np.asarray(out_v), perm.astype(np.int32))


# ----------------------------------------------- engine and method names

@pytest.mark.parametrize("name", ["pallas", "pallas_merge", "pallas_stream",
                                  "chunked"])
def test_removed_engine_raises(name):
    with pytest.raises(EngineError, match="unknown engine"):
        sort_ops.sort(jnp.arange(8, dtype=jnp.uint32), engine=name)


def test_unknown_partition_method_raises():
    with pytest.raises(ValueError, match="unknown partition method"):
        partition.stable_partition(jnp.zeros(4, jnp.int32),
                                   (jnp.zeros(4, jnp.int32),), 2,
                                   method="stream")


def _primitives(jaxpr) -> set:
    """Names of every primitive in a jaxpr, sub-jaxprs included."""
    names = set()
    for eqn in getattr(jaxpr, "jaxpr", jaxpr).eqns:
        names.add(eqn.primitive.name)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            names |= _primitives(sub)
    return names


@pytest.mark.parametrize("num_buckets", [2, 16])
@pytest.mark.parametrize("log2n,planes", [(10, 1), (24, 1), (24, 4),
                                          (25, 8), (27, 1)])
def test_auto_partition_is_one_xla_sort(num_buckets, log2n, planes):
    """The sizes where "auto" once chose a hand-written kernel now trace
    to one stable lax.sort (tracing only: nothing is allocated)."""
    n = 1 << log2n
    ids = jax.ShapeDtypeStruct((n,), jnp.int32)
    arrays = tuple(jax.ShapeDtypeStruct((n,), jnp.uint32)
                   for _ in range(planes))
    jaxpr = jax.make_jaxpr(lambda i, a: partition.stable_partition(
        i, a, num_buckets, method="auto"))(ids, arrays)
    prims = _primitives(jaxpr)
    assert "sort" in prims
    assert "pallas_call" not in prims and "scatter" not in prims
    assert partition.resolve_method("auto") == "sort"


@pytest.mark.parametrize("log2n", [20, 27])
def test_auto_sort_engine_is_xla_sort(log2n):
    n = 1 << log2n
    k = jax.ShapeDtypeStruct((n,), jnp.uint32)
    v = jax.ShapeDtypeStruct((n,), jnp.int32)
    prims = _primitives(jax.make_jaxpr(
        lambda a, b: sort_ops.sort_kv(a, b, engine="auto"))(k, v))
    assert "sort" in prims and "pallas_call" not in prims
    assert sort_ops._dispatch_engine("auto") == "xla_sort"
