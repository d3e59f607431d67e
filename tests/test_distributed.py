"""Distributed layer on the 8-device simulated CPU mesh — the multi-chip
testing the reference could never do (its CI test step was inactive,
SURVEY.md §4); here the shuffle/sort/join/aggregate paths run on every test
invocation via xla_force_host_platform_device_count=8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radix_sort import datasets, golden
from radix_sort.table import Table
from radix_sort.parallel import dist_ops, dist_sort, exchange, mesh as mesh_lib
from jax.sharding import PartitionSpec as P

D = 8


@pytest.fixture(scope="module")
def mesh():
    return mesh_lib.make_mesh(D)


# ------------------------------------------------------------- exchange

def test_ragged_all_to_all_roundtrip(mesh):
    n_per = 64
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1000, size=D * n_per).astype(np.int32)
    dest = rng.integers(0, D, size=D * n_per).astype(np.int32)

    def shard_fn(v, d):
        recv, counts, overflow = exchange.ragged_all_to_all(
            (v,), d, D, n_per, "x", (np.int32(-1),))
        return recv[0], counts, overflow.astype(jnp.int32)

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(P("x"), P("x")),
                       out_specs=(P("x"), P("x"), P()))
    recv, counts, overflow = jax.jit(fn)(jnp.asarray(vals), jnp.asarray(dest))
    assert not bool(overflow)
    recv = np.asarray(recv).reshape(D, D, n_per)   # [dst, src, slot]
    counts = np.asarray(counts).reshape(D, D)      # [dst, src]
    # Every row must arrive exactly once at its destination, in source order.
    for dst in range(D):
        for src in range(D):
            expected = vals[src * n_per:(src + 1) * n_per][
                dest[src * n_per:(src + 1) * n_per] == dst]
            got = recv[dst, src, :counts[dst, src]]
            assert np.array_equal(got, expected)
            assert np.all(recv[dst, src, counts[dst, src]:] == -1)


def test_ragged_all_to_all_overflow_detected(mesh):
    # every row targets chip 0 with capacity 1 → guaranteed overflow.
    vals = np.arange(D * 16, dtype=np.int32)
    dest = np.zeros(D * 16, dtype=np.int32)

    def shard_fn(v, d):
        _, _, overflow = exchange.ragged_all_to_all(
            (v,), d, D, 1, "x", (np.int32(0),))
        return overflow.astype(jnp.int32)

    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P("x"), P("x")),
                       out_specs=P())
    assert bool(jax.jit(fn)(jnp.asarray(vals), jnp.asarray(dest)))


def test_packed_all_to_all_multibucket_slices(mesh):
    """One (sub, dest)-major stable partition feeding G exchanges via
    count/start slices — the overlapped shuffle's packing contract: every
    row arrives exactly once, in source order, in its own sub-round."""
    from radix_sort.ops import partition as part_ops

    G, n_per, cap = 2, 64, 64
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 10_000, size=D * n_per).astype(np.int32)
    dest = rng.integers(0, D, size=D * n_per).astype(np.int32)
    sub = rng.integers(0, G, size=D * n_per).astype(np.int32)

    def shard_fn(v, d, s):
        parted, cnts, starts = part_ops.stable_partition(
            s * D + d, (v,), D * G)
        outs = []
        for g in range(G):
            recv, rcounts, _ = exchange.packed_all_to_all(
                parted, cnts[g * D:(g + 1) * D],
                starts[g * D:(g + 1) * D], D, cap, "x", (np.int32(-1),))
            outs += [recv[0], rcounts]
        return tuple(outs)

    fn = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P("x"), P("x"), P("x")),
        out_specs=tuple([P("x")] * (2 * G)))
    outs = jax.jit(fn)(jnp.asarray(vals), jnp.asarray(dest),
                       jnp.asarray(sub))
    for g in range(G):
        recv = np.asarray(outs[2 * g]).reshape(D, D, cap)
        counts = np.asarray(outs[2 * g + 1]).reshape(D, D)
        for dst in range(D):
            for src in range(D):
                sl = slice(src * n_per, (src + 1) * n_per)
                expected = vals[sl][(dest[sl] == dst) & (sub[sl] == g)]
                got = recv[dst, src, :counts[dst, src]]
                assert np.array_equal(got, expected), (g, dst, src)
                assert np.all(recv[dst, src, counts[dst, src]:] == -1)


# ------------------------------------------------------------- dist sort

@pytest.mark.parametrize("ds_name", ["Zeros", "RandomDistributed", "Random",
                                     "Range", "InvertedRange"])
def test_dist_sort_distributions(mesh, ds_name):
    """All five reference distributions globally sorted across 8 chips —
    including Zeros, the maximal-skew case."""
    for ds in datasets.make_datasets(np.uint32, seed=3):
        if ds.name != ds_name:
            continue
        data = ds.generate(1 << 12)
        got = np.asarray(dist_sort.dist_sort(jnp.asarray(data), mesh=mesh))
        assert golden.validate_bit_exact(got, golden.oracle_sort(data),
                                         data.size), ds.name


def test_dist_sort_kv_stable(mesh):
    keys = np.array([7, 7, 7, 7, 1, 1, 1, 1] * 128, dtype=np.uint32)
    vals = np.arange(keys.size, dtype=np.int32)
    k, v, overflow = dist_sort.dist_sort_kv(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh)
    assert not bool(overflow)
    perm = golden.oracle_argsort(keys)
    assert np.array_equal(np.asarray(k), keys[perm])
    assert np.array_equal(np.asarray(v), vals[perm])


def test_dist_sort_non_divisible_n(mesh):
    data = datasets.RandomDistributed(np.int32, seed=1).generate(1000)
    got = np.asarray(dist_sort.dist_sort(jnp.asarray(data), mesh=mesh))
    assert np.array_equal(got, np.sort(data))


def test_dist_sort_i64(mesh):
    data = datasets.RandomDistributed(np.int64, seed=2).generate(2048)
    got = np.asarray(dist_sort.dist_sort(jnp.asarray(data), mesh=mesh))
    assert np.array_equal(got, np.sort(data))


def test_dist_sort_f32(mesh):
    """Float keys ride the same total-order unsigned transform through the
    shuffle (sample splitters, tie spread, sentinel padding) and come back
    as floats — incl. the ±inf edges the device generators plant."""
    rng = np.random.default_rng(5)
    data = rng.standard_normal(D * 700 + 3).astype(np.float32)
    data[:4] = [np.inf, -np.inf, 0.0, -0.0]
    out = dist_sort.dist_sort(jnp.asarray(data), mesh=mesh)
    assert np.array_equal(np.asarray(out), np.sort(data))


def test_dist_sort_skewed_zipf(mesh):
    rng = np.random.default_rng(0)
    data = (rng.zipf(1.5, size=4096) % 1000).astype(np.uint32)
    got = np.asarray(dist_sort.dist_sort(jnp.asarray(data), mesh=mesh))
    assert np.array_equal(got, np.sort(data))


# -------------------------------------------------------- dist aggregate

def test_dist_hash_aggregate(mesh):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, size=2048).astype(np.uint32)
    vals = rng.integers(-50, 50, size=2048).astype(np.int32)
    t = Table.from_numpy({"g": keys, "x": vals})
    out, overflow = dist_ops.dist_hash_aggregate(
        t, "g", {"n": ("count", None), "s": ("sum", "x")}, mesh=mesh)
    assert not bool(overflow)
    res = out.to_numpy()
    order = np.argsort(res["g"], kind="stable")
    uk = np.unique(keys)
    assert np.array_equal(res["g"][order], uk)
    exp_n = np.array([(keys == k).sum() for k in uk])
    exp_s = np.array([vals[keys == k].sum() for k in uk])
    assert np.array_equal(res["n"][order], exp_n)
    assert np.array_equal(res["s"][order], exp_s)


def test_dist_hash_aggregate_skew_escalation(mesh):
    """Degenerate hash skew — fewer distinct keys than chips, so most
    exchange capacity sits on a couple of (src, dst) pairs — must complete
    via host-level capacity escalation, not report overflow."""
    n = 2048
    rng = np.random.default_rng(11)
    keys = (rng.integers(0, 3, size=n)).astype(np.uint32)   # 3 groups, 8 chips
    vals = np.ones(n, np.int32)
    out, overflow = dist_ops.dist_hash_aggregate(
        Table.from_numpy({"g": keys, "x": vals}), "g",
        {"n": ("count", None), "s": ("sum", "x")}, mesh=mesh)
    assert not bool(overflow)
    res = out.to_numpy()
    order = np.argsort(res["g"], kind="stable")
    uk, inv = np.unique(keys, return_inverse=True)
    assert np.array_equal(res["g"][order], uk)
    assert np.array_equal(res["n"][order], np.bincount(inv))


# ------------------------------------------------------------- dist join

def test_dist_hash_join(mesh):
    rng = np.random.default_rng(7)
    pk = rng.integers(0, 500, size=1024).astype(np.uint32)
    bk = np.arange(0, 500, 2, dtype=np.uint32)       # unique even keys
    pad_b = np.zeros(512 - bk.size, dtype=np.uint32)  # pad to mesh multiple
    build = Table({"k": jnp.asarray(np.concatenate([bk, pad_b])),
                   "bv": jnp.asarray(np.concatenate(
                       [bk.astype(np.int32) * 10,
                        np.zeros(512 - bk.size, np.int32)]))},
                  num_rows=bk.size)
    probe = Table.from_numpy({"k": pk, "pv": np.arange(1024, dtype=np.int32)})
    out, stats = dist_ops.dist_hash_join(probe, build, "k", mesh=mesh)
    assert not bool(stats["overflow"])
    res = out.to_numpy()
    exp_matches = int(np.isin(pk, bk).sum())
    assert int(stats["match_count"]) == exp_matches
    assert res["k"].size == exp_matches
    assert np.array_equal(res["bv"], res["k"].astype(np.int32) * 10)
    # every matched probe row appears exactly once
    got = sorted(zip(res["k"].tolist(), res["pv"].tolist()))
    exp = sorted((int(k), i) for i, k in enumerate(pk) if k in set(bk.tolist()))
    assert got == exp


def test_dist_hash_join_skew_escalation(mesh):
    """Probe keys concentrated on 4 distinct values (all hashing to at most
    4 of 8 chips): the shuffle overflows at expected-load capacity and must
    escalate to completion with every match present exactly once."""
    n = 1024
    rng = np.random.default_rng(13)
    bk = np.array([0, 2, 4, 6], dtype=np.uint32)
    build = Table({"k": jnp.asarray(np.concatenate([bk, np.zeros(4, np.uint32)])),
                   "bv": jnp.asarray(np.concatenate(
                       [bk.astype(np.int32) * 3, np.zeros(4, np.int32)]))},
                  num_rows=bk.size)
    pk = rng.integers(0, 8, size=n).astype(np.uint32)
    probe = Table.from_numpy({"k": pk, "pv": np.arange(n, dtype=np.int32)})
    out, stats = dist_ops.dist_hash_join(probe, build, "k", mesh=mesh)
    assert not bool(stats["overflow"])
    res = out.to_numpy()
    exp_matches = int(np.isin(pk, bk).sum())
    assert int(stats["match_count"]) == exp_matches
    assert res["k"].size == exp_matches
    assert np.array_equal(res["bv"], res["k"].astype(np.int32) * 3)


def test_runtime_single_host_initialize():
    from radix_sort.parallel import runtime
    info = runtime.initialize()
    assert info.num_processes == 1
    assert info.global_devices >= 1


def test_runtime_health_check(mesh):
    from radix_sort.parallel import runtime
    status = runtime.health_check(mesh)
    assert status["ok"]
    assert status["devices"] == 8
    # the heartbeat must be a real collective: every device's token summed
    # over the mesh axis (a host-local sum would not prove participation).
    assert status["heartbeat_total"] == 8


def test_runtime_health_check_timeout_path(mesh, monkeypatch):
    """A heartbeat EXECUTION that never completes must surface as ok=False
    within timeout_s, not hang the caller.  (Compiles happen before the
    timer by design — a long compile must not read as a dead peer — so
    the hang is injected at the executable level.)"""
    from radix_sort.parallel import runtime

    def hanging_compiled(_mesh):
        def hang(_tokens):
            import time as _t
            _t.sleep(30.0)
        return hang

    monkeypatch.setattr(runtime, "_compiled_heartbeat", hanging_compiled)
    status = runtime.health_check(mesh, timeout_s=1.0)
    assert not status["ok"]
    assert "timed out" in status["error"]


def test_runtime_health_check_setup_failure_path(mesh, monkeypatch):
    """A wedged backend / failed compile — exactly what a health check
    exists to report — must come back as a status dict, never a raise."""
    from radix_sort.parallel import runtime

    def broken_compile(_mesh):
        raise RuntimeError("backend wedged")

    monkeypatch.setattr(runtime, "_compiled_heartbeat", broken_compile)
    status = runtime.health_check(mesh, timeout_s=1.0)
    assert not status["ok"]
    assert "backend wedged" in status["error"]


@pytest.mark.parametrize("ds_name", ["Zeros", "RandomDistributed"])
def test_dist_sort_overlapped_chunks(mesh, ds_name):
    """The comm/compute-overlapped shuffle (value-range sub-chunks whose
    exchanges interleave with local sorts) sorts identically to the
    single-exchange path — including under maximal skew."""
    for ds in datasets.make_datasets(np.uint32, seed=5):
        if ds.name != ds_name:
            continue
        data = ds.generate(1 << 12)
        got, _, overflow = dist_sort.dist_sort_kv(
            jnp.asarray(data), None, mesh=mesh, overlap_chunks=4)
        assert not overflow
        assert golden.validate_bit_exact(np.asarray(got),
                                         golden.oracle_sort(data),
                                         data.size), ds.name


def test_dist_sort_overlapped_kv_stable(mesh):
    """Stability of the overlapped path: payload permutation must equal the
    stable argsort."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 50, size=1 << 10).astype(np.uint32)  # many ties
    vals = np.arange(data.size, dtype=np.int32)
    ks, vs, overflow = dist_sort.dist_sort_kv(
        jnp.asarray(data), jnp.asarray(vals), mesh=mesh, overlap_chunks=2)
    assert not overflow
    assert np.array_equal(np.asarray(ks), golden.oracle_sort(data))
    assert np.array_equal(np.asarray(vs), golden.oracle_argsort(data))


# -------------------------------------------------------------- dist top-k

def test_dist_top_k_unique_keys_with_payload(mesh):
    rng = np.random.default_rng(17)
    n = 1024
    keys = rng.permutation(n).astype(np.uint32)      # unique -> exact oracle
    vals = (keys * 3 + 1).astype(np.int32)
    t = Table.from_numpy({"k": keys, "v": vals})
    out = dist_ops.dist_top_k(t, "k", 10, mesh=mesh).to_numpy()
    exp = np.sort(keys)[::-1][:10]
    assert np.array_equal(out["k"], exp)
    assert np.array_equal(out["v"], exp * 3 + 1)
    small = dist_ops.dist_top_k(t, "k", 7, largest=False, mesh=mesh)
    assert np.array_equal(small.to_numpy()["k"], np.sort(keys)[:7])


def test_dist_top_k_padding_rows_lose(mesh):
    n, rows = 512, 300
    keys = np.arange(n, dtype=np.int64)
    keys[rows:] = 10_000_000                          # garbage in padding
    t = Table({"k": jnp.asarray(keys)}, num_rows=rows)
    out = dist_ops.dist_top_k(t, "k", 5, mesh=mesh).to_numpy()
    assert np.array_equal(out["k"], np.arange(rows)[::-1][:5])


def test_dist_top_k_k_exceeds_per_device(mesh):
    rng = np.random.default_rng(23)
    n = 256                                           # per_dev = 32 < k
    keys = rng.permutation(n).astype(np.int32) - 128
    t = Table.from_numpy({"k": keys})
    out = dist_ops.dist_top_k(t, "k", 100, mesh=mesh).to_numpy()
    assert np.array_equal(out["k"], np.sort(keys)[::-1][:100])


def test_dist_top_k_fewer_valid_rows_than_k(mesh):
    keys = np.arange(64, dtype=np.uint32)
    t = Table({"k": jnp.asarray(keys)}, num_rows=3)
    out = dist_ops.dist_top_k(t, "k", 8, mesh=mesh)
    assert int(out.num_rows) == 3
    assert np.array_equal(out.to_numpy()["k"], [2, 1, 0])


def test_dist_top_k_ties_return_correct_multiset(mesh):
    rng = np.random.default_rng(29)
    keys = rng.integers(0, 4, size=512).astype(np.uint32)  # heavy ties
    t = Table.from_numpy({"k": keys})
    out = dist_ops.dist_top_k(t, "k", 50, mesh=mesh).to_numpy()
    assert np.array_equal(out["k"], np.sort(keys)[::-1][:50])
