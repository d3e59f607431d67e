"""Operator set: partition, filter, aggregate, join — validated against
numpy golden semantics (the reference's oracle discipline extended to the
operator set, SURVEY.md §4 implication)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radix_sort.table import Table
from radix_sort.ops import partition, filter as filt, aggregate, join


# ---------------------------------------------------------------- partition

def test_stable_partition_matches_stable_argsort():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 7, size=5000).astype(np.int32)
    vals = np.arange(5000, dtype=np.int32)
    (out_ids, out_vals), counts, starts = partition.stable_partition(
        jnp.asarray(ids), (jnp.asarray(ids), jnp.asarray(vals)), 7,
        block_elems=1024)
    perm = np.argsort(ids, kind="stable")
    assert np.array_equal(np.asarray(out_ids), ids[perm])
    assert np.array_equal(np.asarray(out_vals), vals[perm])
    assert np.array_equal(np.asarray(counts), np.bincount(ids, minlength=7))
    assert np.array_equal(np.asarray(starts),
                          np.cumsum(np.bincount(ids, minlength=7))
                          - np.bincount(ids, minlength=7))


def test_stable_partition_non_divisible_n():
    ids = np.array([2, 0, 1, 2, 0], np.int32)
    (out,), counts, _ = partition.stable_partition(
        jnp.asarray(ids), (jnp.asarray(ids),), 3, block_elems=1024)
    assert np.array_equal(np.asarray(out), [0, 0, 1, 2, 2])
    assert np.array_equal(np.asarray(counts), [2, 1, 2])


def test_radix_partition_by_digit():
    keys = np.array([0x12, 0x34, 0x56, 0x78, 0x9A], np.uint32)
    (out,), counts, _ = partition.radix_partition(
        jnp.asarray(keys), (jnp.asarray(keys),), bits=4, shift=4)
    # high nibbles: 1,3,5,7,9 — already ascending.
    assert np.array_equal(np.asarray(out), keys)
    assert int(np.asarray(counts).sum()) == 5


def test_compact_mask():
    mask = np.array([True, False, True, False, True])
    vals = np.arange(5, dtype=np.int32)
    (out,), kept = partition.compact_mask(
        jnp.asarray(mask), (jnp.asarray(vals),))
    assert int(kept) == 3
    assert np.array_equal(np.asarray(out)[:3], [0, 2, 4])


@pytest.mark.parametrize("counts", [[3, 0, 4, 1], [0, 0, 0], [4, 4],
                                    [0, 2, 0, 3, 0]])
def test_compact_prefix_slots(counts):
    slot = 4
    counts = np.asarray(counts, np.int32)
    S = counts.shape[0]
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 30, size=S * slot).astype(np.int32)
    b = rng.integers(0, 1 << 30, size=S * slot).astype(np.uint32)
    (oa, ob), total = partition.compact_prefix_slots(
        (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(counts), slot)
    want_a = np.concatenate(
        [a[s * slot: s * slot + counts[s]] for s in range(S)] or
        [a[:0]])
    want_b = np.concatenate(
        [b[s * slot: s * slot + counts[s]] for s in range(S)] or
        [b[:0]])
    t = int(total)
    assert t == counts.sum()
    assert np.array_equal(np.asarray(oa)[:t], want_a)
    assert np.array_equal(np.asarray(ob)[:t], want_b)
    # same answer under jit (trace-level, static shapes)
    (ja,), jt = jax.jit(
        lambda x, c: partition.compact_prefix_slots((x,), c, slot))(
        jnp.asarray(a), jnp.asarray(counts))
    assert int(jt) == t and np.array_equal(np.asarray(ja)[:t], want_a)


def test_compact_prefix_slots_matches_compact_mask():
    # the layout contract: prefix-valid slots — both primitives agree
    rng = np.random.default_rng(2)
    slot, S = 8, 5
    counts = rng.integers(0, slot + 1, size=S).astype(np.int32)
    vals = rng.integers(0, 100, size=S * slot).astype(np.int32)
    mask = (np.arange(S * slot) % slot) < np.repeat(counts, slot)
    (want,), kept = partition.compact_mask(
        jnp.asarray(mask), (jnp.asarray(vals),))
    (got,), total = partition.compact_prefix_slots(
        (jnp.asarray(vals),), jnp.asarray(counts), slot)
    assert int(total) == int(kept)
    k = int(kept)
    assert np.array_equal(np.asarray(got)[:k], np.asarray(want)[:k])


# ------------------------------------------------------------------ filter

def test_filter_table():
    t = Table.from_numpy({
        "k": np.array([5, 2, 8, 1, 9, 3], np.uint32),
        "v": np.arange(6, dtype=np.int32),
    })
    out = filt.filter_expr(t, "k", "ge", 5)
    res = out.to_numpy()
    assert np.array_equal(res["k"], [5, 8, 9])
    assert np.array_equal(res["v"], [0, 2, 4])


def test_filter_respects_existing_padding():
    t = Table({"k": jnp.asarray(np.array([1, 2, 3, 99], np.uint32))},
              num_rows=3)
    out = filt.filter_expr(t, "k", "ge", 2)
    assert np.array_equal(out.to_numpy()["k"], [2, 3])  # 99 is padding


def test_filter_under_jit():
    t = Table.from_numpy({"k": np.arange(100, dtype=np.uint32)})

    @jax.jit
    def f(tbl):
        return filt.filter_expr(tbl, "k", "lt", 10)

    out = f(t)
    assert np.array_equal(out.to_numpy()["k"], np.arange(10))


# --------------------------------------------------------------- aggregate

def test_hash_aggregate_count_sum():
    keys = np.array([3, 1, 3, 1, 3, 7], np.uint32)
    vals = np.array([10, 20, 30, 40, 50, 60], np.int32)
    t = Table.from_numpy({"g": keys, "x": vals})
    out = aggregate.hash_aggregate(
        t, "g", {"n": ("count", None), "sx": ("sum", "x"),
                 "mn": ("min", "x"), "mx": ("max", "x")})
    res = out.to_numpy()
    assert np.array_equal(res["g"], [1, 3, 7])
    assert np.array_equal(res["n"], [2, 3, 1])
    assert np.array_equal(res["sx"], [60, 90, 60])
    assert np.array_equal(res["mn"], [20, 10, 60])
    assert np.array_equal(res["mx"], [40, 50, 60])


def test_hash_aggregate_signed_keys_and_padding():
    t = Table({"g": jnp.asarray(np.array([-5, 2, -5, 2, 123], np.int32)),
               "x": jnp.asarray(np.array([1., 2., 3., 4., 99.], np.float32))},
              num_rows=4)
    out = aggregate.hash_aggregate(t, "g", {"s": ("sum", "x"),
                                            "m": ("mean", "x")})
    res = out.to_numpy()
    assert np.array_equal(res["g"], [-5, 2])
    assert np.allclose(res["s"], [4.0, 6.0])
    assert np.allclose(res["m"], [2.0, 3.0])


def test_hash_aggregate_random_against_numpy():
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 50, size=3000).astype(np.uint32)
    vals = rng.integers(-100, 100, size=3000).astype(np.int32)
    t = Table.from_numpy({"g": keys, "x": vals})
    out = aggregate.hash_aggregate(t, "g", {"n": ("count", None),
                                            "s": ("sum", "x")})
    res = out.to_numpy()
    uk = np.unique(keys)
    assert np.array_equal(res["g"], uk)
    exp_n = np.array([(keys == k).sum() for k in uk])
    exp_s = np.array([vals[keys == k].sum() for k in uk])
    assert np.array_equal(res["n"], exp_n)
    assert np.array_equal(res["s"], exp_s)


def test_hash_aggregate_all_distinct_full_capacity():
    keys = np.arange(64, dtype=np.uint32)[::-1].copy()
    t = Table.from_numpy({"g": keys})
    out = aggregate.hash_aggregate(t, "g", {"n": ("count", None)})
    res = out.to_numpy()
    assert np.array_equal(res["g"], np.arange(64))
    assert np.all(res["n"] == 1)


# -------------------------------------------------------------------- join

def test_hash_join_unique_build():
    probe = Table.from_numpy({
        "k": np.array([2, 5, 7, 5, 100], np.uint32),
        "pv": np.arange(5, dtype=np.int32),
    })
    build = Table.from_numpy({
        "k": np.array([5, 2, 9], np.uint32),
        "bv": np.array([50, 20, 90], np.int32),
    })
    out, stats = join.hash_join(probe, build, "k")
    res = out.to_numpy()
    assert int(stats["match_count"]) == 3
    assert not bool(stats["overflow"])
    # order: probe order preserved (stable compaction)
    assert np.array_equal(res["k"], [2, 5, 5])
    assert np.array_equal(res["pv"], [0, 1, 3])
    assert np.array_equal(res["bv"], [20, 50, 50])


def test_hash_join_duplicate_build_keys():
    probe = Table.from_numpy({"k": np.array([1, 2], np.uint32)})
    build = Table.from_numpy({
        "k": np.array([2, 1, 2], np.uint32),
        "bv": np.array([200, 100, 201], np.int32),
    })
    out, stats = join.hash_join(probe, build, "k", max_duplicates=2)
    res = out.to_numpy()
    assert int(stats["match_count"]) == 3
    got = sorted(zip(res["k"].tolist(), res["bv"].tolist()))
    assert got == [(1, 100), (2, 200), (2, 201)]


def test_hash_join_duplicate_overflow_flagged():
    probe = Table.from_numpy({"k": np.array([1], np.uint32)})
    build = Table.from_numpy({"k": np.array([1, 1, 1], np.uint32),
                              "bv": np.arange(3, dtype=np.int32)})
    _, stats = join.hash_join(probe, build, "k", max_duplicates=2)
    assert bool(stats["overflow"])


def test_hash_join_signed_keys():
    probe = Table.from_numpy({"k": np.array([-3, 0, 7], np.int32)})
    build = Table.from_numpy({"k": np.array([0, -3], np.int32),
                              "bv": np.array([10, 30], np.int32)})
    out, stats = join.hash_join(probe, build, "k")
    res = out.to_numpy()
    assert int(stats["match_count"]) == 2
    assert np.array_equal(res["k"], [-3, 0])
    assert np.array_equal(res["bv"], [30, 10])


def test_hash_join_respects_padding():
    probe = Table({"k": jnp.asarray(np.array([1, 2, 3], np.uint32))},
                  num_rows=2)
    build = Table({"k": jnp.asarray(np.array([3, 1, 9], np.uint32)),
                   "bv": jnp.asarray(np.array([33, 11, 99], np.int32))},
                  num_rows=2)
    out, stats = join.hash_join(probe, build, "k")
    res = out.to_numpy()
    # probe row 3 is padding; build row 9 is padding → only key 1 matches.
    assert int(stats["match_count"]) == 1
    assert np.array_equal(res["k"], [1])
    assert np.array_equal(res["bv"], [11])


def test_hash_join_under_jit():
    probe = Table.from_numpy({"k": np.arange(32, dtype=np.uint32)})
    build = Table.from_numpy({"k": np.arange(0, 64, 2, dtype=np.uint32),
                              "bv": np.arange(0, 64, 2, dtype=np.int32)})

    @jax.jit
    def f(p, b):
        return join.hash_join(p, b, "k")

    out, stats = f(probe, build)
    res = out.to_numpy()
    assert int(stats["match_count"]) == 16
    assert np.array_equal(res["k"], np.arange(0, 32, 2))


def test_stable_partition_methods_agree():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 11, size=3000).astype(np.int32)
    vals = np.arange(3000, dtype=np.int32)
    a = partition.stable_partition(jnp.asarray(ids),
                                   (jnp.asarray(vals),), 11,
                                   method="sort")
    b = partition.stable_partition(jnp.asarray(ids),
                                   (jnp.asarray(vals),), 11,
                                   method="rank", block_elems=1024)
    assert np.array_equal(np.asarray(a[0][0]), np.asarray(b[0][0]))
    assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))
    assert np.array_equal(np.asarray(a[2]), np.asarray(b[2]))


def test_hash_aggregate_methods_agree():
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 30, size=2000).astype(np.int32)
    vals = rng.integers(-50, 50, size=2000).astype(np.int32)
    t = Table({"g": jnp.asarray(keys), "x": jnp.asarray(vals)},
              num_rows=1900)  # include padding rows
    aggs = {"n": ("count", None), "s": ("sum", "x"),
            "mn": ("min", "x"), "mx": ("max", "x"), "avg": ("mean", "x")}
    a = aggregate.hash_aggregate(t, "g", aggs, method="scan")
    b = aggregate.hash_aggregate(t, "g", aggs, method="segment")
    ra, rb = a.to_numpy(), b.to_numpy()
    assert int(a.num_rows) == int(b.num_rows)
    for col in ("g", "n", "s", "mn", "mx"):
        assert np.array_equal(ra[col], rb[col]), col
    assert np.allclose(ra["avg"], rb["avg"])


def test_hash_aggregate_max_keys_with_padding():
    # real keys equal to the dtype max + padding rows: group must not split
    # (regression for the unstable-sort interleaving edge case).
    mx = np.iinfo(np.uint32).max
    t = Table({"g": jnp.asarray(np.array([mx, 5, mx, 5, mx, 0, 0],
                                         np.uint32)),
               "x": jnp.asarray(np.arange(7, dtype=np.int32))},
              num_rows=5)
    out = aggregate.hash_aggregate(t, "g", {"n": ("count", None),
                                            "s": ("sum", "x")})
    res = out.to_numpy()
    assert np.array_equal(res["g"], [5, mx])
    assert np.array_equal(res["n"], [2, 3])
    assert np.array_equal(res["s"], [4, 0 + 2 + 4])


# --- regressions from the round-1 code review --------------------------------

def test_join_expand_no_duplicate_at_build_end():
    build = Table.from_numpy({"k": np.array([1, 2, 3], np.uint32),
                              "bv": np.array([10, 20, 30], np.int32)})
    probe = Table.from_numpy({"k": np.array([3], np.uint32)})
    out, stats = join.hash_join(probe, build, "k", max_duplicates=2)
    assert int(stats["match_count"]) == 1
    res = out.to_numpy()
    assert np.array_equal(res["k"], [3])
    assert np.array_equal(res["bv"], [30])


def test_join_expand_sentinel_key_vs_padding():
    mx = np.iinfo(np.uint32).max
    build = Table({"k": jnp.asarray(np.array([1, 2, 0, 0], np.uint32)),
                   "bv": jnp.asarray(np.array([10, 20, 0, 0], np.int32))},
                  num_rows=2)
    probe = Table.from_numpy({"k": np.array([mx], np.uint32)})
    out, stats = join.hash_join(probe, build, "k", max_duplicates=2)
    assert int(stats["match_count"]) == 0


def test_join_merge_sentinel_key_matches_real_max_only():
    mx = np.iinfo(np.uint32).max
    build = Table({"k": jnp.asarray(np.array([mx, 2, 0], np.uint32)),
                   "bv": jnp.asarray(np.array([99, 20, 0], np.int32))},
                  num_rows=2)
    probe = Table.from_numpy({"k": np.array([mx], np.uint32)})
    out, stats = join.hash_join(probe, build, "k")
    assert int(stats["match_count"]) == 1
    assert np.array_equal(out.to_numpy()["bv"], [99])


def test_join_merge_duplicate_build_flags_overflow_and_keeps_first():
    build = Table.from_numpy({"k": np.array([5, 5], np.uint32),
                              "bv": np.array([100, 101], np.int32)})
    probe = Table.from_numpy({"k": np.array([5], np.uint32)})
    out, stats = join.hash_join(probe, build, "k", max_duplicates=1)
    assert bool(stats["overflow"])  # duplicate run under max_duplicates=1
    res = out.to_numpy()
    assert np.array_equal(res["bv"], [100])  # FIRST duplicate, like expand


def test_join_randomized_vs_numpy():
    # fixed capacities (variable num_rows) so all trials share one compile
    rng = np.random.default_rng(123)
    CAP_B, CAP_P = 40, 60
    for trial in range(20):
        nb = int(rng.integers(1, CAP_B))
        npb = int(rng.integers(1, CAP_P))
        bk = rng.choice(np.arange(50, dtype=np.uint32), nb, replace=False)
        pk = rng.integers(0, 50, npb).astype(np.uint32)
        build = Table({"k": jnp.asarray(np.resize(bk, CAP_B)),
                       "bv": jnp.asarray(np.resize(bk.astype(np.int32) * 3,
                                                   CAP_B))}, num_rows=nb)
        probe = Table({"k": jnp.asarray(np.resize(pk, CAP_P))},
                      num_rows=npb)
        out, stats = join.hash_join(probe, build, "k")
        res = out.to_numpy()
        exp = int(np.isin(pk, bk).sum())
        assert int(stats["match_count"]) == exp, trial
        assert not bool(stats["overflow"])
        assert np.array_equal(np.sort(res["k"]),
                              np.sort(pk[np.isin(pk, bk)])), trial
        assert np.array_equal(res["bv"], res["k"].astype(np.int32) * 3)


def test_join_expand_randomized_duplicates_vs_numpy():
    rng = np.random.default_rng(321)
    CAP_B, CAP_P = 30, 40
    for trial in range(15):
        nb = int(rng.integers(2, CAP_B))
        npb = int(rng.integers(1, CAP_P))
        bk = rng.integers(0, 12, nb).astype(np.uint32)
        # cap duplicates at 4 to stay within max_duplicates
        vals, counts = np.unique(bk, return_counts=True)
        while counts.max() > 4:
            bk = rng.integers(0, 12, nb).astype(np.uint32)
            vals, counts = np.unique(bk, return_counts=True)
        pk = rng.integers(0, 12, npb).astype(np.uint32)
        build = Table({"k": jnp.asarray(np.resize(bk, CAP_B)),
                       "bv": jnp.asarray(np.resize(
                           np.arange(nb, dtype=np.int32), CAP_B))},
                      num_rows=nb)
        probe = Table({"k": jnp.asarray(np.resize(pk, CAP_P))},
                      num_rows=npb)
        out, stats = join.hash_join(probe, build, "k", max_duplicates=4)
        exp = sum(int((bk == k).sum()) for k in pk)
        assert int(stats["match_count"]) == exp, trial
        assert not bool(stats["overflow"]), trial
