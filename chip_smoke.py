#!/usr/bin/env python
"""Smoke run of the query engine on NVIDIA GPUs, at table sizes users run.

    python chip_smoke.py               # one card: phases a-c
    python chip_smoke.py --devices 4   # four cards: the distributed path only

One card:
  a. ``sort_kv`` of 2^27 u32 keys with an i32 payload (1 GiB resident),
     bit-exact against numpy's stable argsort; then ``sort`` of the five
     reference distributions at 2^24, u32 and u64, bit-exact against
     ``np.sort``.
  b. A ``Query`` of filter -> group_by -> sort_by over a 2^26-row
     lineitem-shaped table (about TPC-H SF10's 60M rows; 2^21 part keys as
     at SF10), against a numpy reference.
  c. A hash join of a 2^24-row probe with a 2^22-row build, then ``top_k``,
     against a numpy reference.

Four cards (``--devices 4``): ``dist_sort_kv``, ``dist_hash_aggregate`` and
``dist_hash_join`` over 2^26 rows per card with zipf-skewed keys and
``overlap_chunks=2``, against numpy; inputs are placed with
``mesh.shard_1d`` and every card's peak memory is printed.

Integer and ordering results must match bit for bit.  Float sums are
checked against a float64 host sum with relative tolerance
:data:`FLOAT_SUM_RTOL`, because the summation order differs.

Each phase prints its first-call wall time (compilation included), its
second-call wall time and the device's ``peak_bytes_in_use``: smoke times,
not benchmark results.  Then the card's name and power limit from
``nvidia-smi``, and as the last line one JSON object naming the device.
The script exits non-zero, printing no JSON, when JAX finds no GPU or when
any phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

SEED = 0
SORT_LOG2N = 27
DIST_LOG2N = 24
QUERY_LOG2N = 26
QUERY_GROUPS = 1 << 21
JOIN_PROBE_LOG2N = 24
JOIN_BUILD_LOG2N = 22
TOP_K = 1000
DIST_LOG2N_PER_DEVICE = 26
DIST_KEYS = 4096
# f32 sums of ~20 values per group; the order of summation differs from
# the host's float64 sum, so this bounds rounding, not a wrong answer.
FLOAT_SUM_RTOL = 1e-5
SMOKE_NOTE = "smoke times, not benchmark results"


class SmokeFailure(AssertionError):
    """A phase's result disagreed with its numpy reference."""


def expect(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def require_gpu(count: int = 1):
    """The first ``count`` JAX devices; exits unless they are GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
                         f"platform {devices[0].platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke.py --devices {count}: JAX sees only "
                         f"{len(devices)} device(s)")
    return devices[:count]


def peak_bytes(devices) -> list:
    """``peak_bytes_in_use`` per device (None where the backend keeps no
    memory statistics, as the CPU does)."""
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devices]


def timed_twice(fn, *args):
    """(result, first-call seconds, second-call seconds), each call ended
    by ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, first, time.perf_counter() - t0


def _record(phase: str, what: str, first: float, second: float) -> dict:
    return {"phase": phase, "what": what, "first_call_s": first,
            "second_call_s": second}


# ---- phase a: sorts ------------------------------------------------------

def phase_sort_kv(log2n: int = SORT_LOG2N, seed: int = SEED) -> dict:
    """Stable u32/i32 ``sort_kv`` against numpy's stable argsort."""
    import jax
    import jax.numpy as jnp

    import radix_sort as rst
    from radix_sort import datasets_device

    n = 1 << log2n
    keys = datasets_device.generate("RandomDistributed", np.uint32, n, seed)
    vals = jnp.arange(n, dtype=jnp.int32)
    (out_k, out_v), first, second = timed_twice(
        jax.jit(rst.sort_kv), keys, vals)
    host = np.asarray(keys)
    perm = np.argsort(host, kind="stable")
    expect(np.array_equal(np.asarray(out_v), perm.astype(np.int32)),
           f"sort_kv 2^{log2n}: payload is not the stable argsort")
    expect(np.array_equal(np.asarray(out_k), host[perm]),
           f"sort_kv 2^{log2n}: keys differ from numpy")
    return _record("a", f"sort_kv u32 keys + i32 payload, n=2^{log2n}",
                   first, second)


def phase_distributions(log2n: int = DIST_LOG2N, seed: int = SEED) -> list:
    """Key-only ``sort`` of the five reference distributions, u32 and u64,
    against ``np.sort``."""
    import jax
    import jax.numpy as jnp

    import radix_sort as rst
    from radix_sort import datasets

    n = 1 << log2n
    records = []
    for dt in (np.uint32, np.uint64):
        fn = jax.jit(rst.sort)
        for ds in datasets.make_datasets(dt, seed=seed):
            data = ds.generate(n)
            out, first, second = timed_twice(fn, jnp.asarray(data))
            expect(np.array_equal(np.asarray(out), np.sort(data)),
                   f"sort {np.dtype(dt).name} {ds.name} 2^{log2n}: "
                   f"differs from np.sort")
            records.append(_record(
                "a", f"sort {np.dtype(dt).name} {ds.name}, n=2^{log2n}",
                first, second))
    return records


# ---- phase b: filter -> group_by -> sort_by ------------------------------

def make_lineitem(n: int, groups: int, seed: int = SEED):
    """A lineitem-shaped table generated on the device: part key, extended
    price (f32), quantity 1-50 and discount 0-10 (hundredths)."""
    import jax
    import jax.numpy as jnp

    from radix_sort.table import Table

    @jax.jit
    def gen(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return {
            "l_partkey": jax.random.randint(k1, (n,), 0, groups, jnp.int32),
            "l_extendedprice": jax.random.uniform(
                k2, (n,), jnp.float32, 900.0, 105000.0),
            "l_quantity": jax.random.randint(k3, (n,), 1, 51, jnp.int32),
            "l_discount": jax.random.randint(k4, (n,), 0, 11, jnp.int32),
        }

    return Table(gen(jax.random.key(seed)))


def lineitem_query(table):
    """SELECT l_partkey, count(*), sum(l_extendedprice), max(l_quantity)
    WHERE l_discount <= 5 GROUP BY l_partkey ORDER BY count DESC."""
    from radix_sort.query import Query

    return (Query(table)
            .filter("l_discount", "le", 5)
            .group_by("l_partkey", n=("count", None),
                      revenue=("sum", "l_extendedprice"),
                      max_qty=("max", "l_quantity"))
            .sort_by("n", descending=True)
            .collect())


def lineitem_reference(cols: dict, groups: int) -> dict:
    """numpy twin of :func:`lineitem_query`; ties in the count keep
    ascending part-key order (the group-by's order, kept by a stable
    sort)."""
    keep = cols["l_discount"] <= 5
    pk = cols["l_partkey"][keep]
    counts = np.bincount(pk, minlength=groups)
    present = np.flatnonzero(counts)
    revenue = np.bincount(pk, weights=cols["l_extendedprice"][keep]
                          .astype(np.float64), minlength=groups)[present]
    order = np.argsort(pk, kind="stable")
    run_starts = np.flatnonzero(np.r_[True, np.diff(pk[order]) != 0])
    max_qty = np.maximum.reduceat(cols["l_quantity"][keep][order],
                                  run_starts)
    by_count = np.argsort(-counts[present], kind="stable")
    return {"l_partkey": present[by_count].astype(np.int32),
            "n": counts[present][by_count].astype(np.int32),
            "revenue": revenue[by_count],
            "max_qty": max_qty[by_count]}


def phase_query(log2n: int = QUERY_LOG2N, groups: int = QUERY_GROUPS,
                seed: int = SEED) -> dict:
    import jax

    table = make_lineitem(1 << log2n, groups, seed)
    out, first, second = timed_twice(jax.jit(lineitem_query), table)
    got = out.to_numpy()
    exp = lineitem_reference(table.to_numpy(), groups)
    for col in ("l_partkey", "n", "max_qty"):
        expect(np.array_equal(got[col], exp[col]),
               f"query 2^{log2n}: column {col} differs from numpy")
    expect(np.allclose(got["revenue"], exp["revenue"], rtol=FLOAT_SUM_RTOL,
                       atol=0.0),
           f"query 2^{log2n}: revenue beyond rtol {FLOAT_SUM_RTOL}")
    return _record("b", f"filter -> group_by -> sort_by, n=2^{log2n}, "
                        f"{groups} groups", first, second)


# ---- phase c: hash join -> top_k -----------------------------------------

def make_join_tables(log2_probe: int, log2_build: int, seed: int = SEED):
    """Build: unique even keys with a payload.  Probe: keys uniform over
    twice the build's key range (about half match) and a unique row id."""
    import jax
    import jax.numpy as jnp

    from radix_sort.table import Table

    nb, np_ = 1 << log2_build, 1 << log2_probe

    @jax.jit
    def gen(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        build = {"k": 2 * jax.random.permutation(k1, nb).astype(jnp.int32),
                 "bv": jax.random.randint(k2, (nb,), 0, 1 << 30, jnp.int32)}
        probe = {"k": jax.random.randint(k3, (np_,), 0, 2 * nb, jnp.int32),
                 "pv": jax.random.permutation(k4, np_).astype(jnp.int32)}
        return probe, build

    probe, build = gen(jax.random.key(seed))
    return Table(probe), Table(build)


def join_top_k(probe, build, k: int = TOP_K):
    """probe JOIN build ON k, then ORDER BY pv DESC LIMIT k."""
    from radix_sort.query import Query

    q = Query(probe).join(build, on="k")
    joined = q.collect()
    top = Query(joined).top_k("pv", k).collect()
    return joined, q.last_stats["join"], top


def phase_join(log2_probe: int = JOIN_PROBE_LOG2N,
               log2_build: int = JOIN_BUILD_LOG2N, k: int = TOP_K,
               seed: int = SEED) -> dict:
    import functools

    import jax

    probe, build = make_join_tables(log2_probe, log2_build, seed)
    (joined, stats, top), first, second = timed_twice(
        jax.jit(functools.partial(join_top_k, k=k)), probe, build)
    p, b = probe.to_numpy(), build.to_numpy()
    border = np.argsort(b["k"])
    pos = np.minimum(np.searchsorted(b["k"][border], p["k"]),
                     b["k"].size - 1)
    hit = b["k"][border][pos] == p["k"]
    expect(int(stats["match_count"]) == int(hit.sum())
           and not bool(stats["overflow"]),
           f"join: match_count {int(stats['match_count'])} != "
           f"{int(hit.sum())} or overflow")
    # pv is a unique row id: order both sides by it and compare every row
    rows = np.flatnonzero(hit)
    rows = rows[np.argsort(p["pv"][rows])]
    exp = {"k": p["k"][rows], "pv": p["pv"][rows], "k_r": p["k"][rows],
           "bv": b["bv"][border][pos[rows]]}
    got = joined.to_numpy()
    by_pv = np.argsort(got["pv"])
    for col, want in exp.items():
        expect(np.array_equal(got[col][by_pv], want),
               f"join: column {col} differs from numpy")
    got_top = top.to_numpy()
    for col, want in exp.items():
        expect(np.array_equal(got_top[col], want[::-1][:k]),
               f"top_k: column {col} differs from numpy")
    return _record("c", f"hash join probe 2^{log2_probe} x build "
                        f"2^{log2_build}, then top_k {k}", first, second)


# ---- four cards: the distributed path ------------------------------------

def zipf_keys(n: int, seed: int = SEED) -> np.ndarray:
    """Zipf(1.3) keys folded into [0, DIST_KEYS): the skew of
    scripts/baseline_configs.py config5 at full size.  Chunks are drawn
    from independent streams in threads (numpy samples without the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    chunks = 16
    sizes = [n // chunks + (i < n % chunks) for i in range(chunks)]
    streams = np.random.SeedSequence(seed).spawn(chunks)

    def draw(i):
        z = np.random.default_rng(streams[i]).zipf(1.3, sizes[i])
        return (z % DIST_KEYS).astype(np.uint32)

    with ThreadPoolExecutor(chunks) as pool:
        return np.concatenate(list(pool.map(draw, range(chunks))))


def _check_sharded(arr, devices) -> None:
    shards = arr.addressable_shards
    expect(sorted(s.device.id for s in shards)
           == sorted(d.id for d in devices)
           and all(s.data.shape[0] * len(devices) == arr.shape[0]
                   for s in shards),
           "input is not split evenly over the mesh's devices")


def phase_distributed(devices, log2_per_device: int = DIST_LOG2N_PER_DEVICE,
                      seed: int = SEED) -> list:
    """dist_sort_kv, dist_hash_aggregate and dist_hash_join over a 1-D mesh
    of ``devices`` on zipf-skewed keys, each against numpy."""
    from radix_sort.parallel import dist_ops, dist_sort, mesh as mesh_lib
    from radix_sort.table import Table

    D = len(devices)
    mesh = mesh_lib.make_mesh(D)
    n = D << log2_per_device
    pk = zipf_keys(n, seed)
    pv = np.arange(n, dtype=np.int32)
    keys, vals = mesh_lib.shard_1d(pk, mesh), mesh_lib.shard_1d(pv, mesh)
    _check_sharded(keys, devices)
    _check_sharded(vals, devices)
    in_use = [(d.memory_stats() or {}).get("bytes_in_use") for d in devices]
    print(f"[dist] bytes_in_use per device after placing the inputs: "
          f"{in_use}", flush=True)
    if None not in in_use:
        expect(max(in_use) <= 2 * min(in_use),
               f"inputs are not spread over the devices: {in_use}")
    # keys < 2^16, so numpy's stable sort is a radix sort here
    perm = np.argsort(pk.astype(np.uint16), kind="stable")
    what = f"{D} devices x 2^{log2_per_device} rows, zipf keys"
    records = []

    (ks, vs, over), first, second = timed_twice(
        lambda: dist_sort.dist_sort_kv(keys, vals, mesh=mesh,
                                       overlap_chunks=2))
    expect(not bool(over), "dist_sort_kv: shuffle overflow")
    expect(np.array_equal(np.asarray(ks), pk[perm])
           and np.array_equal(np.asarray(vs), perm.astype(np.int32)),
           "dist_sort_kv differs from numpy's stable sort")
    records.append(_record("dist", f"dist_sort_kv, {what}", first, second))

    table = Table({"k": keys, "v": vals})
    (agg, over), first, second = timed_twice(
        lambda: dist_ops.dist_hash_aggregate(
            table, "k", {"n": ("count", None), "s": ("sum", "v")},
            mesh=mesh, overlap_chunks=2))
    expect(not bool(over), "dist_hash_aggregate: overflow")
    got = agg.to_numpy()
    order = np.argsort(got["k"])
    counts = np.bincount(pk, minlength=DIST_KEYS)
    present = np.flatnonzero(counts)
    starts = np.r_[0, np.cumsum(counts[present])[:-1]]
    # int32 sums wrap on the device; compare modulo 2^32
    sums = np.add.reduceat(pv[perm].astype(np.int64), starts).astype(
        np.int32)
    expect(np.array_equal(got["k"][order], present.astype(np.uint32))
           and np.array_equal(got["n"][order], counts[present])
           and np.array_equal(got["s"][order], sums),
           "dist_hash_aggregate differs from numpy")
    records.append(_record("dist", f"dist_hash_aggregate, {what}", first,
                           second))

    bk = np.arange(DIST_KEYS, dtype=np.uint32)
    build = Table({"k": mesh_lib.shard_1d(bk, mesh),
                   "bv": mesh_lib.shard_1d((bk * 7).astype(np.int32), mesh)})
    probe = Table({"k": keys, "pv": vals})
    (joined, stats), first, second = timed_twice(
        lambda: dist_ops.dist_hash_join(probe, build, "k", mesh=mesh,
                                        overlap_chunks=2))
    expect(int(stats["match_count"]) == n and not bool(stats["overflow"]),
           f"dist_hash_join: match_count {int(stats['match_count'])} != "
           f"{n} or overflow")
    got = joined.to_numpy()
    # every probe row exactly once (pv is the row id), with its own key and
    # its build row's payload
    expect(got["pv"].size == n
           and np.all(np.bincount(got["pv"], minlength=n) == 1)
           and np.array_equal(got["k"], pk[got["pv"]])
           and np.array_equal(got["bv"], (got["k"] * 7).astype(np.int32)),
           "dist_hash_join differs from numpy")
    records.append(_record("dist", f"dist_hash_join, {what}", first,
                           second))
    return records


# ---- driver --------------------------------------------------------------

def _print_record(rec: dict, devices) -> None:
    peaks = peak_bytes(devices)
    print(f"[{rec['phase']}] {rec['what']}: first call (compile included) "
          f"{rec['first_call_s']:.3f} s, second call "
          f"{rec['second_call_s']:.3f} s, peak_bytes_in_use "
          f"{peaks if len(peaks) > 1 else peaks[0]} ({SMOKE_NOTE})",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4 runs only the distributed path, over four cards")
    args = ap.parse_args(argv)

    devices = require_gpu(args.devices)

    import jax

    from radix_sort.parallel.runtime import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)  # u64 keys in phase a

    if args.devices == 1:
        phases = [phase_sort_kv, phase_distributions, phase_query,
                  phase_join]
    else:
        phases = [lambda: phase_distributed(devices)]
    for phase in phases:
        out = phase()
        for rec in out if isinstance(out, list) else [out]:
            _print_record(rec, devices)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
