"""D=1 distributed-overhead measurement.

The distributed layer's per-device overhead, measured on one device: run
the FULL dist_sort shard program (splitter sampling, destination
assignment with tie spreading, stable partition, packed all_to_all on a
1-device mesh, validity-first local sort, dense rebalance exchange) against
the plain single-chip sort_kv on the same data, chained timing, same chip.

The difference bounds the shuffle layer's per-chip cost; with D>1 the
all_to_all legs additionally cross the device links, so
   t_dist(D) ≈ t_local_sort + t_overhead(D=1) + t_wire(D)
is the weak-scaling model this number anchors.

Usage:  python scripts/dist_overhead_probe.py [log2n=25] [overlap_chunks=2]
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    log2n = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    G = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    n = 1 << log2n

    import jax

    if os.environ.get("RST_FORCE_CPU"):
        # simulated CPU mesh: numbers are shape-only but validate the
        # overlapped path
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device"
                                     "_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from radix_sort import sort_kv
    from radix_sort.config import DEFAULT_CONFIG
    from radix_sort.parallel import dist_sort, mesh as mesh_lib
    from radix_sort import datasets_device

    mesh = mesh_lib.make_mesh(1)
    axis = mesh_lib.DATA_AXIS
    print(f"# n=2^{log2n} overlap_chunks={G} backend={jax.default_backend()}",
          flush=True)

    keys = datasets_device.generate("RandomDistributed", np.uint32, n, seed=7)
    keys.block_until_ready()
    vals = jax.device_put(jnp.arange(n, dtype=jnp.int32))

    # full shard program, capacity = n (cannot overflow -> no host retry)
    fn = functools.partial(
        dist_sort._dist_sort_shard, D=1, axis=axis, capacity=n,
        samples=min(64 * G, n), config=DEFAULT_CONFIG, dense_capacity=n,
        overlap_chunks=G)
    spec = P(axis)
    shard = jax.shard_map(
        lambda k, v: fn(k, (v,)), mesh=mesh,
        in_specs=(spec, spec), out_specs=(spec, spec, P()))

    # vals rides every jit as an ARGUMENT, never a closure capture: a
    # captured device array is serialized into the compile request as a
    # literal (128 MB at 2^25 — the r4 "134 MB MLIR module" SIGKILL; 512
    # MB at 2^27 → HTTP 413).  See scripts/headline_probe.py.
    def dist_step(k, v):
        return shard(k, v)[0]

    def local_step(k, v):
        return sort_kv(k, v)[0]

    def timed(step, x, reps=8):
        chained = jax.jit(lambda a, v, r: jax.lax.fori_loop(
            0, r, lambda _, kk: step(kk, v), a))
        r1, rR = jnp.int32(1), jnp.int32(reps)

        def sync(o):
            np.asarray(o[:1])

        sync(chained(x, vals, r1)); sync(chained(x, vals, rR))
        t1 = tr = 1e9
        for _ in range(3):
            t0 = time.perf_counter(); sync(chained(x, vals, r1))
            t1 = min(t1, time.perf_counter() - t0)
            t0 = time.perf_counter(); sync(chained(x, vals, rR))
            tr = min(tr, time.perf_counter() - t0)
        return max(1e-9, (tr - t1) / (reps - 1))

    t_local = timed(local_step, keys)
    t_dist = timed(dist_step, keys)

    # validate the dist path output on-device (sorted + permutation proof)
    ko, vo, _ = jax.jit(lambda k, v: shard(k, v))(keys, vals)
    ok = bool(jax.jit(lambda ki, k, v: jnp.all(k[1:] >= k[:-1])
                      & jnp.all(jnp.take(ki, v) == k)
                      & (jnp.sum(v.astype(jnp.uint32))
                         == jnp.sum(jnp.arange(n, dtype=jnp.uint32))))(
        keys, ko, vo))

    res = {
        "n": n,
        "overlap_chunks": G,
        "local_sort_ms": round(t_local * 1e3, 3),
        "dist_D1_ms": round(t_dist * 1e3, 3),
        "overhead_ms": round((t_dist - t_local) * 1e3, 3),
        "overhead_pct": round(100 * (t_dist / t_local - 1), 1),
        "valid": ok,
    }
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
