"""Weak-scaling harness for the distributed sort (BASELINE.json: ≥85%
weak-scaling efficiency at 2+ hosts).

Keeps per-device rows constant and sweeps mesh sizes, reporting wall time
and efficiency vs the smallest mesh.  Run with RST_FORCE_CPU_MESH=1 to
exercise the harness on the simulated CPU mesh (a functional check only:
CPU "links" are shared memory, so its efficiency numbers mean nothing).

  RST_FORCE_CPU_MESH=1 python scripts/scaling_bench.py --rows-per-dev 16384

Use ``--device-count 64 --mesh-sizes 64`` (with RST_FORCE_CPU_MESH=1) to
check that the distributed layer traces + validates well past toy meshes
(the tie-spreading and send-pack are O(1) trace size in D).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-dev", type=int, default=1 << 14)
    ap.add_argument("--mesh-sizes", default="")
    ap.add_argument("--device-count", type=int, default=8,
                    help="virtual CPU device count under RST_FORCE_CPU_MESH")
    ap.add_argument("--check-ops", action="store_true",
                    help="also trace + validate the distributed hash "
                         "aggregate and hash join at each mesh size (the "
                         "whole dist layer past toy meshes, not just sort)")
    args = ap.parse_args()

    import jax

    if os.environ.get("RST_FORCE_CPU_MESH"):
        # assign, don't setdefault: a pre-set XLA_FLAGS (e.g. a dump flag)
        # must not silently discard the device-count flag
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
              f"{args.device_count}").strip()
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from radix_sort.parallel import dist_ops, dist_sort, mesh as mesh_lib
    from radix_sort.table import Table

    def check_ops(mesh, D, rows):
        """dist aggregate + join traced and validated vs numpy at mesh size
        D (row count scales with D like the sort check)."""
        rng = np.random.default_rng(D)
        n = D * rows
        gk = rng.integers(0, max(4, n // 64), size=n).astype(np.uint32)
        xs = rng.integers(-100, 100, size=n).astype(np.int32)
        t = Table.from_numpy({"g": gk, "x": xs})
        out, ovf = dist_ops.dist_hash_aggregate(
            t, "g", {"n": ("count", None), "s": ("sum", "x")}, mesh=mesh)
        res = out.to_numpy()
        order = np.argsort(res["g"], kind="stable")
        uk, inv = np.unique(gk, return_inverse=True)
        agg_ok = (np.array_equal(res["g"][order], uk)
                  and np.array_equal(res["n"][order], np.bincount(inv))
                  and np.array_equal(res["s"][order],
                                     np.bincount(inv, weights=xs).astype(
                                         np.int64)))

        bk = np.arange(0, max(2, n // 128), 2, dtype=np.uint32)
        bcap = -(-bk.size // D) * D  # pad to a mesh multiple; tail masked
        build = Table(
            {"k": jnp.asarray(np.concatenate(
                [bk, np.zeros(bcap - bk.size, np.uint32)])),
             "bv": jnp.asarray(np.concatenate(
                 [bk.astype(np.int32) * 3,
                  np.zeros(bcap - bk.size, np.int32)]))},
            num_rows=bk.size)
        pk = rng.integers(0, bk.size * 2, size=n).astype(np.uint32)
        probe = Table.from_numpy(
            {"k": pk, "pv": np.arange(n, dtype=np.int32)})
        jout, stats = dist_ops.dist_hash_join(probe, build, "k", mesh=mesh)
        jres = jout.to_numpy()
        exp_matches = int(np.isin(pk, bk).sum())
        join_ok = (int(stats["match_count"]) == exp_matches
                   and jres["k"].size == exp_matches
                   and np.array_equal(jres["bv"],
                                      jres["k"].astype(np.int32) * 3))
        return agg_ok, join_ok

    ndev = len(jax.devices())
    sizes = ([int(s) for s in args.mesh_sizes.split(",") if s]
             or [d for d in (1, 2, 4, 8) if d <= ndev])
    rows = args.rows_per_dev
    results = {}
    base = None
    for D in sizes:
        mesh = mesh_lib.make_mesh(D)
        n = D * rows
        rng = np.random.default_rng(0)
        keys = jnp.asarray(
            rng.integers(0, 1 << 32, size=n, dtype=np.uint32))
        # warm (compile)
        out = dist_sort.dist_sort(keys, mesh=mesh)
        out.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(3):
            out = dist_sort.dist_sort(keys, mesh=mesh)
            out.block_until_ready()
        wall = (time.perf_counter() - t0) / 3
        ok = bool(np.array_equal(np.asarray(out), np.sort(np.asarray(keys))))
        if base is None:
            base = wall
        eff = base / wall
        results[D] = {"rows": n, "wall_s": round(wall, 4),
                      "weak_scaling_eff": round(eff, 3), "valid": ok}
        if args.check_ops:
            agg_ok, join_ok = check_ops(mesh, D, max(64, rows // 16))
            results[D]["agg_valid"] = agg_ok
            results[D]["join_valid"] = join_ok
        print(f"D={D} rows={n} wall={wall*1e3:.1f} ms eff={eff:.2%} "
              f"valid={ok}"
              + (f" agg={results[D]['agg_valid']} "
                 f"join={results[D]['join_valid']}" if args.check_ops
                 else ""), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
