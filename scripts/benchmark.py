"""Benchmark sweep harness — parity with the reference's benchmark corpus
(SURVEY.md §2 #24: scripts/performance.ps1 sweeping n = 2^25..2^1 and
Performance/perfToOverallCSV.py aggregation), modernized:

  python scripts/benchmark.py --max-log2 25 --min-log2 10 \
      --datatypes u32,u64 --engine auto --perf-to-csv

Emits one CSV (reference schema + extra columns, utils/csvio.py) with one
row per (n, dtype, dataset) and prints a summary.  Runs on the default JAX
backend; timing subtracts a 1-sort chain from an R-sort chain.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-log2", type=int, default=16)
    ap.add_argument("--max-log2", type=int, default=25)
    ap.add_argument("--step", type=int, default=3)
    ap.add_argument("--datatypes", default="u32")
    ap.add_argument("--datasets", default="")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--cpu-baselines", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="time np.sort + native radix per row (reference "
                         "parity: CRadixSortTask.cpp:172-222 runs CPU "
                         "baselines on every row)")
    ap.add_argument("--phases", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="populate per-kernel columns (histogram/scan/"
                         "reorder) via the phase-split diagnostic path "
                         "(reference parity: RadixSortGPU.cpp:37-56); adds "
                         "3 compiles per (n, dtype)")
    ap.add_argument("--perf-to-csv", action="store_true")
    ap.add_argument("--perf-to-stdout", action="store_true")
    ap.add_argument("--csv-dir", default="Performance")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from radix_sort import datasets as ds_lib, dtypes as dt_lib, golden
    from radix_sort.config import SortConfig
    from radix_sort.ops import sort as sort_ops
    from radix_sort.utils import csvio, profiling
    from radix_sort.utils import native_baseline as nb

    dev_kind = jax.devices()[0].device_kind
    hbm = profiling.hbm_bytes_per_s()
    print(f"# device={dev_kind} hbm={hbm / 1e9:.0f} GB/s "
          f"engine={args.engine}", flush=True)

    name_to_np = {"u32": np.uint32, "i32": np.int32,
                  "u64": np.uint64, "i64": np.int64,
                  "f32": np.float32, "f64": np.float64}
    if args.datatypes in ("all", ""):
        dtype_names = ["u32", "i32", "u64", "i64"]
    else:
        dtype_names = [s for s in args.datatypes.split(",") if s]
    wanted_ds = {s for s in args.datasets.split(",") if s}

    from radix_sort import datasets_device

    cfg = SortConfig(engine=args.engine)
    rows = []
    # incremental CSV: long sweeps (hours with phases + CPU baselines) must
    # not lose every finished row to a timeout/crash at the tail
    csv_path = None
    if args.perf_to_csv:
        os.makedirs(args.csv_dir, exist_ok=True)
        csv_path = csvio.timestamped_path(args.csv_dir)

    def checkpoint_csv():
        if csv_path is not None and rows:
            csvio.write_csv(rows, path=csv_path)
    for logn in range(args.max_log2, args.min_log2 - 1, -args.step):
        n = 1 << logn
        for dname in dtype_names:
            dt = name_to_np[dname]
            if np.dtype(dt).itemsize == 8 and not jax.config.jax_enable_x64:
                jax.config.update("jax_enable_x64", True)

            # jit everything ONCE per (n, dtype): per-row lambdas (fresh
            # jit cache entries) would recompile for every row.
            sort_fn = lambda k: sort_ops.sort(k, config=cfg)  # noqa: E731
            # Scale reps with size so the extra (reps-1) sorts take >= ~50
            # ms.  reps is a RUNTIME argument — one compile serves every
            # rep count.
            est_sort_s = max(n * 1.6e-9, 2e-5)
            reps = int(min(4096, max(4, round(0.05 / est_sort_s) + 1)))
            chained = jax.jit(lambda a, r: jax.lax.fori_loop(
                0, r, lambda _, v: sort_fn(v), a))
            chain1 = lambda a: chained(a, jnp.int32(1))       # noqa: E731
            chainR = lambda a: chained(a, jnp.int32(reps))    # noqa: E731
            sorted_fn = jax.jit(sort_fn)
            uview = (jnp.uint32 if np.dtype(dt).itemsize == 4
                     else jnp.uint64)
            check_fn = jax.jit(lambda o, k: jnp.all(
                sort_ops.dtypes.to_sortable_unsigned(o)[1:]
                >= sort_ops.dtypes.to_sortable_unsigned(o)[:-1])
                & (jnp.sum(o.view(uview)) == jnp.sum(k.view(uview)))
                & (jnp.bitwise_xor.reduce(o.view(uview))
                   == jnp.bitwise_xor.reduce(k.view(uview))))
            # NB: bind the loop variable at definition time (nm=nm) — a bare
            # closure would make every lax.switch branch generate the LAST
            # distribution in ALL_NAMES, silently mislabeling the sweep.
            gen_fn = jax.jit(
                lambda name_idx, seed, _dt=dt, _n=n: jax.lax.switch(
                    name_idx,
                    [lambda s, nm=nm, d=_dt, m=_n:
                     datasets_device.generate(nm, d, m, seed=s)
                     for nm in datasets_device.ALL_NAMES],
                    seed))

            def sync(o):
                np.asarray(o[:1])

            # Phase-split fns (per-kernel columns).  The columns in a row
            # must decompose THAT row's engine (reference parity:
            # avgHistogram/Scan/Reorder bracket the kernels whose total is
            # avgTotalGPU, src/RadixSortGPU.cpp:37-56) — so phases are
            # populated ONLY for the xla_radix pipeline; xla_sort has no
            # radix phases and keeps the columns at 0.
            resolved_eng = sort_ops._dispatch_engine(cfg.engine)
            phase_chains = None
            phase_passes = (np.dtype(dt).itemsize * 8) // cfg.bits_per_pass
            if (args.phases and np.dtype(dt).kind in "iu"
                    and resolved_eng == "xla_radix"):
                from radix_sort.ops import ranking

                padded = cfg.padded_size(n)
                M = min(cfg.block_elems, padded)
                B = padded // M
                mask_v = cfg.radix - 1

                def _prep(k):
                    ku = sort_ops.dtypes.to_sortable_unsigned(k)
                    sent = sort_ops.dtypes._np_scalar(
                        np.dtype(ku.dtype),
                        sort_ops.dtypes.sentinel_max_unsigned(ku.dtype))
                    ku = sort_ops._pad_1d(ku, padded, sent)
                    d = (ku & sort_ops.dtypes._np_scalar(
                        np.dtype(ku.dtype), mask_v)).astype(jnp.int32)
                    return ku, d.reshape(B, M)

                def ph_hist(k):
                    _, d = _prep(k)
                    c = ranking.block_digit_counts(d, cfg.radix)
                    return k + c[0, 0].astype(k.dtype)

                def ph_scan(k):
                    _, d = _prep(k)
                    c = ranking.block_digit_counts(d, cfg.radix)
                    total = c.sum(axis=0)
                    base = (jnp.cumsum(total, 0) - total)[None, :] + (
                        jnp.cumsum(c, 0) - c)
                    return k + base[0, 0].astype(k.dtype)

                def ph_reorder(k):
                    ku, d = _prep(k)
                    dest, _, _ = ranking.stable_dest(
                        d, cfg.radix, sequential_blocks=B > 64)
                    out = ranking.apply_destinations(
                        dest.reshape(-1), (ku,))
                    return k + out[0][:n].astype(k.dtype)

                phase_chains = [
                    jax.jit(lambda a, r, f=f: jax.lax.fori_loop(
                        0, r, lambda _, v: f(v), a))
                    for f in (ph_hist, ph_scan, ph_reorder)]
            elif args.phases:
                print(f"# engine {resolved_eng} has no radix-phase "
                      "decomposition; per-kernel columns stay 0", flush=True)

            for ds_idx, ds_name in enumerate(datasets_device.ALL_NAMES):
                if wanted_ds and ds_name not in wanted_ds:
                    continue
                keys = gen_fn(ds_idx, 0)
                keys.block_until_ready()
                sync(chain1(keys)); sync(chainR(keys))  # warm
                t1 = tr = 1e9
                for _ in range(3):
                    t0 = time.perf_counter(); sync(chain1(keys))
                    t1 = min(t1, time.perf_counter() - t0)
                    t0 = time.perf_counter(); sync(chainR(keys))
                    tr = min(tr, time.perf_counter() - t0)
                secs = (tr - t1) / (reps - 1)
                if secs <= 1e-7:
                    # chained difference hit the floor (tiny inputs where
                    # dispatch dominates): report the single-run upper bound
                    # rather than a nonsense terakeys number.
                    secs = max(t1, 1e-9)
                ms = secs * 1e3
                mkeys = n / secs / 1e6

                # Per-kernel columns: time cumulative prefixes of the pass
                # pipeline (hist, hist+scan, hist+scan+reorder) for one pass
                # and scale by the pass count; differences give each stage.
                t_h = t_s = t_r = 0.0
                phase_keys = keys
                if phase_chains is not None:
                    cum = []
                    for ch in phase_chains:
                        sync(ch(phase_keys, jnp.int32(1)))
                        sync(ch(phase_keys, jnp.int32(reps)))
                        ta = tb = 1e9
                        for _ in range(2):
                            t0 = time.perf_counter()
                            sync(ch(phase_keys, jnp.int32(1)))
                            ta = min(ta, time.perf_counter() - t0)
                            t0 = time.perf_counter()
                            sync(ch(phase_keys, jnp.int32(reps)))
                            tb = min(tb, time.perf_counter() - t0)
                        cum.append(max((tb - ta) / (reps - 1), 0.0))
                    t_h = cum[0] * phase_passes * 1e3
                    t_s = max(cum[1] - cum[0], 0.0) * phase_passes * 1e3
                    t_r = max(cum[2] - cum[1], 0.0) * phase_passes * 1e3

                stl_ms = rdx_ms = 0.0
                # Above 2^22, CPU baselines time a host-twin regeneration
                # of the same distribution, and validation is the on-device
                # sortedness + multiset checksums.
                full_fetch = n <= (1 << 22)
                if full_fetch:
                    data = np.asarray(keys)
                else:
                    ds_obj = next(d for d in ds_lib.make_datasets(dt, seed=0)
                                  if d.name == ds_name)
                    data = ds_obj.generate(n)
                if args.cpu_baselines:
                    t0 = time.perf_counter()
                    golden.oracle_sort(data)
                    stl_ms = (time.perf_counter() - t0) * 1e3
                    if nb.available():
                        t0 = time.perf_counter()
                        nb.radix_sort(data)
                        rdx_ms = (time.perf_counter() - t0) * 1e3
                # Validation: on-device sortedness + multiset checksums, and
                # (when the data was fetched) a 2^18-prefix bit-exact check.
                out = sorted_fn(keys)
                ok_dev = check_fn(out, keys)
                prefix_ok = True
                if full_fetch:
                    m = min(n, 1 << 18)
                    prefix_ok = np.array_equal(np.asarray(out[:m]),
                                               golden.oracle_sort(data)[:m])
                valid = bool(ok_dev) and prefix_ok
                # minimum traffic: one read + one write of keys per pass
                passes = (np.dtype(dt).itemsize * 8) // cfg.bits_per_pass
                min_bytes = 2 * passes * n * np.dtype(dt).itemsize
                roof = (min_bytes / secs) / hbm
                row = csvio.PerfRow(
                    num_elements=n, datatype=dname, dataset=ds_name,
                    avg_histogram=t_h, avg_scan=t_s, avg_reorder=t_r,
                    avg_total_gpu=ms, avg_total_stl_cpu=stl_ms,
                    avg_total_rdx_cpu=rdx_ms, mkeys_per_sec=mkeys,
                    roofline_frac=roof,
                    engine=resolved_eng)
                rows.append(row)
                flag = "" if valid else "  !!INVALID"
                if roof > 1.0:
                    # implied bandwidth above the HBM roofline is physically
                    # impossible — timing noise survived the chained method.
                    flag += "  !!NOISY"
                print(f"2^{logn} {dname:4s} {ds_name:18s} {ms:9.3f} ms "
                      f"{mkeys:9.1f} Mkeys/s roof={roof:5.1%}{flag}",
                      flush=True)
                assert valid, f"validation failed: {dname} {ds_name} n={n}"
                checkpoint_csv()

    if args.perf_to_csv:
        checkpoint_csv()
        print(f"# wrote {csv_path}")
    if args.perf_to_stdout:
        csvio.write_rows(rows, sys.stdout)


if __name__ == "__main__":
    main()
