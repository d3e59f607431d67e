#!/usr/bin/env python
"""Time XLA's plain forms of the engine's two reorder jobs on a GPU, and read
from the optimized HLO which sorts XLA hands to CUB.

    python scripts/xla_paths.py [--reps 5] [--out chiprun_out/xla_paths.json]

1. Binary compaction (``partition.compact_mask``): ``method="sort"`` (one
   stable multi-operand ``lax.sort``) against ``method="rank"`` (cumsum rank
   and one scatter per plane), at 2^24 and 2^26 rows with 1 and 4 u32
   payload planes, half the rows kept.
2. u32 key-value sort at 2^27: ``engine="xla_sort"`` against
   ``engine="xla_radix"``, plus a key-only ``sort`` for the HLO comparison.

Each case is compiled once, warmed once, then timed ``--reps`` times in
turns with the case it is compared with; every call ends in
``block_until_ready``.  The two arms' outputs must be equal.  Prints one
line per case and the card's name and power limit; exits non-zero on any
platform other than a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def hlo_sorts(compiled) -> dict:
    """Counts of CUB sort custom calls and of XLA sort ops left in an
    optimized HLO module."""
    text = compiled.as_text()
    return {"cub_sort_calls": len(re.findall(r'custom_call_target="[^"]*cub[^"]*"',
                                             text, flags=re.IGNORECASE)),
            "xla_sort_ops": len(re.findall(r"[\s)}\]]sort\(", text))}


def time_pair(fa, fb, args, reps: int) -> tuple:
    """Median and min seconds of fa(*args) and fb(*args), timed in turns."""
    import jax

    ta, tb = [], []
    for _ in range(reps):
        for f, ts in ((fa, ta), (fb, tb)):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args))
            ts.append(time.perf_counter() - t0)
    return ((float(np.median(ta)), min(ta)), (float(np.median(tb)), min(tb)))


def compile_pair(fa, fb, args):
    ca = fa.lower(*args).compile()
    cb = fb.lower(*args).compile()
    return ca, cb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/xla_paths.json")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from radix_sort import datasets_device
    from radix_sort.ops import partition
    from radix_sort.ops.sort import sort, sort_kv
    from radix_sort.parallel.runtime import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"xla_paths.py measures a GPU; found {dev.platform!r}")
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = []

    def report(case, arm, med_min, hlo, n):
        med, best = med_min
        row = {"case": case, "arm": arm, "n": n, "median_ms": med * 1e3,
               "min_ms": best * 1e3, "rows_per_s": n / med, **hlo,
               "device": dev.device_kind, "nvidia_smi": smi}
        rows.append(row)
        print(json.dumps(row), flush=True)

    key = jax.random.key(0)
    for log2n in (24, 26):
        n = 1 << log2n
        for planes in (1, 4):
            k1, k2 = jax.random.split(jax.random.fold_in(key, log2n))
            mask = jax.random.bernoulli(k1, 0.5, (n,))
            arrays = tuple(jax.random.bits(k, (n,), jnp.uint32)
                           for k in jax.random.split(k2, planes))
            fs = {m: jax.jit(lambda mk, a, m=m: partition.compact_mask(
                mk, a, method=m)) for m in ("sort", "rank")}
            cs, cr = compile_pair(fs["sort"], fs["rank"], (mask, arrays))
            (os_, ks), (or_, kr) = cs(mask, arrays), cr(mask, arrays)
            kept = int(ks)
            if kept != int(kr) or not all(
                    bool(jnp.array_equal(a[:kept], b[:kept]))
                    for a, b in zip(os_, or_)):
                raise SystemExit(f"compaction 2^{log2n} x{planes}: sort "
                                 f"and rank disagree")
            ts, tr = time_pair(cs, cr, (mask, arrays), args.reps)
            case = f"compact_mask 2^{log2n} rows, {planes} u32 planes"
            report(case, "sort", ts, hlo_sorts(cs), n)
            report(case, "rank", tr, hlo_sorts(cr), n)
        del mask, arrays

    n = 1 << 27
    keys = datasets_device.generate("RandomDistributed", np.uint32, n, 1)
    vals = jnp.arange(n, dtype=jnp.int32)
    fx = jax.jit(lambda k, v: sort_kv(k, v, engine="xla_sort"))
    fr = jax.jit(lambda k, v: sort_kv(k, v, engine="xla_radix"))
    cx, cr = compile_pair(fx, fr, (keys, vals))
    ox, or_ = cx(keys, vals), cr(keys, vals)
    if not all(bool(jnp.array_equal(a, b)) for a, b in zip(ox, or_)):
        raise SystemExit("sort_kv 2^27: xla_sort and xla_radix disagree")
    del ox, or_
    tx, tr = time_pair(cx, cr, (keys, vals), args.reps)
    case = "sort_kv u32 keys + i32 payload 2^27"
    report(case, "xla_sort", tx, hlo_sorts(cx), n)
    report(case, "xla_radix", tr, hlo_sorts(cr), n)

    ck = jax.jit(sort).lower(keys).compile()
    t = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(ck(keys))
        t.append(time.perf_counter() - t0)
    report("sort u32 keys only 2^27", "xla_sort",
           (float(np.median(t)), min(t)), hlo_sorts(ck), n)

    print(f"nvidia-smi: {smi}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
