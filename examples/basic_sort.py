"""Canonical library consumer — the reference's basic_sort example
(examples/basic_sort/basic_sort.cpp:23-162) re-imagined for this engine.

The reference walks 7 explicit steps (dataset → buffers → initialize → pad →
upload → calculate → download → verify → print timings → release); here
the buffer/padding/transfer choreography lives inside one jitted call, so
the consumer surface is: dataset → device_put → sort → verify → timings.

Run: python examples/basic_sort.py [--num-elements N] [--engine E]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from radix_sort import sort_kv, golden
    from radix_sort.config import SortConfig
    from radix_sort.datasets import RandomDistributed
    from radix_sort.parallel.mesh import device_banner
    from radix_sort.parallel.runtime import enable_compile_cache
    from radix_sort.utils.cli import parse_options

    enable_compile_cache()

    opts = parse_options()
    n = min(opts.num_elements, 1 << 20) if opts.num_elements == 1 << 25 \
        else opts.num_elements
    print(device_banner())

    # 1. dataset (uniform with planted min/max, like the reference example)
    data = RandomDistributed(np.uint32, seed=42).generate(n)
    values = np.arange(n, dtype=np.int32)

    # 2. upload
    keys_dev = jax.device_put(jnp.asarray(data))
    vals_dev = jax.device_put(jnp.asarray(values))

    # 3. sort (key-value: the payload rides along)
    cfg = SortConfig(engine=opts.engine)
    fn = jax.jit(lambda k, v: sort_kv(k, v, config=cfg))
    out_k, out_v = fn(keys_dev, vals_dev)  # compile + run
    jax.block_until_ready((out_k, out_v))

    # median of repeated warm calls, each ended by block_until_ready
    samples = []
    for _ in range(9):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(keys_dev, vals_dev))
        samples.append(time.perf_counter() - t0)
    elapsed = float(np.median(samples))

    # 4. download + verify vs the std::sort-equivalent oracle
    host_k = np.asarray(out_k)
    host_v = np.asarray(out_v)
    expected = golden.oracle_sort(data)
    perm = golden.oracle_argsort(data)
    ok = golden.validate_bit_exact(host_k, expected, n) and \
        np.array_equal(host_v, perm.astype(np.int32))

    # 5. report
    print(f"sorted {n} u32 key-value pairs in {elapsed*1e3:.3f} ms "
          f"({n/elapsed/1e6:.1f} Mkeys/s, median of {len(samples)}, "
          f"{jax.devices()[0].device_kind})")
    print("validation:", "OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
