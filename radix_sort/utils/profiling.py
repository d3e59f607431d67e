"""Profiling / observability utilities.

The reference's tracing is host-side CTimer bracketing with per-kernel
Statistics (SURVEY.md §5); the equivalents here are:

- :func:`trace` — context manager around ``jax.profiler`` emitting an XPlane
  trace viewable in TensorBoard/XProf (the real per-kernel timeline, which
  the reference's dormant MORE_PROFILING path only aspired to).
- :func:`chained_time` — seconds per call from a chained fori_loop
  repetition with a dependent device_get.
- :func:`roofline` — achieved bytes/s over the device's published HBM
  bandwidth (:data:`HBM_BYTES_PER_S`).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

# Published HBM bandwidth, bytes/s, keyed by ``jax.Device.device_kind``.
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: 80 GB HBM3 at
# 3.35 TB/s (rated at the full 700 W power limit).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device=None) -> float:
    """Published HBM bandwidth of ``device`` (default: the first device).
    A device kind missing from :data:`HBM_BYTES_PER_S` is an error."""
    import jax

    kind = (device or jax.devices()[0]).device_kind
    try:
        return HBM_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(
            f"no published HBM bandwidth for device kind {kind!r}; add it "
            f"to utils/profiling.HBM_BYTES_PER_S with its source") from None


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XProf trace of the enclosed device work."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def chained_time(fn, x, reps: int = 4, iters: int = 3,
                 warmup: int = 2) -> float:
    """Seconds per invocation of ``fn`` (an x→x device function)."""
    import jax

    def chained(r):
        return jax.jit(
            lambda a: jax.lax.fori_loop(0, r, lambda _, v: fn(v), a))

    f1, fr = chained(1), chained(reps)

    def sync(out):
        np.asarray(jax.tree.leaves(out)[0][:1])

    for _ in range(warmup):
        sync(f1(x))
        sync(fr(x))
    t1s, trs = [], []
    for _ in range(iters):
        t0 = time.perf_counter(); sync(f1(x)); t1s.append(time.perf_counter() - t0)
        t0 = time.perf_counter(); sync(fr(x)); trs.append(time.perf_counter() - t0)
    return max(1e-9, (min(trs) - min(t1s)) / (reps - 1))


def roofline(bytes_moved: int, seconds: float, device=None) -> float:
    """Fraction of the device's published HBM bandwidth achieved."""
    return (bytes_moved / seconds) / hbm_bytes_per_s(device)


def sort_min_bytes(n: int, key_dtype, bits_per_pass: int = 8,
                   payload_bytes: int = 0) -> int:
    """Speed-of-light traffic for an LSD radix sort: one read + one write of
    keys (+ payload) per pass, plus a digit-read for the histogram pass."""
    kb = np.dtype(key_dtype).itemsize
    passes = (kb * 8) // bits_per_pass
    row = kb + payload_bytes
    return passes * n * (2 * row + kb)
