"""Timing statistics and runtime aggregation.

Parity with the reference's measurement layer:

- ``CTimer`` (``Common/CTimer.h:12-33``): host chrono wrapper → :class:`Timer`
  (``time.perf_counter``).  As in the reference, device work is timed by
  bracketing the call — here with ``jax.block_until_ready`` instead of
  ``clFinish``.
- ``Statistics`` (``src/Statistics.h:6-32``): min/max/avg/sum/count.  The
  reference has a bug where ``min`` is never set by the first sample
  (``else if`` chain, SURVEY.md §2 quirk) — fixed here, not replicated.
- ``RuntimesGPU``/``RuntimesCPU`` (``src/RadixSortGPU.h:18-24``,
  ``src/CRadixSortTask.h:14-17``) → :class:`SortRuntimes`.
"""

from __future__ import annotations

import dataclasses
import math
import time


class Timer:
    """Host wall-clock timer, seconds→ms like the reference's CTimer."""

    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError("Timer.stop() before start()")
        self._elapsed = time.perf_counter() - self._t0
        self._t0 = None

    def elapsed_ms(self) -> float:
        return self._elapsed * 1e3


@dataclasses.dataclass
class Statistics:
    """Running min/max/avg/sum over samples (ms)."""

    n: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def update(self, value: float):
        # NB: independent min/max updates — the reference's `else if` meant
        # the first sample could miss `min` (src/Statistics.h:21-31).
        self.n += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    @property
    def avg(self) -> float:
        return self.total / self.n if self.n else 0.0

    def as_dict(self):
        return {"n": self.n, "avg": self.avg, "min": self.min, "max": self.max,
                "sum": self.total}


# Phase names follow the reference's four kernels (RadixSort.cl:16,125,185,74).
PHASES = ("histogram", "scan", "paste", "reorder")


@dataclasses.dataclass
class SortRuntimes:
    """Per-phase + total statistics for a sort run (RuntimesGPU parity).

    The whole sort is one fused jit region, so per-phase numbers are
    only populated by the instrumented (phase-split) benchmark path; the
    end-to-end `total` is the trustworthy number, exactly like the
    reference's `avgTotalGPU` caveat (SURVEY.md §6)."""

    histogram: Statistics = dataclasses.field(default_factory=Statistics)
    scan: Statistics = dataclasses.field(default_factory=Statistics)
    paste: Statistics = dataclasses.field(default_factory=Statistics)
    reorder: Statistics = dataclasses.field(default_factory=Statistics)
    total: Statistics = dataclasses.field(default_factory=Statistics)

    def phase(self, name: str) -> Statistics:
        return getattr(self, name)


@dataclasses.dataclass
class CpuRuntimes:
    """RuntimesCPU parity: the two host baselines."""

    stl: Statistics = dataclasses.field(default_factory=Statistics)  # np.sort
    radix: Statistics = dataclasses.field(default_factory=Statistics)


def time_callable_ms(fn, iterations: int = 5, warmup: int = 1) -> Statistics:
    """Run ``fn`` (which must block until its work is done) ``iterations``
    times, like TestPerformance (src/CRadixSortTask.cpp:355-437)."""
    for _ in range(warmup):
        fn()
    st = Statistics()
    t = Timer()
    for _ in range(iterations):
        t.start()
        fn()
        t.stop()
        st.update(t.elapsed_ms())
    return st
