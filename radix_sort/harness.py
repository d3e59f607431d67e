"""Task orchestration harness.

Parity with the reference's L2/L3 layers:

- ``IComputeTask`` 5-phase contract (``Common/IComputeTask.h:12-35``):
  InitResources → ComputeCPU → ComputeGPU → ValidateResults →
  ReleaseResources, realized by :class:`SortTask` (the reference's
  ``CRadixSortTask``, ``src/CRadixSortTask.h:22-92``).
- ``CTestBase::RunComputeTask`` lifecycle driver (``tests/CTestBase.cpp:20-67``)
  → :func:`run_compute_task`.
- ``CRunner`` fan-out over types × datasets (``tests/tests.cpp:29-88``)
  → :func:`run_all`.

"GPU" in names maps to the JAX device path; "CPU" to the host golden
baselines (np.sort = std::sort, golden radix = RadixSortCPU, optionally the
native C++ baselines from native/).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import datasets as ds_lib, dtypes, golden
from .config import SortConfig, DEFAULT_CONFIG
from .ops import sort as sort_ops
from .status import EngineError, OperationStatus
from .utils import stats as stats_lib
from .utils.cli import RadixSortOptions
from .utils.csvio import PerfRow


@dataclasses.dataclass
class TaskResult:
    row: PerfRow
    valid: bool
    status: "OperationStatus"


class SortTask:
    """One (dtype, dataset, n) sort job with golden validation and timing."""

    def __init__(self, dtype, dataset, options: RadixSortOptions | None = None,
                 config: SortConfig = DEFAULT_CONFIG, with_values: bool = True):
        self.dtype = np.dtype(dtype)
        self.dataset = dataset
        self.options = options or RadixSortOptions()
        self.config = config
        self.with_values = with_values
        self.gpu_runtimes = stats_lib.SortRuntimes()
        self.cpu_runtimes = stats_lib.CpuRuntimes()
        self._host_keys = None
        self._dev_keys = None
        self._expected = None
        self._result = None

    # -- phase 1 ----------------------------------------------------------
    def init_resources(self):
        n = self.options.num_elements
        if n > self.config.max_input_elems:
            raise EngineError(OperationStatus.RESIZE_FAILED,
                              f"n={n} exceeds max_input_elems "
                              f"({self.config.max_input_elems})")
        self._host_keys = self.dataset.generate(n)
        self._dev_keys = jax.device_put(jnp.asarray(self._host_keys))
        if self.with_values:
            self._dev_vals = jax.device_put(
                jnp.arange(n, dtype=jnp.int32))

    # -- phase 2: host golden baselines ------------------------------------
    def compute_cpu(self):
        it = self.options.iterations

        def stl():
            self._expected = golden.oracle_sort(self._host_keys)

        self.cpu_runtimes.stl = stats_lib.time_callable_ms(
            stl, iterations=it, warmup=0)

        try:
            from .utils import native_baseline
            radix_fn = native_baseline.radix_sort_fn(self._host_keys)
        except Exception:  # noqa: BLE001 - native lib optional
            radix_fn = lambda: golden.cpu_radix_sort(self._host_keys)
        self.cpu_runtimes.radix = stats_lib.time_callable_ms(
            radix_fn, iterations=it, warmup=0)

    # -- phase 3b: per-phase instrumentation --------------------------------
    def measure_phases(self):
        """Populate the per-kernel columns (avgHistogram/avgScan/avgReorder
        — avgPaste stays 0: the paste kernel is folded into the scan,
        docs/DESIGN.md §2.1) by timing the xla_radix pipeline's stages for
        one pass and scaling by the pass count.  The production engine runs
        fused, so these are diagnostic numbers, mirroring the reference's
        per-kernel stats (src/RadixSortGPU.cpp:37-56)."""
        import jax.numpy as jnp

        from . import dtypes as dt
        from .ops import ranking
        from .utils import profiling

        cfg = self.config
        ku = dt.to_sortable_unsigned(self._dev_keys)
        n = ku.shape[0]
        padded = cfg.padded_size(n)
        sent = dt._np_scalar(np.dtype(ku.dtype),
                             dt.sentinel_max_unsigned(ku.dtype))
        ku = sort_ops._pad_1d(ku, padded, sent)
        M = min(cfg.block_elems, padded)
        B = padded // M
        passes = cfg.num_passes(self.dtype)
        mask = dt._np_scalar(np.dtype(ku.dtype), cfg.radix - 1)

        def hist(k):
            d = (k & mask).astype(jnp.int32).reshape(B, M)
            return k + ranking.block_digit_counts(d, cfg.radix)[0, 0].astype(k.dtype)

        def scan_fn(k):
            d = (k & mask).astype(jnp.int32).reshape(B, M)
            counts = ranking.block_digit_counts(d, cfg.radix)
            total = counts.sum(axis=0)
            base = (jnp.cumsum(total, 0) - total)[None, :] + (
                jnp.cumsum(counts, 0) - counts)
            return k + base[0, 0].astype(k.dtype)

        def reorder(k):
            d = (k & mask).astype(jnp.int32).reshape(B, M)
            dest, _, _ = ranking.stable_dest(d, cfg.radix,
                                             sequential_blocks=B > 64)
            out = ranking.apply_destinations(dest.reshape(-1), (k,))
            return out[0]

        t_h = profiling.chained_time(hist, ku, iters=2, warmup=1)
        t_s = profiling.chained_time(scan_fn, ku, iters=2, warmup=1)
        t_r = profiling.chained_time(reorder, ku, iters=2, warmup=1)
        self.gpu_runtimes.histogram.update(t_h * passes * 1e3)
        self.gpu_runtimes.scan.update(max(t_s - t_h, 0.0) * passes * 1e3)
        self.gpu_runtimes.reorder.update(max(t_r - t_s, 0.0) * passes * 1e3)

    # -- phase 3: device sort ---------------------------------------------
    def compute_gpu(self):
        it = self.options.iterations
        cfg = self.config
        if self.with_values:
            fn = jax.jit(lambda k, v: sort_ops.sort_kv(k, v, config=cfg))
            args = (self._dev_keys, self._dev_vals)
        else:
            fn = jax.jit(lambda k: sort_ops.sort(k, config=cfg))
            args = (self._dev_keys,)

        def run():
            jax.block_until_ready(fn(*args))

        self.gpu_runtimes.total = stats_lib.time_callable_ms(
            run, iterations=it, warmup=1)
        self._result = fn(*args)

    # -- phase 4 -----------------------------------------------------------
    def validate_results(self) -> bool:
        n = self.options.num_elements
        if self._expected is None:
            self._expected = golden.oracle_sort(self._host_keys)
        out_keys = self._result[0] if self.with_values else self._result
        ok = golden.validate_bit_exact(np.asarray(out_keys),
                                       self._expected, n)
        if self.with_values and ok:
            # the KV contract is the STABLE permutation, not just any
            # correct one (CLAUDE.md: stability is a contract).
            perm = np.asarray(self._result[1])
            ok = bool(np.array_equal(
                perm, golden.oracle_argsort(self._host_keys)))
        return ok

    # -- phase 5 -----------------------------------------------------------
    def release_resources(self):
        self._dev_keys = None
        self._result = None
        if hasattr(self, "_dev_vals"):
            self._dev_vals = None

    # -- reporting ---------------------------------------------------------
    def perf_row(self, valid: bool, engine_name: str,
                 hbm_bw_gbs: float | None = None) -> PerfRow:
        n = self.options.num_elements
        total_ms = self.gpu_runtimes.total.avg
        mkeys = (n / (total_ms / 1e3) / 1e6) if total_ms else 0.0
        roofline = 0.0
        if hbm_bw_gbs and total_ms:
            bytes_min = _sort_min_bytes(n, self.dtype, self.config,
                                        self.with_values)
            roofline = (bytes_min / (total_ms / 1e3)) / (hbm_bw_gbs * 1e9)
        return PerfRow(
            num_elements=n,
            datatype=dtypes.type_name(self.dtype),
            dataset=self.dataset.name,
            avg_histogram=self.gpu_runtimes.histogram.avg,
            avg_scan=self.gpu_runtimes.scan.avg,
            avg_paste=self.gpu_runtimes.paste.avg,
            avg_reorder=self.gpu_runtimes.reorder.avg,
            avg_total_gpu=total_ms,
            avg_total_stl_cpu=self.cpu_runtimes.stl.avg,
            avg_total_rdx_cpu=self.cpu_runtimes.radix.avg,
            mkeys_per_sec=mkeys,
            roofline_frac=roofline,
            engine=engine_name,
        )


def _sort_min_bytes(n: int, dtype, config: SortConfig, kv: bool) -> int:
    from .utils import profiling

    return profiling.sort_min_bytes(n, dtype, config.bits_per_pass,
                                    payload_bytes=4 if kv else 0)


def run_compute_task(task: SortTask, verbose: bool = False) -> TaskResult:
    """CTestBase::RunComputeTask lifecycle (tests/CTestBase.cpp:20-67)."""
    try:
        task.init_resources()
    except Exception as e:  # noqa: BLE001
        raise EngineError(OperationStatus.INITIALIZATION_FAILED, str(e))
    task.compute_cpu()
    task.compute_gpu()
    valid = task.validate_results()
    engine = sort_ops._dispatch_engine(task.config.engine)
    row = task.perf_row(valid, engine)
    task.release_resources()
    if verbose:
        verdict = "VALID" if valid else "INVALID"
        print(f"{row.datatype:4s} {row.dataset:18s} n={row.num_elements} "
              f"{row.avg_total_gpu:10.3f} ms  {row.mkeys_per_sec:8.1f} Mkeys/s "
              f"[{verdict}]")
    return TaskResult(row=row, valid=valid,
                      status=OperationStatus.OK if valid
                      else OperationStatus.VALIDATION_FAILED)


def run_all(options: RadixSortOptions | None = None,
            config: SortConfig = DEFAULT_CONFIG,
            dtypes_list=(np.uint32, np.int32, np.uint64, np.int64),
            seed: int | None = 0):
    """CRunner::DoCompute fan-out: all types x all five datasets
    (tests/tests.cpp:29-88).  Returns list[TaskResult]."""
    options = options or RadixSortOptions()
    results = []
    for dt in dtypes_list:
        name = dtypes.type_name(dt)
        if options.datatypes and name not in options.datatypes:
            continue
        for ds in ds_lib.make_datasets(dt, seed=seed):
            if options.datasets and ds.name not in options.datasets:
                continue
            task = SortTask(dt, ds, options=options, config=config)
            results.append(run_compute_task(task, verbose=options.verbose))
    return results
