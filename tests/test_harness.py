"""Harness layer: 5-phase task lifecycle, runner fan-out, CSV schema, CLI
options, statistics — the reference's L2/L3 behavior (CRadixSortTask,
CTestBase, CRunner, writePerformance, RadixSortOptions, Statistics)."""

import io

import numpy as np
import pytest

from radix_sort import datasets, harness
from radix_sort.config import SortConfig
from radix_sort.status import OperationStatus
from radix_sort.utils import cli, csvio, stats


def _opts(**kw):
    base = dict(num_elements=2048, iterations=2)
    base.update(kw)
    return cli.RadixSortOptions(**base)


def test_sort_task_lifecycle():
    ds = datasets.Random(np.uint32)
    task = harness.SortTask(np.uint32, ds, options=_opts(),
                            config=SortConfig(block_elems=1024))
    res = harness.run_compute_task(task)
    assert res.valid
    assert res.status is OperationStatus.OK
    assert res.row.num_elements == 2048
    assert res.row.datatype == "u32"
    assert res.row.dataset == "Random"
    assert res.row.avg_total_gpu > 0
    assert res.row.avg_total_stl_cpu > 0
    assert res.row.mkeys_per_sec > 0


def test_runner_fan_out_filtered():
    opts = _opts(datatypes=("u32",), datasets=("Zeros", "Range"))
    results = harness.run_all(opts, config=SortConfig(block_elems=1024),
                              dtypes_list=(np.uint32,))
    assert len(results) == 2
    assert all(r.valid for r in results)
    assert {r.row.dataset for r in results} == {"Zeros", "Range"}


def test_runner_all_types_small():
    opts = _opts(num_elements=256, datasets=("Random",))
    results = harness.run_all(opts, config=SortConfig(block_elems=1024))
    assert len(results) == 4  # u32, i32, u64, i64
    assert all(r.valid for r in results)
    assert {r.row.datatype for r in results} == {"u32", "i32", "u64", "i64"}


def test_max_elems_guard():
    ds = datasets.Zeros(np.uint32)
    task = harness.SortTask(np.uint32, ds,
                            options=_opts(num_elements=1 << 30))
    from radix_sort.status import EngineError
    with pytest.raises(EngineError):
        harness.run_compute_task(task)


# ----------------------------------------------------------------- csvio

def test_csv_reference_schema():
    row = csvio.PerfRow(1024, "u32", "Zeros", avg_total_gpu=1.5,
                        avg_total_stl_cpu=10.0, avg_total_rdx_cpu=12.0)
    buf = io.StringIO()
    csvio.write_rows([row], buf, extended=False)
    lines = buf.getvalue().strip().split("\n")
    assert lines[0] == ("NumElements,Datatype,Dataset,avgHistogram,avgScan,"
                        "avgPaste,avgReorder,avgTotalGPU,avgTotalSTLCPU,"
                        "avgTotalRDXCPU")
    assert lines[1].startswith("1024,u32,Zeros,0,0,0,0,1.5,10,12")


def test_csv_extended_columns():
    row = csvio.PerfRow(1024, "u32", "Zeros", mkeys_per_sec=100.0,
                        roofline_frac=0.5, engine="xla_radix")
    buf = io.StringIO()
    csvio.write_rows([row], buf, extended=True)
    header = buf.getvalue().split("\n")[0]
    assert header.endswith("MkeysPerSec,RooflineFrac,Engine")


def test_csv_timestamped_path(tmp_path):
    path = csvio.write_csv(
        [csvio.PerfRow(8, "u32", "Zeros")], directory=str(tmp_path))
    assert path.startswith(str(tmp_path))
    import os
    assert os.path.basename(path).startswith("radix_")
    assert path.endswith(".csv")


# ------------------------------------------------------------------- cli

def test_cli_defaults_match_reference():
    o = cli.parse_options([])
    assert o.num_elements == 1 << 25  # reference default
    assert not o.verbose


def test_cli_reference_flags():
    o = cli.parse_options([
        "--num-elements", "4096", "--perf-to-stdout", "--perf-to-csv",
        "--perf-csv-to-stdout", "-v"])
    assert o.num_elements == 4096
    assert o.perf_to_stdout and o.perf_to_csv and o.perf_csv_to_stdout
    assert o.verbose


def test_cli_extensions():
    o = cli.parse_options(["--engine", "xla_radix", "--datatypes", "u32,u64",
                           "--datasets", "Zeros"])
    assert o.engine == "xla_radix"
    assert o.datatypes == ("u32", "u64")
    assert o.datasets == ("Zeros",)


# ------------------------------------------------------------------ stats

def test_statistics_first_sample_sets_min():
    # The reference's else-if bug meant min was never set by the first
    # sample (src/Statistics.h:21-31); ours must not replicate it.
    st = stats.Statistics()
    st.update(5.0)
    assert st.min == 5.0 and st.max == 5.0 and st.avg == 5.0
    st.update(3.0)
    st.update(7.0)
    assert st.min == 3.0 and st.max == 7.0 and st.n == 3
    assert st.avg == pytest.approx(5.0)


def test_timer():
    t = stats.Timer()
    t.start()
    t.stop()
    assert t.elapsed_ms() >= 0
    with pytest.raises(RuntimeError):
        stats.Timer().stop()


def test_time_callable():
    calls = []
    st = stats.time_callable_ms(lambda: calls.append(1), iterations=3,
                                warmup=1)
    assert st.n == 3
    assert len(calls) == 4


def test_phase_instrumentation_populates_columns():
    ds = datasets.Random(np.uint32)
    task = harness.SortTask(np.uint32, ds, options=_opts(num_elements=4096),
                            config=SortConfig(block_elems=1024))
    task.init_resources()
    task.measure_phases()
    row = task.perf_row(True, "xla_radix")
    assert row.avg_histogram > 0
    assert row.avg_paste == 0.0  # folded into scan by design
