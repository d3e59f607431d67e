"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions and numpy references agree at tiny sizes.  Also the runtime
helpers the measuring entry points share: the compile cache and the table
of published peaks."""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import chip_smoke
from radix_sort.parallel import runtime
from radix_sort.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _prints_no_result(proc):
    for line in proc.stdout.splitlines():
        try:
            assert "ok" not in json.loads(line)
        except (ValueError, TypeError):
            pass


def test_smoke_refuses_cpu():
    proc = _run_smoke(ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    _prints_no_result(proc)


def test_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    _prints_no_result(proc)


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu()


def test_expect_raises_on_mismatch():
    chip_smoke.expect(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="differs"):
        chip_smoke.expect(False, "column x differs")


def test_phase_sort_kv_tiny():
    rec = chip_smoke.phase_sort_kv(log2n=11)
    assert rec["phase"] == "a" and rec["second_call_s"] > 0


def test_phase_distributions_tiny():
    recs = chip_smoke.phase_distributions(log2n=9)
    assert len(recs) == 10  # five distributions x (u32, u64)


def test_phase_query_tiny():
    rec = chip_smoke.phase_query(log2n=12, groups=256)
    assert rec["phase"] == "b"


def test_lineitem_reference_small():
    cols = {"l_partkey": np.array([3, 1, 3, 2, 1, 3], np.int32),
            "l_extendedprice": np.array([1, 2, 3, 4, 5, 6], np.float32),
            "l_quantity": np.array([5, 9, 7, 1, 2, 8], np.int32),
            "l_discount": np.array([0, 1, 9, 2, 5, 0], np.int32)}
    exp = chip_smoke.lineitem_reference(cols, groups=4)
    # kept rows: all but the third; key 3 has two rows, 1 two, 2 one
    np.testing.assert_array_equal(exp["l_partkey"], [1, 3, 2])
    np.testing.assert_array_equal(exp["n"], [2, 2, 1])
    np.testing.assert_array_equal(exp["max_qty"], [9, 8, 1])
    np.testing.assert_allclose(exp["revenue"], [7.0, 7.0, 4.0])


def test_phase_join_tiny():
    rec = chip_smoke.phase_join(log2_probe=10, log2_build=8, k=16)
    assert rec["phase"] == "c"


def test_phase_distributed_on_four_cpu_devices():
    devices = jax.devices()[:4]
    recs = chip_smoke.phase_distributed(devices, log2_per_device=10)
    assert [r["what"].split(",")[0] for r in recs] == [
        "dist_sort_kv", "dist_hash_aggregate", "dist_hash_join"]
    assert chip_smoke.peak_bytes(devices) == [None] * 4  # CPU keeps none


def test_zipf_keys_are_skewed_and_bounded():
    keys = chip_smoke.zipf_keys(1 << 16)
    assert keys.dtype == np.uint32 and keys.max() < chip_smoke.DIST_KEYS
    assert np.bincount(keys).max() > keys.size // 8


# ----------------------------------------------------------- compile cache

def _capture_config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    calls = _capture_config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    calls = _capture_config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert runtime.enable_compile_cache() == path  # same path every call


# ------------------------------------------------------------- peak table

def _device(kind):
    return types.SimpleNamespace(device_kind=kind)


def test_peak_table_h100():
    assert profiling.hbm_bytes_per_s(_device("NVIDIA H100 80GB HBM3")) \
        == 3.35e12


def test_peak_table_unknown_device_raises():
    with pytest.raises(ValueError, match="no published HBM bandwidth"):
        profiling.hbm_bytes_per_s(_device("cpu"))


def test_roofline_uses_peak_table():
    dev = _device("NVIDIA H100 80GB HBM3")
    assert profiling.roofline(3.35e12, 2.0, device=dev) == pytest.approx(0.5)
    with pytest.raises(ValueError):
        profiling.roofline(1, 1.0, device=_device("unknown"))
