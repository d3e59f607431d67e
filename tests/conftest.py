"""Test configuration: run everything on a simulated 8-device CPU backend.

The reference's tests require a physical GPU and its CI test step is titled
"Test (inactive)" (SURVEY.md §4); we fix that gap: the whole suite runs on
the CPU backend with 8 virtual devices so the multi-device sharding paths are
exercised everywhere, hardware or not.  Must set env vars before jax import.

Tests marked ``gpu`` need a card and take the :func:`gpu` fixture, which
skips them unless JAX's default backend is a GPU.  Run them on a card with
``RST_TEST_GPU=1 python -m pytest tests/ -m gpu``: the switch keeps this file
from forcing the CPU backend.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("RST_TEST_GPU"):
    # jax is already imported, so the config (not only the env var) must
    # change before the first backend initializes.
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # 64-bit key coverage

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (RST_TEST_GPU=1 on a card)")
    return jax.devices()[0]


KEY_DTYPES = [np.uint32, np.int32, np.uint64, np.int64]
KEY_DTYPE_IDS = ["u32", "i32", "u64", "i64"]


@pytest.fixture(params=KEY_DTYPES, ids=KEY_DTYPE_IDS)
def key_dtype(request):
    return np.dtype(request.param)
