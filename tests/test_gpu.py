"""Checks that need an NVIDIA GPU: the compiled GPU programs against the
host references at widths the CPU suite does not reach.

Each test takes the ``gpu`` fixture (tests/conftest.py), which skips it
without a card.  On a card: ``RST_TEST_GPU=1 python -m pytest tests/ -m gpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from radix_sort.ops import partition

pytestmark = pytest.mark.gpu


def test_sort_kv_matches_stable_argsort(gpu):
    chip_smoke.phase_sort_kv(log2n=22)


@pytest.mark.parametrize("method", ["sort", "rank"])
def test_compaction_matches_numpy(gpu, method):
    n = (1 << 22) + 3
    rng = np.random.default_rng(0)
    mask = rng.random(n) < 0.5
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    (out,), kept = jax.jit(lambda m, v: partition.compact_mask(
        m, (v,), method=method))(jnp.asarray(mask), jnp.asarray(vals))
    assert int(kept) == int(mask.sum())
    np.testing.assert_array_equal(np.asarray(out)[:int(kept)], vals[mask])


def test_query_and_join_match_numpy(gpu):
    chip_smoke.phase_query(log2n=22, groups=1 << 16)
    chip_smoke.phase_join(log2_probe=20, log2_build=18, k=100)
