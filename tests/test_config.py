"""SortConfig validation — parity with src/Parameters.h static_asserts."""

import numpy as np
import pytest

from radix_sort.config import SortConfig, BLOCK_GRANULE


def test_defaults_valid():
    c = SortConfig()
    assert c.radix == 256
    assert c.num_passes(np.uint32) == 4
    assert c.num_passes(np.uint64) == 8
    assert c.block_elems % BLOCK_GRANULE == 0


def test_reference_like_params():
    # The reference's radix-16, 4-bit config is expressible too.
    c = SortConfig(bits_per_pass=4)
    assert c.radix == 16
    assert c.num_passes(np.uint32) == 8
    assert c.num_passes(np.uint64) == 16


@pytest.mark.parametrize("kwargs", [
    dict(bits_per_pass=3),
    dict(bits_per_pass=0),
    dict(block_elems=1000),       # not a multiple of 1024
    dict(block_elems=-1024),
    dict(perf_iterations=0),
])
def test_invalid_configs_rejected(kwargs):
    with pytest.raises(ValueError):
        SortConfig(**kwargs)


def test_padded_size():
    c = SortConfig(block_elems=1024)
    assert c.padded_size(1) == 1024
    assert c.padded_size(1024) == 1024
    assert c.padded_size(1025) == 2048
    assert c.padded_size(0) == 1024


def test_config_hashable_for_jit_static_arg():
    assert hash(SortConfig()) == hash(SortConfig())
    assert SortConfig() != SortConfig(bits_per_pass=4)
