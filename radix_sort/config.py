"""Algorithm configuration for the radix-sort / query-execution engine.

The analogue of the reference's compile-time tuning header
(``src/Parameters.h:9-60`` — ``AlgorithmParameters<T>``): one dataclass is the
single source of tuning truth, validated at construction the way the reference
used ``static_assert``.  Instead of being injected into OpenCL source as ``-D``
macros (``src/RadixSortGPU.cpp:560-589``), the values here become JIT-static
arguments, so host and device always agree by construction.

Defaults differ from the reference: it used radix 16 (4 bits/pass, 8 passes
for 32-bit) tuned for a GTX 680's local memory; the ``xla_radix`` pipeline
here ranks with a one-hot reduction per block and defaults to 8 bits/pass.
"""

from __future__ import annotations

import dataclasses
import numpy as np

# Block granularity of the xla_radix pipeline: block_elems is a multiple of
# this, the reference's _GROUPS * _ITEMS "virtual processor" count
# (src/Parameters.h:17-23).
BLOCK_GRANULE = 1024


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Tuning parameters for the multi-pass LSD radix sort.

    Mirrors the *capabilities* of ``AlgorithmParameters<T>``
    (``src/Parameters.h:9-60``):

    - ``bits_per_pass``  — reference ``_NUM_BITS_PER_RADIX`` (4 there).
    - ``radix``          — derived, reference ``_RADIX``.
    - ``block_elems``    — xla_radix ranking block; plays the role of the
      reference's ``_NUM_ITEMS_PER_GROUP * _NUM_GROUPS`` sublist split.
    - ``max_input_elems``— reference ``_NUM_MAX_INPUT_ELEMS`` (2^25 there;
      we allow 2^27 per BASELINE.json).
    - ``perf_iterations``— reference ``_NUM_PERFORMANCE_ITERATIONS``.
    """

    bits_per_pass: int = 8
    block_elems: int = 1 << 16
    max_input_elems: int = 1 << 27
    perf_iterations: int = 5
    # Engine selection: "auto", "xla_sort" or "xla_radix"; see ops/sort.py.
    engine: str = "auto"

    def __post_init__(self):
        # Validation in the spirit of src/Parameters.h:31-49 static_asserts.
        if self.bits_per_pass not in (1, 2, 4, 8, 16):
            raise ValueError(
                f"bits_per_pass must divide the key width and be one of "
                f"(1,2,4,8,16); got {self.bits_per_pass}"
            )
        if self.block_elems % BLOCK_GRANULE != 0:
            raise ValueError(
                f"block_elems ({self.block_elems}) must be a multiple of "
                f"the xla_radix block granularity {BLOCK_GRANULE}"
            )
        if self.block_elems <= 0 or self.max_input_elems <= 0:
            raise ValueError("sizes must be positive")
        if self.perf_iterations <= 0:
            raise ValueError("perf_iterations must be positive")

    @property
    def radix(self) -> int:
        """Number of buckets per pass (reference ``_RADIX``)."""
        return 1 << self.bits_per_pass

    def num_passes(self, dtype) -> int:
        """Passes needed for ``dtype`` (reference ``_NUM_PASSES``:
        TOTALBITS / _NUM_BITS_PER_RADIX, src/Parameters.h:27)."""
        total_bits = np.dtype(dtype).itemsize * 8
        if total_bits % self.bits_per_pass != 0:
            raise ValueError(
                f"key width {total_bits} not divisible by bits_per_pass "
                f"{self.bits_per_pass}"
            )
        return total_bits // self.bits_per_pass

    def padded_size(self, n: int) -> int:
        """Round ``n`` up to a whole number of blocks (reference rounded to a
        multiple of _GROUPS*_ITEMS = 1024, src/RadixSortGPU.cpp:287-297)."""
        if n <= 0:
            return self.block_elems
        return -(-n // self.block_elems) * self.block_elems


DEFAULT_CONFIG = SortConfig()
