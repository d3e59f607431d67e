"""radix_sort — a vectorized query-execution engine in JAX.

A JAX/XLA implementation with the capabilities of the reference OpenCL
radix sort (gyatskov/radix-sort), extended to a columnar operator set (sort,
filter, hash aggregate, radix-partitioned hash join) that scales over
multi-device meshes.

Public API:
    sort, sort_kv, argsort         — stable LSD radix sort (ops/sort.py)
    SortConfig                     — tuning parameters (config.py)
    Table                          — columnar batch (table.py)
    filter/aggregate/join ops      — ops/
    distributed ops                — parallel/
"""

from .config import SortConfig, DEFAULT_CONFIG
from .status import OperationStatus, EngineError
from .ops.sort import sort, sort_kv, argsort
from .ops.topk import top_k, top_k_kv
from .table import Table
from .query import Query
from . import datasets, golden, dtypes

__version__ = "0.1.0"

__all__ = [
    "sort", "sort_kv", "argsort", "top_k", "top_k_kv",
    "Table", "Query",
    "SortConfig", "DEFAULT_CONFIG",
    "OperationStatus", "EngineError",
    "datasets", "golden", "dtypes",
    "__version__",
]
