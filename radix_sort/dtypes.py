"""Key-type registry and order-preserving bit transforms.

The analogue of two reference facilities:

- ``Common/CLTypeInformation.h:8-46`` (``TypeNameString<T>``): the C++ type →
  {stdint name, OpenCL-C name} bridge used for kernel preambles and CSV
  labels.  Here it is a registry mapping numpy/jax dtypes to canonical names
  used in CSV output and test parametrization.

- The signed-key OFFSET machinery (``src/RadixSortGPU.cpp:436``,
  ``src/kernels/RadixSort.cl:51,109,114``): the reference adds
  ``-numeric_limits<T>::min()`` on key read and subtracts it on write so
  signed keys sort as unsigned.  The equivalent here is a bitwise
  sign-bias: XOR the sign bit (for ints) after bitcasting to the unsigned
  container, which is branch-free and fuses into the digit extraction.
  Floats (an extension over the reference) use the standard total-order
  transform: flip all bits of negatives, flip only the sign bit of
  non-negatives.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Canonical names, mirroring the reference's supported instantiations
# (src/CRadixSortTask.cpp:440-443: i32/i64/u32/u64) plus f32/f64 extensions.
_REGISTRY = {
    np.dtype(np.uint32): ("uint32_t", "u32"),
    np.dtype(np.int32): ("int32_t", "i32"),
    np.dtype(np.uint64): ("uint64_t", "u64"),
    np.dtype(np.int64): ("int64_t", "i64"),
    np.dtype(np.uint16): ("uint16_t", "u16"),
    np.dtype(np.int16): ("int16_t", "i16"),
    np.dtype(np.float32): ("float", "f32"),
    np.dtype(np.float64): ("double", "f64"),
}

SUPPORTED_KEY_DTYPES = tuple(_REGISTRY)


def type_name(dtype) -> str:
    """Short canonical label (u32/i64/...) used in CSV rows and test ids."""
    return _REGISTRY[np.dtype(dtype)][1]


def c_name(dtype) -> str:
    """stdint-style name, parity with TypeNameString<T>::stdint_name."""
    return _REGISTRY[np.dtype(dtype)][0]


def key_bits(dtype) -> int:
    return np.dtype(dtype).itemsize * 8


def unsigned_container(dtype) -> np.dtype:
    """The unsigned integer dtype whose bit pattern carries the sort order."""
    return np.dtype(f"u{np.dtype(dtype).itemsize}")


def is_signed_int(dtype) -> bool:
    d = np.dtype(dtype)
    return d.kind == "i"


def is_float(dtype) -> bool:
    return np.dtype(dtype).kind == "f"


def to_sortable_unsigned(keys: jnp.ndarray) -> jnp.ndarray:
    """Map keys to an unsigned container whose unsigned order equals the
    source order.  Branch-free equivalent of the reference's OFFSET add
    (src/kernels/RadixSort.cl:51)."""
    d = np.dtype(keys.dtype)
    u = unsigned_container(d)
    if d.kind == "u":
        return keys
    sign = _np_scalar(u, 1 << (key_bits(d) - 1))
    if d.kind == "i":
        return jnp.bitwise_xor(jax_bitcast(keys, u), sign)
    if d.kind == "f":
        bits = jax_bitcast(keys, u)
        # negatives: flip all bits; non-negatives: flip sign bit.
        mask = jnp.where((bits & sign) != 0, _np_scalar(u, -1), sign)
        return bits ^ mask
    raise TypeError(f"unsupported key dtype {d}")


def _np_scalar(u: np.dtype, value: int):
    """A numpy scalar of unsigned dtype ``u`` from a (possibly negative or
    overflowing) python int, with wraparound semantics."""
    return u.type(value & ((1 << (u.itemsize * 8)) - 1))


def from_sortable_unsigned(ukeys: jnp.ndarray, dtype) -> jnp.ndarray:
    """Inverse of :func:`to_sortable_unsigned` (reference OFFSET subtract,
    src/kernels/RadixSort.cl:109,114)."""
    d = np.dtype(dtype)
    u = unsigned_container(d)
    if d.kind == "u":
        return ukeys.astype(d)
    sign = _np_scalar(u, 1 << (key_bits(d) - 1))
    if d.kind == "i":
        return jax_bitcast(ukeys ^ sign, d)
    if d.kind == "f":
        mask = jnp.where((ukeys & sign) != 0, sign, _np_scalar(u, -1))
        return jax_bitcast(ukeys ^ mask, d)
    raise TypeError(f"unsupported key dtype {d}")


def jax_bitcast(x: jnp.ndarray, dtype) -> jnp.ndarray:
    import jax.lax as lax

    return lax.bitcast_convert_type(x, np.dtype(dtype))


# NumPy twins for the golden model ------------------------------------------


def np_to_sortable_unsigned(keys: np.ndarray) -> np.ndarray:
    d = keys.dtype
    u = unsigned_container(d)
    if d.kind == "u":
        return keys
    if d.kind == "i":
        return keys.view(u) ^ u.type(1 << (key_bits(d) - 1))
    if d.kind == "f":
        bits = keys.view(u)
        sign = u.type(1 << (key_bits(d) - 1))
        mask = np.where((bits & sign) != 0, u.type(~u.type(0)), sign)
        return bits ^ mask
    raise TypeError(f"unsupported key dtype {d}")


def np_from_sortable_unsigned(ukeys: np.ndarray, dtype) -> np.ndarray:
    d = np.dtype(dtype)
    u = unsigned_container(d)
    if d.kind == "u":
        return ukeys.astype(d)
    if d.kind == "i":
        return (ukeys ^ u.type(1 << (key_bits(d) - 1))).view(d)
    if d.kind == "f":
        sign = u.type(1 << (key_bits(d) - 1))
        mask = np.where((ukeys & sign) != 0, sign, u.type(~u.type(0)))
        return (ukeys ^ mask).view(d)
    raise TypeError(f"unsupported key dtype {d}")


def sentinel_max_unsigned(dtype) -> int:
    """Padding sentinel: the maximum unsigned container value.  The reference
    padded with ``max - 1`` (src/RadixSortGPU.cpp:269-285); we pad with max
    itself — safe because the sort is stable, so real keys equal to max keep
    their positions ahead of the padding tail."""
    return (1 << key_bits(dtype)) - 1
