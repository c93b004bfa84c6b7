"""AoS<->SoA and byte-plane shuffles (NumPy, vectorized).

Equivalent of the reference ``trico/transpose_aos_to_soa.c`` scalar loops:
interleaved xyz/uv streams become per-component planes, and integer streams
become little-endian byte planes (plane 0 = least-significant byte,
transpose_aos_to_soa.c:103-122). NumPy strided views do the work at memory
bandwidth. The port's own copy of ``trico_tpu/codec/transpose.py``.
"""

from __future__ import annotations

import numpy as np


def aos_to_soa(arr: np.ndarray, width: int) -> list[np.ndarray]:
    """Split an interleaved (n*width,) or (n, width) array into `width` planes."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr.reshape(-1, width)
    assert arr.shape[1] == width
    return [np.ascontiguousarray(arr[:, i]) for i in range(width)]


def soa_to_aos(planes: list[np.ndarray]) -> np.ndarray:
    """Interleave per-component planes back into an (n, width) array."""
    return np.ascontiguousarray(np.stack(planes, axis=1))


def byte_planes(arr: np.ndarray) -> list[np.ndarray]:
    """Split an integer array into its little-endian byte planes.

    plane[k][i] == (arr[i] >> (8*k)) & 0xff, matching the reference shuffles.
    """
    arr = np.ascontiguousarray(arr)
    width = arr.dtype.itemsize
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    b = arr.view(np.uint8).reshape(-1, width)
    return [np.ascontiguousarray(b[:, k]) for k in range(width)]


def from_byte_planes(planes: list[np.ndarray], dtype) -> np.ndarray:
    """Reassemble little-endian byte planes into an integer array."""
    dtype = np.dtype(dtype)
    b = np.stack(planes, axis=1).astype(np.uint8)
    return np.ascontiguousarray(b).view(dtype.newbyteorder("<")).reshape(-1).astype(dtype)
