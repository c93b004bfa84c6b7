"""AoS<->SoA and byte-plane shuffles.

Equivalent of the reference ``trico/transpose_aos_to_soa.c`` scalar loops:
interleaved xyz/uv streams become per-component planes, and integer streams
become little-endian byte planes (plane 0 = least-significant byte,
transpose_aos_to_soa.c:103-122). The byte planes go through the C++ host
library (:func:`..native.split_bytes`, :func:`..native.join_bytes`: one
threaded pass each way) where it is built, else through NumPy strided views;
each call adds its bytes to the tally under
``byte_planes.<split|join>.<native|numpy>``. The port's own copy of
``trico_tpu/codec/transpose.py``.
"""

from __future__ import annotations

import numpy as np

from .. import native, profiling


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


def byte_planes(arr: np.ndarray) -> np.ndarray:
    """Split an integer array into its little-endian byte planes, the rows
    of one ``(itemsize, arr.size)`` uint8 array.

    plane[k][i] == (arr[i] >> (8*k)) & 0xff, matching the reference shuffles.
    """
    return split_byte_planes(arr)[0]


def split_byte_planes(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """:func:`byte_planes`, and per plane whether every byte equals its
    first (a fill plane; False for an empty array)."""
    if native.available():
        planes, fills = native.split_bytes(arr)
        profiling.count("byte_planes.split.native", planes.nbytes)
        return planes, fills
    planes = _byte_planes_numpy(arr)
    fills = np.array([len(plane) > 0 and not np.any(plane != plane[0])
                      for plane in planes], bool)
    profiling.count("byte_planes.split.numpy", planes.nbytes)
    return planes, fills


def from_byte_planes(planes, dtype) -> np.ndarray:
    """Reassemble little-endian byte planes into an integer array."""
    if native.available():
        out = native.join_bytes(planes, dtype)
        profiling.count("byte_planes.join.native", out.nbytes)
        return out
    out = _from_byte_planes_numpy(planes, dtype)
    profiling.count("byte_planes.join.numpy", out.nbytes)
    return out


def _byte_planes_numpy(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    width = arr.dtype.itemsize
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return np.ascontiguousarray(arr.view(np.uint8).reshape(-1, width).T)


def _from_byte_planes_numpy(planes, dtype) -> np.ndarray:
    dtype = np.dtype(dtype)
    b = np.stack(planes, axis=1).astype(np.uint8)
    return np.ascontiguousarray(b).view(dtype.newbyteorder("<")).reshape(-1).astype(dtype)
