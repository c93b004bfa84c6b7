"""Plain NumPy decoder of BP32 / BP64 chunks (FORMAT.md section 6).

A chunk of n values is ``[u8 widths[ceil(n/32)]]`` and then, for each group
of 32 values, ``w`` little-endian 32-bit planes: bit j of plane b is bit b
of the group's j-th zigzag delta. Deltas restart from 0 in every chunk.
Chunks of one count are decoded together: the planes of every group are
turned back into values by one bit transpose (unpack, swap axes, pack).
"""

from __future__ import annotations

import numpy as np

GROUP = 32
# the bytes of the unpacked bits one batch of chunks may take
BATCH_BYTES = 1 << 28


def _decode_same_count(payloads: list[np.ndarray], n: int, bits: int) -> np.ndarray:
    dt = np.uint32 if bits == 32 else np.uint64
    G = -(-n // GROUP)
    C = len(payloads)
    sizes = np.array([len(p) for p in payloads], np.int64)
    W = int(sizes.max(initial=0))
    if W < G:
        raise ValueError("BP chunk shorter than its width header")
    flat = np.zeros(C * W + 1, np.uint8)  # the last byte reads as zero
    for c, p in enumerate(payloads):
        flat[c * W : c * W + len(p)] = p
    mat = flat[:-1].reshape(C, W)
    widths = mat[:, :G].astype(np.int64)
    if widths.max(initial=0) > bits:
        raise ValueError("BP chunk width above its element bits")
    if np.any(G + 4 * widths.sum(axis=1) != sizes):
        raise ValueError("BP chunk size does not match its widths")
    maxw = int(widths.max(initial=0))
    planes_off = G + 4 * (np.cumsum(widths, axis=1) - widths)
    b = np.arange(maxw, dtype=np.int64)
    idx = ((np.arange(C, dtype=np.int64) * W)[:, None, None, None]
           + planes_off[:, :, None, None] + 4 * b[None, None, :, None]
           + np.arange(4)[None, None, None, :])
    idx = np.where((b[None, None, :] < widths[:, :, None])[..., None], idx, C * W)
    plane_bits = np.unpackbits(flat[idx], axis=-1, bitorder="little")
    z_bits = np.zeros((C, G, GROUP, bits), np.uint8)  # [chunk, group, j, b]
    z_bits[..., :maxw] = plane_bits.reshape(C, G, maxw, GROUP).swapaxes(2, 3)
    z = (np.packbits(z_bits, axis=-1, bitorder="little")
         .view("<u4" if bits == 32 else "<u8").astype(dt).reshape(C, G * GROUP)[:, :n])
    d = (z >> dt(1)) ^ (dt(0) - (z & dt(1)))
    return np.cumsum(d, axis=1, dtype=dt)


def decode_chunks(chunks: list[tuple[np.ndarray, int]], bits: int) -> list[np.ndarray]:
    """Decode BP chunks given as (payload bytes, value count) → one word
    array per chunk, in order."""
    out = [None] * len(chunks)
    by_n: dict[int, list[int]] = {}
    for k, (_, n) in enumerate(chunks):
        by_n.setdefault(n, []).append(k)
    for n, ks in by_n.items():
        step = max(1, BATCH_BYTES // max(1, -(-n // GROUP) * GROUP * bits * 2))
        for a in range(0, len(ks), step):
            part = ks[a : a + step]
            words = _decode_same_count([chunks[k][0] for k in part], n, bits)
            for j, k in enumerate(part):
                out[k] = words[j]
    return out
