"""The LZ4 match search for integer byte planes, in PyTorch.

Counterpart of ``trico_tpu/codec/lz4_jax.py``; the names match and the
candidates are the same. The search runs on the device, the emission on the
host: for every position of every block, :func:`find_matches` gives the
offset of the nearest earlier 4-byte window with the same hash and the same
bytes, and the length of the offset-1 run that starts there; the native
emitter (``native.lz4_emit_blocks``) walks each block once, re-verifies and
extends the candidates and writes standard LZ4 sequences. A wrong candidate
can cost ratio but never correctness. Offsets are not capped at LZ4's 64 KiB
window here, exactly as in ``lz4_jax``: the emitter drops those it cannot use.

The JAX module's dead ``BLOCK = 4096`` is not carried over: the container
passes its block length (1 MiB, ``chunked.DEFAULT_LZ4_BLOCK``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native, profiling, staging

_KNUTH = 2654435761  # the multiplicative hash of lz4_jax.py:50
_HASH_BITS = 13


def _hash(w4: torch.Tensor) -> torch.Tensor:
    """``(w4 * 2654435761 mod 2^32) >> 19`` of int64 words below 2^32, with
    no product past 2^48: the low and high 16-bit halves are multiplied
    apart and only the low 16 bits of the high product are kept."""
    lo = (w4 & 0xFFFF) * _KNUTH
    hi = ((w4 >> 16) * _KNUTH) & 0xFFFF
    return ((lo + (hi << 16)) & 0xFFFFFFFF) >> (32 - _HASH_BITS)


def find_matches(blocks: torch.Tensor):
    """(C, S) uint8 blocks → (offset (C, S) int32, rle_len (C, S) int32).

    ``offset[c, p]`` is the distance to the nearest earlier position with
    the same window hash whose 4-byte window equals the one at p (0 = none);
    windows read zeros past the end of the block. ``rle_len[c, p]`` is the
    exact length of the run of equal bytes that starts at p - 1 and covers
    p, counted from p (0 when below 4)."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"find_matches: need (C, S) uint8 blocks, got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    C, S = blocks.shape
    dev = blocks.device
    b = blocks.to(torch.int64)
    w4 = b.clone()
    for k in (1, 2, 3):
        w4[:, : S - k] |= b[:, k:] << (8 * k)
    h = _hash(w4)

    # previous occurrence: sort by (hash, position), a key unique per lane
    pos = torch.arange(S, dtype=torch.int64, device=dev)
    _, order = torch.sort(h * S + pos, dim=1)
    hs = torch.gather(h, 1, order)
    ws = torch.gather(w4, 1, order)
    verified = torch.zeros((C, S), dtype=torch.bool, device=dev)
    verified[:, 1:] = (hs[:, 1:] == hs[:, :-1]) & (ws[:, 1:] == ws[:, :-1])
    off_sorted = torch.zeros((C, S), dtype=torch.int64, device=dev)
    off_sorted[:, 1:] = order[:, 1:] - order[:, :-1]
    off_sorted = torch.where(verified, off_sorted, 0)
    offset = torch.empty_like(off_sorted).scatter_(1, order, off_sorted)

    # offset-1 runs: the distance from p to the next position whose byte
    # differs from its predecessor's (a reverse running minimum)
    eq = torch.zeros((C, S), dtype=torch.bool, device=dev)
    eq[:, 1:] = blocks[:, 1:] == blocks[:, :-1]
    idx = pos.expand(C, S)
    boundary = torch.where(eq, S, idx)
    next_break = torch.cummin(boundary.flip(1), dim=1).values.flip(1)
    rle = (next_break - idx).clamp(min=0)
    rle = torch.where(rle >= 4, rle, 0)
    return offset.to(torch.int32), rle.to(torch.int32)


def compress_plane(plane: np.ndarray, block: int, *, device="cuda") -> list[bytes]:
    """A byte plane as independent LZ4 blocks of ``block`` bytes → the list
    of block payloads. The full blocks' match search runs on ``device`` in
    one call; the native emitter writes every block in one threaded call,
    and compresses the tail block (under ``block`` bytes) with the host's
    own matcher, as ``lz4_jax.compress_plane``. Needs the native library.
    Its spans: ``lz4_search`` (the copy of the blocks to the device and the
    search), ``lz4_d2h`` (``off`` and ``rle`` to the host, 8 bytes a plane
    byte, into the page-locked slots ``lz4_off`` and ``lz4_rle`` of
    :mod:`..staging`, which the emit consumes before this returns) and
    ``lz4_emit``."""
    plane = np.ascontiguousarray(plane, dtype=np.uint8).reshape(-1)
    n = len(plane)
    C = n // block
    if C == 0:
        return [native.lz4_compress(plane)] if n else []
    blocks = plane[: C * block].reshape(C, block)
    with profiling.span("lz4_search", nbytes=blocks.nbytes, sync=device):
        off, rle = find_matches(torch.from_numpy(blocks).to(device))
    with profiling.span("lz4_d2h", nbytes=(off.numel() * off.element_size()
                                           + rle.numel() * rle.element_size())):
        off = staging.to_host(off, "lz4_off")
        rle = staging.to_host(rle, "lz4_rle")
    with profiling.span("lz4_emit", nbytes=plane.nbytes):
        return native.lz4_emit_blocks(
            blocks, off, rle, tail=plane[C * block:] if n % block else None)
