"""Word-funnel residual packing, in PyTorch over the ``pair_compact_or`` kernel.

Counterpart of ``trico_tpu/codec/pack_funnel.py`` (its module notes give the
construction): groups of 4 values build their dense big-endian byte image as
4 u32 words by funnel shifts, each group word contributes to at most 2
destination words of the region, and two merging monotone compactions move
the contributions to their word lanes. Words are int32 tensors of u32 bits.
"""

from __future__ import annotations

import torch

from .. import _u32
from . import fp_cuda


def _pair_compact_or(dest, payload, live, L):
    """Items at lane s → lane dest[s], ORed where they meet. dest and
    s - dest must be nondecreasing over live lanes."""
    lanes = torch.arange(L, dtype=torch.int32, device=dest.device)[None, :]
    disp = lanes - dest
    carrier = torch.where(live, _u32.shl(disp, 1) | 1, 0).to(torch.int32)
    payload = torch.where(live, payload, 0).to(torch.int32)
    return fp_cuda.pair_compact_or(carrier, payload, max(L - 1, 1).bit_length())


def region_words_f32(length, res):
    """The residual byte region as big-endian u32 words.

    length: (C, L) int32 in 0..4, bytes emitted per value;
    res:    (C, L) int32 words, of which the low ``length`` bytes are
            emitted, big-endian.
    Returns (words (C, L) int32, n_res (C,) int32). Byte k of the region
    (k < n_res) is ``words[k >> 2] >> (8 * (3 - (k & 3)))``.
    """
    C, L = length.shape
    if L % 4:
        raise ValueError(f"region_words_f32 needs L % 4 == 0, got L={L}")
    Lg = L // 4
    dev = length.device
    cum = torch.cumsum(length, dim=1, dtype=torch.int32)
    off = cum - length  # exclusive prefix: byte offset of each value
    n_res = cum[:, -1]

    # left-aligned big-endian residual image (zeros below the live bytes)
    sh = 8 * (4 - length.clamp(min=1))
    A = torch.where(length > 0, _u32.shl(res, sh), 0)

    A4 = A.reshape(C, Lg, 4)
    LEN4 = length.reshape(C, Lg, 4)
    OFF4 = off.reshape(C, Lg, 4)
    lo = OFF4 - OFF4[:, :, 0:1]  # group-local byte offset, 0..15
    gsize = LEN4.sum(dim=2)

    # W[:, :, k] = bytes [4k, 4k+4) of the group's dense image: value j's top
    # byte sits at group byte lo_j, so it is shifted right by 8*(lo_j - 4k)
    # when it starts inside or after word k, left by 8*(4k - lo_j) otherwise
    k4 = torch.arange(4, dtype=torch.int32, device=dev)
    delta = 4 * k4[None, None, :, None] - lo[:, :, None, :]  # (C, Lg, k, j)
    Ab = A4[:, :, None, :]
    piece = torch.where(delta <= 0, _u32.shr(Ab, 8 * (-delta).clamp(0, 3)),
                        _u32.shl(Ab, 8 * delta.clamp(0, 3)))
    overlap = (delta > -4) & (delta < LEN4[:, :, None, :])
    piece = torch.where(overlap, piece, 0)
    # the pieces of one word come from disjoint bytes: OR them together
    W = piece[..., 0] | piece[..., 1] | piece[..., 2] | piece[..., 3]

    og = OFF4[:, :, 0]  # group start byte offset (C, Lg)
    r = (og & 3)[:, :, None]  # residue within the destination word
    c0 = _u32.shr(W, 8 * r)
    c1 = torch.where(r > 0, _u32.shl(W, (8 * (4 - r)) % 32), 0)
    dword = (og[:, :, None] + 4 * k4[None, None, :]) >> 2
    live = 4 * k4[None, None, :] < gsize[:, :, None]

    c0, c1 = c0.reshape(C, L), c1.reshape(C, L)
    dword, live = dword.reshape(C, L), live.reshape(C, L)
    T0 = _pair_compact_or(dword, c0, live, L)
    T1 = _pair_compact_or(dword + 1, c1, live & (c1 != 0), L)
    return T0 | T1, n_res


def region_bytes_f32(length, res):
    """(C, L) (length, res) → ((C, 4L) uint8 region bytes, (C,) n_res)."""
    C, L = length.shape
    words, n_res = region_words_f32(length, res)
    sh = 8 * (3 - torch.arange(4, dtype=torch.int32, device=length.device))
    b = (_u32.shr(words[:, :, None], sh) & 0xFF).to(torch.uint8).reshape(C, 4 * L)
    pos = torch.arange(4 * L, dtype=torch.int32, device=length.device)[None, :]
    return torch.where(pos < n_res[:, None], b, 0), n_res
