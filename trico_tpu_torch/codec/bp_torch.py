"""BP32 and BP64, the bit-plane integer codec, in PyTorch.

Counterpart of ``trico_tpu/codec/bp_jax.py``; the names match and the bytes
are the same. The format is ``trico_tpu/codec/bp_ref.py``'s: per chunk of L
values (L a multiple of 32), zigzag deltas that restart from 0, groups of 32
values with one bit width each, and each group's ``w`` bit planes stored as
32-bit little-endian words:

    [u8 widths[L/32]] [group 0: w_0 planes x 4 bytes] [group 1: ...]

zero-padded to ``bp32_max_chunk_bytes(L)`` (or ``bp64_max_chunk_bytes``).
Plane b of a group is the 32x32 bit transpose of its 32 zigzag words (bit j
of plane b = bit b of value j), so both directions build the planes with one
transpose of five mask-and-shift stages. Encode moves the live plane bytes
left with one monotone compaction (the ``logshift`` kernel, 8 payload bits);
decode compacts the slot ids to rank order (``logshift``, ``ceil(log2 S)``
payload bits: 16 at L = 16384 for BP32 and L = 8192 for BP64, where the word
fills all 32 bits) and expands the bytes right to their slots (``logshift``,
8 bits), as the f32 and f64 parses do.

u32 words are int32 tensors of their bits (:mod:`trico_tpu_torch._u32`) and
u64 words int64 tensors of their bits (:mod:`trico_tpu_torch._u64`). The
planes, candidate bytes and slot words stay in int32, the size the values
need: at the largest shapes a (C, 8L) slot array holds hundreds of millions
of words. A group's width is the bit length of the OR of its words, which
is the bit length of their unsigned maximum without an unsigned compare.
The TPU workarounds of the JAX module are not carried over: row blocking
(``_map_row_blocks``), ``_cumsum_l`` and the 16-bit-limb u64 cumsum with its
L <= 65536 limit. Bytes are identical without them.
"""

from __future__ import annotations

import torch

from .. import _u32, _u64
from . import fp_cuda, fp_torch

GROUP = 32
# The largest BP64 chunk: its decode compacts 16-bit slot ids of S = 8L
# slots through the 32-bit logshift word (trico_tpu/chunked.py:481-484).
BP64_MAX_CHUNK = 8192
_LOW63 = (1 << 63) - 1


def bp32_max_chunk_bytes(L: int) -> int:
    if L % GROUP:
        raise ValueError(f"BP chunk length must be a multiple of 32, got {L}")
    return L // GROUP + 4 * L  # width header + all 32 planes live


def bp64_max_chunk_bytes(L: int) -> int:
    if L % GROUP:
        raise ValueError(f"BP chunk length must be a multiple of 32, got {L}")
    return L // GROUP + 8 * L  # width header + all 64 planes live


def _transpose32(x: torch.Tensor) -> torch.Tensor:
    """(..., 32) int32 words → their bit transpose: bit j of out[..., b] =
    bit b of x[..., j]. Five stages, each swapping the off-diagonal blocks
    of every 2j x 2j block (Hacker's Delight 7-3); the transpose is its own
    inverse. The copies of the sign bit that ``>>`` brings in land only on
    bits that the stage's mask clears."""
    shape = x.shape
    for j, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                 (2, 0x33333333), (1, 0x55555555)):
        v = x.reshape(*shape[:-1], GROUP // (2 * j), 2, j)
        a, b = v[..., 0, :], v[..., 1, :]
        t = ((a >> j) ^ b) & m
        x = torch.stack([a ^ (t << j), b ^ t], dim=-2).reshape(shape)
    return x


def _widths(z: torch.Tensor, bits: int) -> torch.Tensor:
    """(C, G, 32) zigzag words of ``bits`` bits → (C, G) int32 group widths:
    the bit length of the OR of the group, 0 for an all-zero group. With the
    top bit set, ``>>`` never reaches 0, so such a group counts ``bits``."""
    while z.shape[-1] > 1:
        half = z.shape[-1] // 2
        z = z[..., :half] | z[..., half:]
    z = z[..., 0]
    return sum(((z >> b) != 0).to(torch.int32) for b in range(bits))


def _slots(w: torch.Tensor, P: int):
    """The slot geometry of (C, G) widths with P planes a group: slot
    (g, b, k) is byte k of plane b of group g, at 4Pg + 4b + k. Returns
    (live (C, S) bool, move (C, S) int32, plane bytes (C,) int32): a live
    slot (b < w_g) lands at 4 * (planes before group g) + 4b + k, so it
    moves left by 4Pg - 4 * before_g, nondecreasing along the row."""
    C, G = w.shape
    S = 4 * P * G
    dev = w.device
    cumw = torch.cumsum(w, dim=1, dtype=torch.int32)
    before = cumw - w
    b_idx = torch.arange(P, dtype=torch.int32, device=dev)[None, None, :, None]
    live = (b_idx < w[:, :, None, None]).expand(C, G, P, 4).reshape(C, S)
    g_idx = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
    move_g = 4 * P * g_idx - 4 * before
    move = move_g[:, :, None].expand(C, G, 4 * P).reshape(C, S)
    return live, move, 4 * cumw[:, -1]


def _pack(planes: torch.Tensor, w: torch.Tensor):
    """(C, G, P) int32 plane words and (C, G) int32 widths → ((C, G + 4PG)
    uint8 payloads, (C,) int32 sizes)."""
    C, G, P = planes.shape
    live, move, n_bytes = _slots(w, P)
    k = 8 * torch.arange(4, dtype=torch.int32, device=planes.device)
    # the arithmetic shift leaves the low 8 bits of each byte intact
    cand = ((planes[..., None] >> k) & 0xFF).reshape(C, -1)
    region = fp_torch._compact_monotone(cand, move, live, 8).to(torch.uint8)
    out = torch.cat([w.to(torch.uint8), region], dim=1)
    return out, G + n_bytes


def _unpack(payloads: torch.Tensor, L: int, P: int) -> torch.Tensor:
    """(C, B) uint8 payloads → (C, L/32, P) int32 plane words. The widths
    must have been validated (at most P, sizes matching)."""
    C = payloads.shape[0]
    G = L // GROUP
    S = 4 * P * G
    dev = payloads.device
    w = payloads[:, :G].to(torch.int32)
    region = payloads[:, G : G + S].to(torch.int32)
    live, move, n_bytes = _slots(w, P)
    slot_id = torch.arange(S, dtype=torch.int32, device=dev).expand(C, S)
    slot_by_rank = fp_torch._compact_monotone(slot_id, move, live,
                                              fp_cuda._nbits(S))
    ranks = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    by_slot = fp_torch._expand_monotone(region, slot_by_rank - ranks,
                                        ranks < n_bytes[:, None], 8)
    by_slot = by_slot.reshape(C, G, P, 4)
    return (by_slot[..., 0] | (by_slot[..., 1] << 8) | (by_slot[..., 2] << 16)
            | (by_slot[..., 3] << 24))


def _check_rows(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype or t.dim() != 2 or t.shape[1] % GROUP:
        raise ValueError(f"{what}: need a 2-D {dtype} tensor whose rows are a "
                         f"multiple of 32, got {t.dtype} {tuple(t.shape)}")


def _check_payloads(payloads: torch.Tensor, B: int, what: str) -> None:
    if payloads.dtype != torch.uint8 or payloads.dim() != 2 \
            or payloads.shape[1] != B:
        raise ValueError(f"{what}: need (C, {B}) uint8 payload rows, got "
                         f"{payloads.dtype} {tuple(payloads.shape)}")


# ---------------------------------------------------------------------------
# BP32
# ---------------------------------------------------------------------------


def encode_bp32_chunks(values: torch.Tensor):
    """(C, L) int32 words → ((C, B) uint8 payloads, (C,) int32 sizes)."""
    _check_rows(values, torch.int32, "encode_bp32_chunks")
    C, L = values.shape
    d = values - fp_cuda._shift_right(values, 1)  # wraps mod 2^32
    z = ((d << 1) ^ (d >> 31)).reshape(C, L // GROUP, GROUP)  # zigzag
    return _pack(_transpose32(z), _widths(z, 32))


def decode_bp32_chunks(payloads: torch.Tensor, L: int) -> torch.Tensor:
    """(C, B) uint8 BP32 payloads → (C, L) int32 words."""
    _check_payloads(payloads, bp32_max_chunk_bytes(L), "decode_bp32_chunks")
    C = payloads.shape[0]
    z = _transpose32(_unpack(payloads, L, GROUP)).reshape(C, L)
    d = ((z >> 1) & 0x7FFFFFFF) ^ -(z & 1)
    # int32 deltas: their int64 sum is exact and equals the u32 sum mod 2^32
    return _u32.narrow(torch.cumsum(d, dim=1, dtype=torch.int64))


# ---------------------------------------------------------------------------
# BP64: planes 0-31 from the low halves of the zigzag words, 32-63 from the
# high halves; a group's width is the bit length of the OR of its 64-bit
# words (32 + bits of the high halves when any is nonzero, else bits of the
# low halves, as bp_jax computes it).
# ---------------------------------------------------------------------------


def encode_bp64_chunks(values: torch.Tensor):
    """(C, L) int64 words → ((C, B) uint8 payloads, (C,) int32 sizes)."""
    _check_rows(values, torch.int64, "encode_bp64_chunks")
    C, L = values.shape
    d = values - fp_cuda._shift_right(values, 1)  # wraps mod 2^64
    z = (d + d) ^ (d >> 63)  # zigzag; d + d is d << 1 without a signed shift
    z = z.reshape(C, L // GROUP, GROUP)
    lo = _transpose32(_u32.narrow(z))
    hi = _transpose32(_u32.narrow(z >> 32))
    return _pack(torch.cat([lo, hi], dim=2), _widths(z, 64))


def decode_bp64_chunks(payloads: torch.Tensor, L: int) -> torch.Tensor:
    """(C, B) uint8 BP64 payloads → (C, L) int64 words."""
    _check_payloads(payloads, bp64_max_chunk_bytes(L), "decode_bp64_chunks")
    C = payloads.shape[0]
    planes = _unpack(payloads, L, 2 * GROUP)
    lo = _transpose32(planes[..., :GROUP]).reshape(C, L)
    hi = _transpose32(planes[..., GROUP:]).reshape(C, L)
    z = _u64.join(hi, lo)
    d = ((z >> 1) & _LOW63) ^ -(z & 1)  # >> is arithmetic: mask bit 63
    return torch.cumsum(d, dim=1)  # wraps mod 2^64
