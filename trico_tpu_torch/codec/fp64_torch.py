"""The f64 chunk-parallel FCM/DFCM codec in the v2 "tpu" layout, in PyTorch.

Counterpart of ``trico_tpu/codec/fp64_jax.py``; the names match. A chunk of
L values (L even) is one independent reference f64 FP substream with its
group tags hoisted to the front:

    [u8 hash_info][u32 BE count][L/2 tag bytes][residual bytes]

zero-padded to ``f64_max_chunk_bytes(L)``. A tag byte holds the 4-bit
bcodes of two values, the first in the low nibble: 0..8 = FCM residual in
that many bytes, 9..15 = DFCM residual in bcode - 8 bytes (reference
fps.c:421-561). Encode is predict (``predict64_xors`` kernel, or the
``predict64_sort_xors`` kernel for tables it cannot hold), code choice, then the pack: one
``logshift`` compaction of 8 candidate bytes per value. Decode is the parse
(two ``logshift`` passes, as in f32), then the replay (``replay64`` kernel).

Device tensors carry u64 words as int64 bits (:mod:`trico_tpu_torch._u64`),
where the JAX package carries (hi, lo) u32 pairs with explicit carry and
borrow; the host functions at the end take and return NumPy arrays. The TPU
workarounds of the JAX module are not carried over: row blocking
(``_map_row_blocks``), ``_pad_rows``, the two-level ``_cumsum_l``, one-hot
table reads and the 1024-value slabs with carries in scratch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _u32, _u64
from . import fp_cuda, fp_torch
from .fp_cuda import _norm_exponents
from .fp_torch import hash_info

# The adaptive candidate sets of fp64_jax.py:532-536: the product default
# and the optimize="fast" profile. (10,16) and (20,20) take the sort kernel
# on encode and decode on host threads.
F64_TPU_CANDIDATES = ((4, 6), (10, 12), (10, 16), (20, 20))
F64_TPU_CANDIDATES_FAST = ((4, 6),)


def f64_max_chunk_bytes(L: int) -> int:
    if L % 2:
        raise ValueError(f"f64 chunk length must be even, got {L}")
    return 5 + L // 2 + 8 * L


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

# the sort formulation of the predictor, for tables that the predict64_xors
# kernel cannot hold: the predict64_sort_xors kernel (its plain version on
# CPU tensors), as fp64_jax._predict_sort64
_predict_sort64 = fp_cuda.predict64_sort_xors


def _predict_xors64(values, e1: int, e2: int):
    """(xor1, xor2) at normalised (e1, e2): the ``predict64_xors`` kernel
    where its u64 tables fit (:func:`fp_cuda.tables_fit`), the
    ``predict64_sort_xors`` kernel otherwise (fp64_jax.py:106-120). Both
    give the same words."""
    if fp_cuda.tables_fit((e1, e2), 8):
        return fp_cuda.predict64_xors(values, e1, e2)
    return _predict_sort64(values, e1, e2)


def predict_f64_chunks(values, e1: int = 20, e2: int = 20):
    """(C, L) int64 words → (bcode (C, L) uint8, res (C, L) int64)."""
    return _bcode_res_from_xors64(*_predict_xors64(
        values, *_norm_exponents(e1, e2)))


def _nbytes64(x, lo_bound: int):
    """Significant bytes of u64 words (0 for 0), at least ``lo_bound``. The
    arithmetic shift of a word with its top bit set is never 0, so it counts
    8 bytes as it should."""
    n = sum(((x >> (8 * k)) != 0).to(torch.int32) for k in range(8))
    return n.clamp(min=lo_bound)


def _bcode_res_from_xors64(xor1, xor2):
    """Per value: bcode 0..8 = FCM residual in that many bytes, 9..15 = DFCM
    residual in bcode - 8 bytes (DFCM iff at least 2 FCM bytes, strictly
    fewer DFCM bytes and at most 7; a zero DFCM residual still stores one
    byte); residual word."""
    nb1 = _nbytes64(xor1, 0)
    nb2 = _nbytes64(xor2, 1)
    use_dfcm = (nb1 >= 2) & (nb2 < nb1) & (nb2 <= 7)
    bcode = torch.where(use_dfcm, 8 + nb2, nb1)
    return bcode.to(torch.uint8), torch.where(use_dfcm, xor2, xor1)


def _glen64(bc):
    """Residual byte length of a 4-bit bcode: bc for 0..8, bc - 8 above."""
    bc = bc.to(torch.int32)
    return torch.where(bc > 8, bc - 8, bc)


def _res_byte64(res, b_idx):
    """Byte ``b_idx`` (0 = least significant) of (C, L) u64 words, for a
    (C, L, k) index; indices outside 0..7 read a clamped byte. The shift is
    arithmetic, but at most 56, so the low 8 bits are the byte."""
    return (res[:, :, None] >> (8 * b_idx.clamp(0, 7))) & 0xFF


def pack_f64_chunks_v2(bcode, res, e1: int = 20, e2: int = 20):
    """(C, L) (bcode, res) → ((C, B) uint8 v2 payloads, (C,) int32 sizes).

    Candidate byte k of value i (big-endian, k < its length) sits at slot
    8i + k and moves left by 8i - (bytes before value i): one monotone
    ``logshift`` compaction of the (C, 8L) slots, 8 payload bits each."""
    e1, e2 = _norm_exponents(e1, e2)
    C, L = bcode.shape
    G = L // 2
    B = f64_max_chunk_bytes(L)
    S = 8 * L
    dev = bcode.device
    bc = bcode.to(torch.int32)
    length = _glen64(bc)
    cum = torch.cumsum(length, dim=1, dtype=torch.int32)
    res_before = cum - length
    n_res = cum[:, -1]
    total = 5 + G + n_res

    hdr = torch.tensor([hash_info(e1, e2), (L >> 24) & 0xFF, (L >> 16) & 0xFF,
                        (L >> 8) & 0xFF, L & 0xFF], dtype=torch.uint8, device=dev)
    tags = (bc[:, 0::2] | (bc[:, 1::2] << 4)).to(torch.uint8)
    k = torch.arange(8, dtype=torch.int32, device=dev)[None, None, :]
    res_bytes = _res_byte64(res, length[:, :, None] - 1 - k).to(torch.int32)
    valid = (k < length[:, :, None]).reshape(C, S)
    i = torch.arange(L, dtype=torch.int32, device=dev)[None, :, None]
    move = (8 * i - res_before[:, :, None]).expand(C, L, 8).reshape(C, S)
    region = fp_torch._compact_monotone(res_bytes.reshape(C, S), move, valid, 8)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    region = torch.where(pos < n_res[:, None], region, 0).to(torch.uint8)
    out = torch.cat([hdr.expand(C, 5), tags, region], dim=1)
    assert out.shape == (C, B)
    return out, total


def encode_f64_chunks_v2(values, e1: int = 20, e2: int = 20):
    """(C, L) int64 words → ((C, B) uint8 v2 payloads, (C,) int32 sizes)."""
    bcode, res = predict_f64_chunks(values, e1, e2)
    return pack_f64_chunks_v2(bcode, res, e1, e2)


def encode_f64_chunks_v2_adaptive(values, candidates=F64_TPU_CANDIDATES):
    """Per-chunk choice of exponents among ``candidates``: one predictor per
    candidate (no grouping, fp64_jax.py:555-584), exact sizes from the
    bcodes, the smallest payload wins (the first candidate on ties), one
    pack, each chunk stamped with its own hash_info byte."""
    C, L = values.shape
    G = L // 2
    norm = [_norm_exponents(e1, e2) for (e1, e2) in candidates]
    bcs, ress, sizes = [], [], []
    for e1, e2 in norm:
        bc, res = _bcode_res_from_xors64(*_predict_xors64(values, e1, e2))
        bcs.append(bc)
        ress.append(res)
        sizes.append(5 + G + _glen64(bc).sum(dim=1, dtype=torch.int32))
    choice, (bc, res) = fp_torch._choose(sizes, bcs, ress)
    payloads, total = pack_f64_chunks_v2(bc, res, *norm[0])
    fp_torch._stamp_hash_info(payloads, norm, choice)
    return payloads, total


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def parse_f64_chunks_v2(payloads, L: int, e1: int = 20, e2: int = 20):
    """(C, B) uint8 v2 payloads → ((C, L) uint8 bcodes, (C, L) int64 xors).

    The inverse of the pack: the slot ids are compacted to rank order, then
    the region bytes are expanded to their slots (two monotone ``logshift``
    passes over S = 8L slots), and each value's bytes are put together in
    its two u32 halves."""
    C, B = payloads.shape
    if L % 2:
        raise ValueError(f"f64 chunk length must be even, got {L}")
    G = L // 2
    S = 8 * L
    dev = payloads.device
    tags = payloads[:, 5 : 5 + G].to(torch.int32)
    bcodes = torch.stack([tags & 15, tags >> 4], dim=2).reshape(C, L)
    lens = _glen64(bcodes)
    cum = torch.cumsum(lens, dim=1, dtype=torch.int32)
    res_before = cum - lens
    n_res = cum[:, -1]

    k = torch.arange(8, dtype=torch.int32, device=dev)[None, None, :]
    valid = k < lens[:, :, None]
    sbits = fp_cuda._nbits(S)  # payload bits of a slot id
    i = torch.arange(L, dtype=torch.int32, device=dev)[None, :, None]
    move = (8 * i - res_before[:, :, None]).expand(C, L, 8).reshape(C, S)
    slot_id = torch.arange(S, dtype=torch.int32, device=dev).expand(C, S)
    slot_by_rank = fp_torch._compact_monotone(slot_id, move,
                                              valid.reshape(C, S), sbits)

    region = payloads[:, 5 + G : 5 + G + S].to(torch.int32)
    ranks = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    bytes_by_slot = fp_torch._expand_monotone(
        region, slot_by_rank - ranks, ranks < n_res[:, None], 8).reshape(C, L, 8)

    b_idx = lens[:, :, None] - 1 - k  # the byte's place, 0 = least significant
    part = torch.where(valid, bytes_by_slot.to(torch.int64) << (8 * (b_idx & 3)), 0)
    lo = torch.where(b_idx < 4, part, 0).sum(dim=2)
    hi = torch.where(b_idx >= 4, part, 0).sum(dim=2)
    return bcodes.to(torch.uint8), _u64.join(_u32.narrow(hi), lo)


def replay_f64_chunks(bcodes, xors, e1: int = 20, e2: int = 20):
    """Replay the predictors over parsed (C, L) (bcode, xor) → int64 values."""
    return fp_cuda.replay64(bcodes, xors, e1, e2)


def decode_f64_chunks_v2(payloads, L: int, e1: int = 20, e2: int = 20):
    """(C, B) uint8 v2 payloads → (C, L) int64 words: parse, then replay."""
    bcodes, xors = parse_f64_chunks_v2(payloads, L, e1, e2)
    return replay_f64_chunks(bcodes, xors, e1, e2)


def relayout_f64_v2_to_v1(payload: np.ndarray) -> np.ndarray:
    """Host reorder of one f64 v2 substream to the reference layout (NumPy;
    the same function as ``fp64_jax.relayout_f64_v2_to_v1``)."""
    p = np.asarray(payload, np.uint8)
    n = int.from_bytes(p[1:5].tobytes(), "big")
    G = (n + 1) // 2
    tags = p[5 : 5 + G]
    res = p[5 + G :]
    lens_tab = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 5, 6, 7], np.int64)
    glen = lens_tab[tags & 15] + lens_tab[(tags >> 4) & 15]
    ends = np.cumsum(glen)
    starts = ends - glen
    pieces = [p[:5]]
    for g in range(G):
        pieces.append(tags[g : g + 1])
        pieces.append(res[starts[g] : ends[g]])
    return np.concatenate(pieces)


# ---------------------------------------------------------------------------
# host entry points: NumPy in, NumPy out
# ---------------------------------------------------------------------------


def _encode_host(values_u64: np.ndarray, chunk_len: int, device, encode):
    chunk_len = (chunk_len // 2) * 2 or 2
    C, chunks, tail = fp_torch._split(values_u64, chunk_len)
    if C == 0:
        B = f64_max_chunk_bytes(chunk_len)
        return np.zeros((0, B), np.uint8), np.zeros(0, np.int64), tail
    out, sizes = encode(_u64.from_numpy(chunks).to(device))
    return out.cpu().numpy(), sizes.cpu().numpy().astype(np.int64), tail


def _pack_ref(x, e1: int, e2: int):
    """Reference-layout payloads of (C, L) int64 words: the device predictor,
    then the host library's pack (fp64_jax.py:290-310)."""
    fn = fp_torch._host_lib().tt_fp64_pack_chunks
    e1, e2 = _norm_exponents(e1, e2)
    L = x.shape[1]
    out, sizes = fp_torch.pack_native(fn, *predict_f64_chunks(x, e1, e2), L,
                                      e1, e2, f64_max_chunk_bytes(L))
    return torch.from_numpy(out), torch.from_numpy(sizes)


def encode_f64(values_u64: np.ndarray, chunk_len: int, e1: int = 20,
               e2: int = 20, layout: str = "tpu", *, device="cuda"):
    """Encode a flat uint64 stream in chunks of ``chunk_len`` (rounded down
    to even) on ``device``, in v2 chunks (``layout="tpu"``) or in the
    reference layout (``"ref"``, packed by the C++ host library).

    Returns (payloads (C, B) uint8, sizes (C,) int64, tail_values); the tail
    is left for the caller's host codec."""
    fp_torch._check_layout(layout)
    if layout == "ref":
        return _encode_host(values_u64, chunk_len, device,
                            lambda x: _pack_ref(x, e1, e2))
    return _encode_host(values_u64, chunk_len, device,
                        lambda x: encode_f64_chunks_v2(x, e1, e2))


def encode_f64_adaptive(values_u64: np.ndarray, chunk_len: int,
                        candidates=F64_TPU_CANDIDATES, layout: str = "tpu",
                        *, device="cuda"):
    """Adaptive per-chunk exponent f64 encode of a flat uint64 stream; see
    :func:`encode_f64_chunks_v2_adaptive`. Returns as :func:`encode_f64`.
    As in ``fp64_jax``, there is no reference-layout form of it."""
    if layout != "tpu":
        raise ValueError("adaptive f64 encode requires layout='tpu'")
    return _encode_host(values_u64, chunk_len, device,
                        lambda x: encode_f64_chunks_v2_adaptive(x, tuple(candidates)))


def decode_f64(payloads: np.ndarray, chunk_len: int, e1: int = 20,
               e2: int = 20, layout: str = "tpu", *, device="cuda") -> np.ndarray:
    """Decode (C, B) padded chunk payloads of one layout → flat uint64
    values; reference-layout chunks are parsed by the C++ host library and
    replayed on ``device`` (fp64_jax.py:355-375)."""
    fp_torch._check_layout(layout)
    if len(payloads) == 0:
        return np.zeros(0, np.uint64)
    if layout == "ref":
        bc, xo = fp_torch.parse_native(fp_torch._host_lib().tt_fp64_parse_chunks,
                                       payloads, chunk_len, np.uint64)
        vals = replay_f64_chunks(torch.from_numpy(bc).to(device),
                                 _u64.from_numpy(xo).to(device), e1, e2)
        return _u64.to_numpy(vals).reshape(-1)
    p = torch.from_numpy(np.ascontiguousarray(payloads, np.uint8)).to(device)
    return _u64.to_numpy(decode_f64_chunks_v2(p, chunk_len, e1, e2)).reshape(-1)
