"""The f32 chunk-parallel FCM/DFCM codec in the v2 "tpu" layout, in PyTorch.

Counterpart of ``trico_tpu/codec/fp_jax.py``; the names match. A chunk of L
values is one independent reference FP substream, in one of two layouts. The
v2 "tpu" layout hoists the group tags to the front:

    [u8 hash_info][u32 BE count][3*L/8 tag bytes][residual bytes]

zero-padded to ``f32_max_chunk_bytes(L)``. Encode is predict (``predict_xors``
kernel, or the ``predict_sort_xors`` kernel for tables it cannot hold), code choice,
then the pack: tags, then the residual region through :mod:`.pack_funnel`.
The adaptive encode predicts every candidate (grouped by e2, with the
``fcm_multi_xors`` kernel for extra FCM exponents) and keeps each chunk's
smallest. Decode is the parse (two ``logshift`` kernel passes), then the
replay (``replay`` kernel). The reference layout keeps each group's 3 tag
bytes in front of its residual bytes, as the reference library writes them:
``pack_f32_chunks`` lays every candidate byte out in emission order and
compacts the row with one ``logshift`` pass; ``parse_f32_chunks`` finds the
tags, whose positions depend on the data, by pointer doubling and gathers
the residual bytes. Device tensors carry u32 words as int32 bits
(:mod:`trico_tpu_torch._u32`); the host functions at the end take and
return NumPy arrays, like their JAX counterparts.

The TPU workarounds of the JAX module are not carried over: row blocking
against an XLA:TPU miscompile (``_map_row_blocks``), bucketing rows to powers
of two (``_pad_rows``), the two-level cumsum and one-hot table reads. Bytes
are identical without them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _u32, native
from . import fp_cuda
from .fp_cuda import _norm_exponents
from .pack_funnel import region_bytes_f32

# The adaptive candidate sets of fp_jax.py:790-791: the product default and
# the optimize="fast" profile.
F32_TPU_CANDIDATES = ((0, 6), (4, 6), (4, 10), (14, 18))
F32_TPU_CANDIDATES_FAST = ((0, 6), (4, 6))


def hash_info(e1: int, e2: int) -> int:
    """The substream's first byte for normalised exponents (fps.c:120-121)."""
    return ((e1 >> 1) << 4) | (e2 >> 1)


def exponents(info: int) -> tuple[int, int]:
    """Inverse of :func:`hash_info`."""
    return (info >> 4) << 1, (info & 15) << 1


def f32_max_chunk_bytes(L: int) -> int:
    if L % 8:
        raise ValueError(f"chunk length must be a multiple of 8, got {L}")
    return 5 + 3 * (L // 8) + 4 * L


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _bcode_res_from_xors(xor1, xor2):
    """Per value: bcode 0..4 = FCM residual in that many bytes, 5..7 = DFCM
    residual in 1..3 bytes (DFCM iff strictly shorter); residual word."""
    def nbytes(x):
        return torch.where((x & -256) == 0, 1,
                           torch.where((x & -65536) == 0, 2,
                                       torch.where((x & -(1 << 24)) == 0, 3, 4)))

    nb1 = torch.where(xor1 == 0, 0, nbytes(xor1))
    nb2 = nbytes(xor2)
    use_dfcm = (nb1 >= 2) & (nb2 < nb1)
    bcode = torch.where(use_dfcm, 4 + nb2, nb1)
    res = torch.where(use_dfcm, xor2, xor1)
    return bcode.to(torch.uint8), res


def _glen32(bc):
    """Residual byte length of a 3-bit bcode: [0,1,2,3,4,1,2,3][bc]."""
    bc = bc.to(torch.int32)
    return torch.where(bc >= 5, bc - 4, bc)


# the sort formulation of the predictor, for tables that the predict_xors
# kernel cannot hold: the predict_sort_xors kernel (its plain version on CPU
# tensors), as fp_jax._predict_sort
_predict_sort = fp_cuda.predict_sort_xors


def _candidate_xors_one(values, e1: int, e2: int):
    """(xor1, xor2) at normalised (e1, e2): the ``predict_xors`` kernel where
    its tables fit (:func:`fp_cuda.tables_fit`), the ``predict_sort_xors``
    kernel otherwise, as ``fp_jax`` routes past its VMEM budget
    (fp_jax.py:188-195). Both give the same words."""
    if fp_cuda.tables_fit((e1, e2)):
        return fp_cuda.predict_xors(values, e1, e2)
    return _predict_sort(values, e1, e2)


def predict_f32_chunks(values, e1: int = 4, e2: int = 10):
    """(C, L) int32 words → (bcode (C, L) uint8, res (C, L) int32)."""
    return _bcode_res_from_xors(*_candidate_xors_one(
        values, *_norm_exponents(e1, e2)))


def _header_bytes(L: int, e1: int, e2: int, dev) -> torch.Tensor:
    """The 5 bytes in front of a chunk: hash_info, then L big-endian."""
    return torch.tensor([hash_info(e1, e2), (L >> 24) & 0xFF, (L >> 16) & 0xFF,
                         (L >> 8) & 0xFF, L & 0xFF], dtype=torch.uint8, device=dev)


def _tag_bytes(bc: torch.Tensor) -> torch.Tensor:
    """(C, L) int32 bcodes → (C, L/8, 3) int32 tag bytes: eight 3-bit codes
    a group, slot 0 in the low bits, stored big-endian."""
    C, L = bc.shape
    shifts = 3 * torch.arange(8, dtype=torch.int32, device=bc.device)
    tag24 = (bc.reshape(C, L // 8, 8) << shifts).sum(dim=2, dtype=torch.int32)
    return torch.stack([(tag24 >> 16) & 0xFF, (tag24 >> 8) & 0xFF, tag24 & 0xFF],
                       dim=2)


def pack_f32_chunks_v2(bcode, res, e1: int = 4, e2: int = 10):
    """(C, L) (bcode, res) → ((C, B) uint8 v2 payloads, (C,) int32 sizes)."""
    e1, e2 = _norm_exponents(e1, e2)
    C, L = bcode.shape
    G = L // 8
    B = f32_max_chunk_bytes(L)
    bc = bcode.to(torch.int32)
    length = _glen32(bc)
    total = 5 + 3 * G + length.sum(dim=1, dtype=torch.int32)
    hdr = _header_bytes(L, e1, e2, bcode.device)
    tags = _tag_bytes(bc).reshape(C, 3 * G).to(torch.uint8)
    region, _ = region_bytes_f32(length, res)
    out = torch.cat([hdr.expand(C, 5), tags, region], dim=1)
    assert out.shape == (C, B)
    return out, total


def encode_f32_chunks_v2(values, e1: int = 4, e2: int = 10):
    """(C, L) int32 words → ((C, B) uint8 v2 payloads, (C,) int32 sizes)."""
    bcode, res = predict_f32_chunks(values, e1, e2)
    return pack_f32_chunks_v2(bcode, res, e1, e2)


def _candidate_xors(values, norm):
    """(xor1, xor2) per normalised candidate, sharing predictor work.

    The FCM xor depends only on e1 and the DFCM xor only on e2, so the
    candidates are grouped by e2 (fp_jax.py:822-867): a group of several
    distinct e1s with e2 > 0, one of them nonzero, whose tables fit, takes
    one ``predict_xors`` pass at (first nonzero e1, e2), one
    ``fcm_multi_xors`` pass for its other nonzero e1s, and ``v ^ vprev`` for
    e1 = 0. Every other candidate takes its own predictor."""
    results = [None] * len(norm)
    by_e2: dict = {}
    for i, (e1, e2) in enumerate(norm):
        by_e2.setdefault(e2, []).append(i)
    for e2, idxs in by_e2.items():
        e1s = [norm[i][0] for i in idxs]
        nonzero = [e1 for e1 in dict.fromkeys(e1s) if e1]
        main, rest = (nonzero[0], tuple(nonzero[1:])) if nonzero else (0, ())
        fusable = (len(idxs) > 1 and e2 > 0 and nonzero
                   and len(set(e1s)) == len(e1s)
                   and fp_cuda.tables_fit((main, e2))
                   and len(rest) <= fp_cuda.MAX_FCM
                   and fp_cuda.tables_fit(rest))
        if not fusable:
            for i in idxs:
                results[i] = _candidate_xors_one(values, *norm[i])
            continue
        xor1 = {}
        xor1[main], xor2 = fp_cuda.predict_xors(values, main, e2)
        if rest:
            xor1.update(zip(rest, fp_cuda.fcm_multi_xors(values, rest)))
        if 0 in e1s:
            xor1[0] = values ^ fp_cuda._shift_right(values, 1)
        for i in idxs:
            results[i] = (xor1[norm[i][0]], xor2)
    return results


def _choose(sizes, *per_candidate):
    """The first minimum of the per-candidate (C,) ``sizes`` for each chunk
    (first candidate on ties, as the host optimizer), and for each list of
    per-candidate (C, L) arrays the chosen rows."""
    choice = torch.argmin(torch.stack(sizes), dim=0)
    rows = torch.arange(len(choice), device=choice.device)
    return choice, [torch.stack(xs)[choice, rows] for xs in per_candidate]


def _stamp_hash_info(payloads, norm, choice) -> None:
    """Write each chunk's chosen exponents into its hash_info byte."""
    infos = torch.tensor([hash_info(*e) for e in norm], dtype=torch.uint8,
                         device=payloads.device)
    payloads[:, 0] = infos[choice]


def encode_f32_chunks_v2_adaptive(values, candidates=F32_TPU_CANDIDATES):
    """Per-chunk choice of exponents among ``candidates``: exact sizes from
    each candidate's bcodes, the smallest payload wins (the first candidate
    on ties), one pack, each chunk stamped with its own hash_info byte
    (fp_jax.py:879-907). Any candidate set is taken."""
    C, L = values.shape
    G = L // 8
    norm = [_norm_exponents(e1, e2) for (e1, e2) in candidates]
    bcs, ress, sizes = [], [], []
    for xor1, xor2 in _candidate_xors(values, norm):
        bc, res = _bcode_res_from_xors(xor1, xor2)
        bcs.append(bc)
        ress.append(res)
        sizes.append(5 + 3 * G + _glen32(bc).sum(dim=1, dtype=torch.int32))
    choice, (bc, res) = _choose(sizes, bcs, ress)
    payloads, total = pack_f32_chunks_v2(bc, res, *norm[0])
    _stamp_hash_info(payloads, norm, choice)
    return payloads, total


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _move_monotone(payload, shift, valid, pb, direction):
    """Pack live (C, S) int32 (shift, payload) pairs into ``shift << pb |
    payload`` words and move them. A live shift is below S, so the word
    fits 32 bits. It is built in int32, where ``<<`` shifts the unsigned
    bits (:mod:`trico_tpu_torch._u32`), so no int64 copy of the (C, S)
    slots is made, and a word whose top bit is set (pb + ceil(log2 S) = 32)
    keeps its bits."""
    S = payload.shape[1]
    if pb + fp_cuda._nbits(S) > 32:
        raise ValueError("log-shift word overflow")
    word = torch.where(valid, (shift.to(torch.int32) << pb) | payload, 0)
    return fp_cuda.logshift(word.to(torch.int32), pb, direction)


def _compact_monotone(payload, shift, valid, pb):
    """Move the live element at lane p left by shift[p] (monotone); (C, S)."""
    return _move_monotone(payload, shift, valid, pb, "left")


def _expand_monotone(payload, shift, valid, pb):
    """Move the live element at lane p right by shift[p] (monotone); (C, S)."""
    return _move_monotone(payload, shift, valid, pb, "right")


def parse_f32_chunks_v2(payloads, L: int, e1: int = 4, e2: int = 10):
    """(C, B) uint8 v2 payloads → ((C, L) uint8 bcodes, (C, L) int32 xors).

    Tags sit at fixed offsets. The residual bytes move in two monotone
    passes: the slot ids are compacted to rank order (the inverse of the
    pack), then the region bytes are expanded to their slots."""
    C, B = payloads.shape
    if L % 8:
        raise ValueError(f"chunk length must be a multiple of 8, got {L}")
    G = L // 8
    S = 4 * L  # residual byte slots, 4 per value
    dev = payloads.device
    tags = payloads[:, 5 : 5 + 3 * G].to(torch.int32).reshape(C, G, 3)
    tag24 = (tags[:, :, 0] << 16) | (tags[:, :, 1] << 8) | tags[:, :, 2]
    shifts = 3 * torch.arange(8, dtype=torch.int32, device=dev)
    bcodes = ((tag24[:, :, None] >> shifts) & 7).reshape(C, L)
    lens = _glen32(bcodes)
    cum = torch.cumsum(lens, dim=1, dtype=torch.int32)
    res_before = cum - lens
    n_res = cum[:, -1]

    k = torch.arange(4, dtype=torch.int32, device=dev)[None, None, :]
    valid = (k < lens[:, :, None]).reshape(C, S)
    sbits = max(S - 1, 1).bit_length()  # payload bits of a slot id
    i = torch.arange(L, dtype=torch.int32, device=dev)[None, :, None]
    move = (4 * i - res_before[:, :, None]).expand(C, L, 4).reshape(C, S)
    slot_id = torch.arange(S, dtype=torch.int32, device=dev).expand(C, S)
    slot_by_rank = _compact_monotone(slot_id, move, valid, sbits)

    region = payloads[:, 5 + 3 * G : 5 + 3 * G + S].to(torch.int32)
    ranks = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    bytes_by_slot = _expand_monotone(region, slot_by_rank - ranks,
                                     ranks < n_res[:, None], 8).reshape(C, L, 4)

    shift = 8 * (lens[:, :, None] - 1 - k).clamp(0, 3)
    part = torch.where(valid.reshape(C, L, 4),
                       _u32.shl(bytes_by_slot, shift), 0)
    xors = part[..., 0] | part[..., 1] | part[..., 2] | part[..., 3]
    return bcodes.to(torch.uint8), xors


def replay_f32_chunks(bcodes, xors, e1: int = 4, e2: int = 10):
    """Replay the predictors over parsed (C, L) (bcode, xor) → int32 values."""
    return fp_cuda.replay(bcodes, xors, e1, e2)


def decode_f32_chunks_v2(payloads, L: int, e1: int = 4, e2: int = 10):
    """(C, B) uint8 v2 payloads → (C, L) int32 words: parse, then replay."""
    bcodes, xors = parse_f32_chunks_v2(payloads, L, e1, e2)
    return replay_f32_chunks(bcodes, xors, e1, e2)


# ---------------------------------------------------------------------------
# the reference layout on the device (fp_jax.py:348-551)
# ---------------------------------------------------------------------------


def pack_f32_chunks(bcode, res, e1: int = 4, e2: int = 10):
    """(C, L) (bcode, res) → ((C, B) uint8 reference-layout payloads, (C,)
    int32 sizes).

    Every byte the chunk may emit is laid out in emission order: 5 header
    bytes, then for each group of 8 values its 3 tag bytes and 32 residual
    byte candidates, of which the first ``length`` of each value are live.
    A candidate's distance to its place in the stream never falls along the
    row, so one monotone left compaction (``logshift``, 8 payload bits) over
    the S = 5 + 35 L / 8 candidates, which is also B, writes the payload;
    where nothing lands, past the chunk's size, it leaves zeros."""
    e1, e2 = _norm_exponents(e1, e2)
    C, L = bcode.shape
    G = L // 8
    dev = bcode.device
    bc = bcode.to(torch.int32)
    length = _glen32(bc)
    cum = torch.cumsum(length, dim=1, dtype=torch.int32)
    res_before = cum - length
    total = 5 + 3 * G + cum[:, -1]

    # a group's tags move left by the residual candidates left out before it
    tag_move = (32 * torch.arange(G, dtype=torch.int32, device=dev)[None, :]
                - res_before[:, ::8])[:, :, None].expand(C, G, 3)
    # residual bytes, big-endian, the low `length` bytes of each word (the
    # shift is arithmetic, which leaves the low byte as a logical one would)
    k = torch.arange(4, dtype=torch.int32, device=dev)
    shift = 8 * (length[:, :, None] - 1 - k).clamp(0, 3)
    res_bytes = (res[:, :, None] >> shift) & 0xFF
    res_valid = k < length[:, :, None]
    i = torch.arange(L, dtype=torch.int32, device=dev)[None, :, None]
    res_move = (4 * i - res_before[:, :, None]).expand(C, L, 4)

    def rows(head, tag, residual):
        """[head | per group (3 tag entries, 32 residual entries)]."""
        grp = torch.cat([tag, residual.reshape(C, G, 32)], dim=2)
        return torch.cat([head, grp.reshape(C, 35 * G)], dim=1)

    byte = rows(_header_bytes(L, e1, e2, dev).to(torch.int32).expand(C, 5),
                _tag_bytes(bc), res_bytes)
    move = rows(torch.zeros((C, 5), dtype=torch.int32, device=dev),
                tag_move, res_move)
    valid = rows(torch.ones((C, 5), dtype=torch.bool, device=dev),
                 torch.ones((C, G, 3), dtype=torch.bool, device=dev), res_valid)
    out = _compact_monotone(byte, move, valid, 8)
    assert out.shape == (C, f32_max_chunk_bytes(L))
    return out.to(torch.uint8), total


def encode_f32_chunks(values, e1: int = 4, e2: int = 10):
    """(C, L) int32 words → ((C, B) uint8 reference-layout payloads, (C,)
    int32 sizes): each row a whole reference FP substream of its chunk."""
    bcode, res = predict_f32_chunks(values, e1, e2)
    return pack_f32_chunks(bcode, res, e1, e2)


def _quad_lengths(dev) -> torch.Tensor:
    """Residual bytes of four 3-bit bcodes, by their 12 bits."""
    q = torch.arange(1 << 12, dtype=torch.int32, device=dev)
    return sum(_glen32((q >> s) & 7) for s in (0, 3, 6, 9))


def parse_f32_chunks(payloads, L: int, e1: int = 4, e2: int = 10):
    """(C, B) uint8 reference-layout payloads → ((C, L) uint8 bcodes, (C, L)
    int32 xors).

    A group's tag sits behind the residual bytes of the groups before it.
    Were a tag to start at byte p, the next would start at ``p + 3 +`` the
    residual bytes that tag announces: that is a jump table over the byte
    positions, and the tags are the orbit of position 5. ``fp_jax`` walks
    the orbit group by group, because gathers are slow on a TPU; here the
    table is squared ceil(log2 G) times (pointer doubling), each round
    doubling the known tag positions, and the residual bytes are one gather
    of 4 per value. Bytes past the payload read as byte B - 1."""
    C, B = payloads.shape
    if L % 8:
        raise ValueError(f"chunk length must be a multiple of 8, got {L}")
    if B < f32_max_chunk_bytes(L):
        raise ValueError(f"payload rows of {B} bytes are too short for "
                         f"chunks of {L} values")
    G = L // 8
    dev = payloads.device
    p32 = payloads.to(torch.int32)
    wide = torch.nn.functional.pad(p32, (0, 2))
    tag_at = (wide[:, :B] << 16) | (wide[:, 1 : B + 1] << 8) | wide[:, 2:]
    quad = _quad_lengths(dev)
    here = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    jump = (here + 3 + quad[tag_at & 0xFFF] + quad[tag_at >> 12]
            ).clamp(max=B - 1).to(torch.int64)
    pos = torch.full((C, 1), 5, dtype=torch.int64, device=dev)
    while pos.shape[1] < G:
        pos = torch.cat([pos, torch.gather(jump, 1, pos)], dim=1)
        if pos.shape[1] < G:
            jump = torch.gather(jump, 1, jump)
    pos = pos[:, :G]

    tag = torch.gather(tag_at, 1, pos)
    shifts = 3 * torch.arange(8, dtype=torch.int32, device=dev)
    bcodes = (tag[:, :, None] >> shifts) & 7  # (C, G, 8)
    lens = _glen32(bcodes)
    starts = pos[:, :, None] + 3 + (torch.cumsum(lens, dim=2) - lens)
    bcodes, lens, starts = (t.reshape(C, L) for t in (bcodes, lens, starts))

    k = torch.arange(4, dtype=torch.int32, device=dev)
    idx = (starts[:, :, None] + k).clamp(max=B - 1)
    bytes4 = torch.gather(p32, 1, idx.reshape(C, 4 * L)).reshape(C, L, 4)
    shift = 8 * (lens[:, :, None] - 1 - k).clamp(0, 3)
    part = torch.where(k < lens[:, :, None], bytes4 << shift, 0)
    xors = part[..., 0] | part[..., 1] | part[..., 2] | part[..., 3]
    return bcodes.to(torch.uint8), xors


def decode_f32_chunks(payloads, L: int, e1: int = 4, e2: int = 10):
    """(C, B) uint8 reference-layout payloads → (C, L) int32 words: parse,
    then replay."""
    bcodes, xors = parse_f32_chunks(payloads, L, e1, e2)
    return replay_f32_chunks(bcodes, xors, e1, e2)


def relayout_f32_v2_to_v1(payload: np.ndarray) -> np.ndarray:
    """Host reorder of one v2-layout substream to the reference layout
    (NumPy; the same function as ``fp_jax.relayout_f32_v2_to_v1``)."""
    p = np.asarray(payload, np.uint8)
    n = int.from_bytes(p[1:5].tobytes(), "big")
    G = (n + 7) // 8
    tags = p[5 : 5 + 3 * G]
    res = p[5 + 3 * G :]
    tag24 = ((tags[0::3].astype(np.int64) << 16)
             | (tags[1::3].astype(np.int64) << 8)
             | tags[2::3].astype(np.int64))
    lens_tab = np.array([0, 1, 2, 3, 4, 1, 2, 3], np.int64)
    glen = np.zeros(G, np.int64)
    for j in range(8):
        glen += lens_tab[(tag24 >> (3 * j)) & 7]
    ends = np.cumsum(glen)
    starts = ends - glen
    pieces = [p[:5]]
    for g in range(G):
        pieces.append(tags[3 * g : 3 * g + 3])
        pieces.append(res[starts[g] : ends[g]])
    return np.concatenate(pieces)


# ---------------------------------------------------------------------------
# host entry points: NumPy in, NumPy out. layout="tpu" is v2 chunks, all on
# the device. layout="ref" is reference-layout chunks: the device predictor
# and replay around the C++ host library's pack and parse, or, where the
# caller asks (device_pack / device_parse) or the library is not built, the
# device pack and parse (fp_jax.py:1007-1025, 1071-1088).
# ---------------------------------------------------------------------------


def _check_layout(layout: str) -> None:
    if layout not in ("tpu", "ref"):
        raise ValueError(f"unknown layout {layout!r}")


def _host_lib():
    """The C++ host library, which packs and parses the reference-layout
    chunks of ``fp64_torch``. f64 has no device pack or parse of that layout
    (nor has ``fp64_jax``): without the library ``chunked`` host-codes such
    chunks and never comes here."""
    if not native.available():
        raise NotImplementedError(
            'f64 chunks in layout="ref" are packed and parsed by the C++ '
            "host library, which is not built; encode_chunked and "
            "decode_chunked host-code such chunks instead")
    return native.get_lib()


def pack_native(fn, bcode, res, L: int, e1: int, e2: int, B: int):
    """Reference-layout payloads of (C, L) predicted codes and residuals
    (device or CPU tensors), packed by the host library's ``fn``
    (``tt_fp32_pack_chunks`` or ``tt_fp64_pack_chunks``) at normalised
    exponents → ((C, B) uint8, (C,) int64 sizes)."""
    bc = np.ascontiguousarray(bcode.cpu().numpy())
    rs = np.ascontiguousarray(res.cpu().numpy())
    C = len(bc)
    if bc.dtype != np.uint8 or bc.shape != (C, L) or rs.shape != (C, L):
        raise ValueError(f"pack_native: need (C, {L}) uint8 codes and residual "
                         f"words, got {bc.dtype} {bc.shape}, {rs.shape}")
    out = np.zeros((C, B), np.uint8)
    sizes = np.zeros(C, np.int32)
    if fn(native._ptr(bc), native._ptr(rs), C, L, e1, e2, native._ptr(out), B,
          native._ptr(sizes)) != 0:
        raise RuntimeError("native pack failed")
    return out, sizes.astype(np.int64)


def parse_native(fn, payloads: np.ndarray, L: int, word):
    """(C, B) reference-layout payloads → ((C, L) uint8 bcodes, (C, L) xor
    words of NumPy type ``word``), parsed by the host library's ``fn``
    (``tt_fp32_parse_chunks`` or ``tt_fp64_parse_chunks``)."""
    payloads = np.ascontiguousarray(payloads, np.uint8)
    C, B = payloads.shape
    bcodes = np.zeros((C, L), np.uint8)
    xors = np.zeros((C, L), word)
    if fn(native._ptr(payloads), C, B, L, native._ptr(bcodes),
          native._ptr(xors)) != 0:
        raise RuntimeError("native parse failed")
    return bcodes, xors


def _split(values_u32: np.ndarray, chunk_len: int):
    n = len(values_u32)
    C = n // chunk_len
    return C, values_u32[: C * chunk_len].reshape(C, chunk_len), \
        values_u32[C * chunk_len:]


def encode_f32(values_u32: np.ndarray, chunk_len: int, e1: int = 4,
               e2: int = 10, layout: str = "tpu", *, device_pack: bool = False,
               device="cuda"):
    """Encode a flat uint32 stream in chunks of ``chunk_len`` on ``device``.

    Returns (payloads (C, B) uint8, sizes (C,) int64, tail_values); the tail
    (n % chunk_len values) is left for the caller's host codec. Reference-
    layout chunks are packed by the C++ host library, or on the device
    (:func:`pack_f32_chunks`) when ``device_pack`` is set or the library is
    not built; the bytes are the same."""
    _check_layout(layout)
    C, chunks, tail = _split(values_u32, chunk_len)
    B = f32_max_chunk_bytes(chunk_len)
    if C == 0:
        return np.zeros((0, B), np.uint8), np.zeros(0, np.int64), tail
    x = _u32.from_numpy(chunks).to(device)
    if layout == "ref" and not device_pack and native.available():
        fn = native.get_lib().tt_fp32_pack_chunks
        e1, e2 = _norm_exponents(e1, e2)
        return (*pack_native(fn, *predict_f32_chunks(x, e1, e2), chunk_len,
                             e1, e2, B), tail)
    encode = encode_f32_chunks if layout == "ref" else encode_f32_chunks_v2
    out, sizes = encode(x, e1, e2)
    return out.cpu().numpy(), sizes.cpu().numpy().astype(np.int64), tail


def encode_f32_adaptive(values_u32: np.ndarray, chunk_len: int,
                        candidates=F32_TPU_CANDIDATES,
                        layout: str = "tpu", *, device="cuda"):
    """Adaptive per-chunk exponent encode of a flat uint32 stream; see
    :func:`encode_f32_chunks_v2_adaptive`. Returns as :func:`encode_f32`.
    ``layout="ref"`` relays the v2 chunks out to the reference layout on
    the host (a byte permutation; the sizes do not change)."""
    _check_layout(layout)
    chunk_len = (chunk_len // 8) * 8 or 8
    C, chunks, tail = _split(values_u32, chunk_len)
    B = f32_max_chunk_bytes(chunk_len)
    if C == 0:
        return np.zeros((0, B), np.uint8), np.zeros(0, np.int64), tail
    x = _u32.from_numpy(chunks).to(device)
    out, sizes = encode_f32_chunks_v2_adaptive(x, tuple(candidates))
    out, sizes = out.cpu().numpy(), sizes.cpu().numpy().astype(np.int64)
    if layout == "ref":
        if native.available():
            out = native.relayout_chunks(out, chunk_len, 32, to_v2=False)
        else:
            for c in range(C):
                out[c, : sizes[c]] = relayout_f32_v2_to_v1(out[c, : sizes[c]])
    return out, sizes, tail


def decode_f32(payloads: np.ndarray, chunk_len: int, e1: int = 4,
               e2: int = 10, layout: str = "tpu", *, device_parse: bool = False,
               device="cuda") -> np.ndarray:
    """Decode (C, B) padded chunk payloads of one layout → flat uint32
    values. Reference-layout chunks are parsed by the C++ host library, or on
    the device (:func:`parse_f32_chunks`) when ``device_parse`` is set or
    the library is not built."""
    _check_layout(layout)
    if len(payloads) == 0:
        return np.zeros(0, np.uint32)
    if layout == "ref" and not device_parse and native.available():
        bc, xo = parse_native(native.get_lib().tt_fp32_parse_chunks, payloads,
                              chunk_len, np.uint32)
        vals = replay_f32_chunks(torch.from_numpy(bc).to(device),
                                 _u32.from_numpy(xo).to(device), e1, e2)
        return _u32.to_numpy(vals).reshape(-1)
    decode = decode_f32_chunks if layout == "ref" else decode_f32_chunks_v2
    p = torch.from_numpy(np.ascontiguousarray(payloads, np.uint8)).to(device)
    return _u32.to_numpy(decode(p, chunk_len, e1, e2)).reshape(-1)
