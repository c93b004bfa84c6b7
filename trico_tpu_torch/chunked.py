"""The v1 chunked containers over the port's codecs: FP, BP and LZ4.

Counterpart of ``trico_tpu/chunked.py``; the names match and the bytes are
the same as ``trico_tpu``'s device path. FP containers of u32 words (f32) go
through :mod:`.codec.fp_torch`, of u64 words (f64) through
:mod:`.codec.fp64_torch`, in either chunk layout: "tpu" (v2, all on the
device) or "ref" (the reference layout: device predict and replay around the
C++ host library's pack and parse). Integer streams go through
:mod:`.codec.bp_torch` (BP32 / BP64 containers) and :mod:`.codec.lz4_torch`
(the LZ4 match search of byte-plane containers), and
:func:`encode_int_best` picks the smaller, as ``trico_tpu`` does.

The framing (``parse_validated_framing``, ``rows_to_bytes``,
``bytes_to_rows``, ``validate_bp_chunk_headers``), the fill containers, the
LZ4 decoder and the host codecs for tails and big-table chunks are
``trico_tpu``'s own host code, which imports no JAX. Full chunks run on the
``device`` the caller names: ``"cuda"`` launches the port's kernels and
raises where there is no card; ``"cpu"`` runs their plain versions. Where
``trico_tpu`` itself takes the host on a device host (no full chunk or LZ4
block, f64 reference-layout chunks that are adaptive or lack the host
library), so does the port.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

import trico_tpu.chunked as _jc
from trico_tpu import native
from trico_tpu.chunked import (DEFAULT_BP_CHUNK, DEFAULT_LZ4_BLOCK,
                               _bp_host_decode, _host_fp_decode,
                               _host_fp_encode, _host_fp_encode_best,
                               bytes_to_rows, encode_fill,
                               host_decode_full_chunks,
                               parse_validated_framing, rows_to_bytes,
                               validate_bp_chunk_headers)
# the LZ4 container decodes on the host; re-exported beside its encoder
from trico_tpu.chunked import decode_lz4_chunked  # noqa: F401
from trico_tpu.codec import bp_ref, transpose

from . import _u32, _u64
from .codec import bp_torch, fp64_torch, fp_torch, lz4_torch

DEFAULT_CHUNK_LEN = 4096
F32_TPU_EXP = (4, 6)
F64_DEFAULT_EXP = (20, 20)  # the reference's f64 default (trico.c:396)
F32_TPU_CANDIDATES = fp_torch.F32_TPU_CANDIDATES
F32_TPU_CANDIDATES_FAST = fp_torch.F32_TPU_CANDIDATES_FAST
F64_TPU_CANDIDATES = fp64_torch.F64_TPU_CANDIDATES
F64_TPU_CANDIDATES_FAST = fp64_torch.F64_TPU_CANDIDATES_FAST
# Full chunks whose tables exceed this many words decode on host threads, as
# in trico_tpu.chunked.decode_chunked.
DEVICE_TABLE_WORDS = 1 << 12
_FLAG_F64 = 1  # flags bit 0: element width
_FLAG_LZ4 = 2  # flags bit 1: chunked LZ4 container
_FLAG_TPU_LAYOUT = 4  # flags bit 2: v2 chunk layout
_FLAG_BP = 8  # flags bit 3: BP32 / BP64 container


def _resolve_device(device) -> torch.device:
    """The torch device to run on; raises for a card that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _frame(flags: int, chunk_len: int, total: int, sizes, body) -> bytes:
    """A v1 container: the 14-byte prefix, the size table, the payloads."""
    head = struct.pack("<BBIII", 1, flags, chunk_len, total, len(sizes))
    return head + struct.pack(f"<{len(sizes)}I", *sizes) + b"".join(body)


def _rows_body(mat: np.ndarray, sizes) -> tuple[list, list]:
    """(chunk sizes, payload pieces) of padded (C, B) payload rows."""
    if not len(sizes):
        return [], []
    return [int(s) for s in sizes], [rows_to_bytes(mat, sizes).tobytes()]


# ---------------------------------------------------------------------------
# FP containers
# ---------------------------------------------------------------------------


def encode_chunked(values: np.ndarray, chunk_len: int = DEFAULT_CHUNK_LEN,
                   e1: int | None = None, e2: int | None = None,
                   layout: str = "tpu", optimize: bool | str = False, *,
                   device) -> bytes:
    """Encode a uint32 (f32) or uint64 (f64) raw-bits stream into a v1
    chunked FP container whose full chunks are encoded on ``device``.

    The defaults follow ``trico_tpu.chunked.encode_chunked``: exponents
    (4,6) for f32 and (20,20) for f64; ``chunk_len`` rounded down to a
    multiple of 8 (f32) or of 2 (f64). ``optimize=True`` picks each chunk's
    exponents from the full candidate set of its width, ``optimize="fast"``
    from the ``*_FAST`` set. ``layout="tpu"`` writes v2 chunks,
    ``layout="ref"`` reference-layout chunks (packed by the C++ host
    library; without it, f32 raises ``NotImplementedError`` and f64 is
    host-coded, as in ``trico_tpu``). The tail chunk is host-coded, in the
    reference layout, with the same choice."""
    dev = _resolve_device(device)
    if values.dtype == np.uint32:
        exp, group = F32_TPU_EXP, 8
        cands = (F32_TPU_CANDIDATES_FAST if optimize == "fast"
                 else F32_TPU_CANDIDATES)
        encode, encode_adaptive = fp_torch.encode_f32, fp_torch.encode_f32_adaptive
    elif values.dtype == np.uint64:
        exp, group = F64_DEFAULT_EXP, 2
        cands = (F64_TPU_CANDIDATES_FAST if optimize == "fast"
                 else F64_TPU_CANDIDATES)
        encode, encode_adaptive = fp64_torch.encode_f64, fp64_torch.encode_f64_adaptive
    else:
        raise TypeError(values.dtype)
    if layout not in ("tpu", "ref"):
        raise ValueError(f"unknown layout {layout!r}")
    if e1 is None:
        e1, e2 = exp
    chunk_len = (chunk_len // group) * group or group
    n = len(values)
    flags = (_FLAG_TPU_LAYOUT if layout == "tpu" else 0) | (_FLAG_F64 if group == 2 else 0)
    if group == 2 and layout == "ref" and (optimize or not native.available()):
        # trico_tpu/chunked.py:356-369: adaptive f64 reference-layout chunks
        # are a host best-of, and without the host library that packs them
        # f64 reference-layout chunks are host-coded
        pieces = [values[i : i + chunk_len] for i in range(0, n, chunk_len)]
        body = [_host_fp_encode_best(p, cands) if optimize
                else _host_fp_encode(p, e1, e2) for p in pieces]
        return _frame(flags, chunk_len, n, [len(p) for p in body], body)
    if optimize:
        mat, sizes, tail = encode_adaptive(values, chunk_len, cands,
                                           layout=layout, device=dev)
    else:
        mat, sizes, tail = encode(values, chunk_len, e1, e2, layout=layout,
                                  device=dev)
    chunk_sizes, body = _rows_body(mat, sizes)
    if len(tail):
        tp = (_host_fp_encode_best(tail, cands) if optimize
              else _host_fp_encode(tail, e1, e2))
        chunk_sizes.append(len(tp))
        body.append(tp)
    return _frame(flags, chunk_len, n, chunk_sizes, body)


def _host_decode_full(mat: np.ndarray, sizes, idx, chunk_len: int,
                      bits: int, layout: str) -> np.ndarray:
    """Host decode of full chunks ``mat[idx]`` → (len(idx), chunk_len):
    ``trico_tpu.chunked.host_decode_full_chunks`` (threaded C++ when the
    host library is built, the NumPy oracle per chunk otherwise); v2 chunks
    without the library take the port's own relayout first (trico_tpu's
    NumPy relayout lives in its JAX modules)."""
    if native.available() or layout == "ref":
        return host_decode_full_chunks(mat, sizes, idx, chunk_len, bits, layout)
    relayout = (fp_torch.relayout_f32_v2_to_v1 if bits == 32
                else fp64_torch.relayout_f64_v2_to_v1)
    return np.stack([_host_fp_decode(relayout(mat[c, : sizes[c]]), bits)
                     for c in idx])


def decode_chunked(data, *, device) -> tuple[np.ndarray, int]:
    """Decode a v1 FP chunked container, either chunk layout → (uint32 or
    uint64 array, bits). Full chunks decode on ``device``, grouped by their
    hash_info byte; chunks whose tables exceed ``DEVICE_TABLE_WORDS`` and
    the tail chunk decode on the host, and so do f64 reference-layout chunks
    when the host library that parses them is missing
    (trico_tpu/chunked.py:708-710)."""
    dev = _resolve_device(device)
    data = bytes(data)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "fp":
        raise ValueError(f"{hdr.kind} container passed to decode_chunked "
                         "(FP containers only)")
    bits, layout = hdr.bits, hdr.layout
    if bits == 32:
        dtype, B_of, decode = np.uint32, fp_torch.f32_max_chunk_bytes, fp_torch.decode_f32
    else:
        dtype, B_of, decode = np.uint64, fp64_torch.f64_max_chunk_bytes, fp64_torch.decode_f64
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    if n_chunks == 0:
        return np.zeros(0, dtype), bits
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    n_full = n_chunks - 1 if total % chunk_len or total == 0 else n_chunks
    if bits == 64 and layout == "ref" and not native.available():
        n_full = 0
    out = np.empty(total, dtype)
    buf = np.frombuffer(data, np.uint8)
    if n_full > 0:
        full_sizes = np.asarray(sizes[:n_full], np.int64)
        mat = bytes_to_rows(buf[offsets[0] : offsets[n_full]], full_sizes,
                            B_of(chunk_len))
        rows = out[: n_full * chunk_len].reshape(n_full, chunk_len)
        for info in np.unique(mat[:, 0]):
            idx = np.nonzero(mat[:, 0] == info)[0]
            e1, e2 = fp_torch.exponents(int(info))
            if (1 << e1) + (1 << e2) > DEVICE_TABLE_WORDS:
                rows[idx] = _host_decode_full(mat, sizes, idx, chunk_len, bits,
                                              layout)
            else:
                rows[idx] = decode(mat[idx], chunk_len, e1, e2, layout=layout,
                                   device=dev).reshape(len(idx), chunk_len)
    for c in range(n_full, n_chunks):
        vals = _host_fp_decode(buf[offsets[c] : offsets[c + 1]], bits)
        out[c * chunk_len : c * chunk_len + len(vals)] = vals
    return out, bits


# ---------------------------------------------------------------------------
# BP32 / BP64 containers (flags bit 3)
# ---------------------------------------------------------------------------


def encode_bp_chunked(values: np.ndarray, chunk_len: int = DEFAULT_BP_CHUNK,
                      *, device) -> bytes:
    """BP container of a flat uint32 or uint64 stream: bit-plane-packed
    zigzag deltas in independent chunks (format: ``trico_tpu/codec/
    bp_ref.py``). ``chunk_len`` is capped at 8192 for u64 and rounded down
    to a multiple of 32. The full chunks are encoded on ``device``, the tail
    chunk on the host; a stream with no full chunk is host-coded, as in
    ``trico_tpu``."""
    dev = _resolve_device(device)
    values = np.ascontiguousarray(values)
    eb = values.dtype.itemsize
    if eb not in (4, 8):
        raise TypeError(values.dtype)
    if eb == 8:
        chunk_len = min(chunk_len, bp_torch.BP64_MAX_CHUNK)
    chunk_len = (chunk_len // 32) * 32 or 32
    n = len(values)
    C = n // chunk_len
    if C == 0:
        return _jc.encode_bp_chunked(values, chunk_len, use_tpu=False)
    full = values[: C * chunk_len].reshape(C, chunk_len)
    if eb == 4:
        mat, sizes = bp_torch.encode_bp32_chunks(_u32.from_numpy(full).to(dev))
    else:
        mat, sizes = bp_torch.encode_bp64_chunks(_u64.from_numpy(full).to(dev))
    chunk_sizes, body = _rows_body(mat.cpu().numpy(), sizes.cpu().numpy())
    tail = values[C * chunk_len :]
    if len(tail):
        tp = (native.bp_encode_blocks(tail, chunk_len)[0] if native.available()
              else bp_ref.encode_chunk(tail))
        chunk_sizes.append(len(tp))
        body.append(tp)
    return _frame(_FLAG_BP | (_FLAG_F64 if eb == 8 else 0), chunk_len, n,
                  chunk_sizes, body)


def decode_bp_chunked(data, *, device) -> np.ndarray:
    """Decode a BP container → flat uint32 or uint64 array. The full chunks
    decode on ``device`` after their width headers are validated; the tail
    on the host. Containers the device path cannot take (no full chunk, a
    chunk length off the 32-value grid, u64 chunks past 8192) decode on the
    host, as in ``trico_tpu``."""
    dev = _resolve_device(device)
    data = bytes(data)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "bp":
        raise ValueError("not a BP32 container")
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    eb = hdr.bits // 8
    n_full = n_chunks - 1 if total % chunk_len else n_chunks
    if (total == 0 or n_full == 0 or chunk_len % 32
            or (eb == 8 and chunk_len > bp_torch.BP64_MAX_CHUNK)):
        return _jc.decode_bp_chunked(data, use_tpu=False)
    buf = np.frombuffer(data, np.uint8)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    full_sizes = np.asarray(sizes[:n_full], np.int64)
    if eb == 4:
        B, dec, to_numpy = (bp_torch.bp32_max_chunk_bytes(chunk_len),
                            bp_torch.decode_bp32_chunks, _u32.to_numpy)
    else:
        B, dec, to_numpy = (bp_torch.bp64_max_chunk_bytes(chunk_len),
                            bp_torch.decode_bp64_chunks, _u64.to_numpy)
    mat = bytes_to_rows(buf[offsets[0] : offsets[n_full]], full_sizes, B)
    validate_bp_chunk_headers(mat, full_sizes, chunk_len, eb * 8)
    out = np.empty(total, np.uint32 if eb == 4 else np.uint64)
    out[: n_full * chunk_len] = to_numpy(
        dec(torch.from_numpy(mat).to(dev), chunk_len)).reshape(-1)
    for c in range(n_full, n_chunks):
        count = min(chunk_len, total - c * chunk_len)
        out[c * chunk_len : c * chunk_len + count] = _bp_host_decode(
            buf[offsets[c] : offsets[c + 1]], count, eb)
    return out


# ---------------------------------------------------------------------------
# LZ4 byte-plane containers (flags bit 1) and the pick-best integer coding
# ---------------------------------------------------------------------------


def encode_lz4_chunked(plane: np.ndarray, block_len: int = DEFAULT_LZ4_BLOCK,
                       *, device) -> bytes:
    """Chunked-LZ4 container of a byte plane: independent LZ4 blocks of
    ``block_len`` bytes. With the C++ host library and at least one full
    block, the match search of the full blocks runs on ``device`` and the
    host emits them (:func:`.codec.lz4_torch.compress_plane`); otherwise the
    host codec compresses every block, as in ``trico_tpu``."""
    dev = _resolve_device(device)
    plane = np.ascontiguousarray(plane, dtype=np.uint8).reshape(-1)
    n = len(plane)
    if not (native.available() and n >= block_len):
        return _jc.encode_lz4_chunked(plane, block_len, use_tpu=False)
    payloads = lz4_torch.compress_plane(plane, block_len, device=dev)
    return _frame(_FLAG_LZ4, block_len, n, [len(p) for p in payloads], payloads)


def encode_int_best(arr: np.ndarray, block_len: int | None = None, *,
                    device) -> list[bytes]:
    """Integer stream → the smaller of LZ4 byte planes and one BP container,
    as the stream's ``itemsize`` substream payloads (the BP form pads with
    empty BP placeholder containers). Constant byte planes are 19-byte fill
    containers. The same choice as ``trico_tpu.chunked.encode_int_best``."""
    arr = np.ascontiguousarray(arr)
    lz4_subs = [
        encode_fill(int(plane[0]), len(plane))
        if len(plane) and not np.any(plane != plane[0])
        else encode_lz4_chunked(plane, block_len or DEFAULT_LZ4_BLOCK,
                                device=device)
        for plane in transpose.byte_planes(arr)]
    flat = arr.reshape(-1)
    if flat.dtype.itemsize in (4, 8):
        bp = encode_bp_chunked(flat, device=device)
        flags = _FLAG_BP | (_FLAG_F64 if flat.dtype.itemsize == 8 else 0)
        placeholder = _frame(flags, DEFAULT_BP_CHUNK, 0, [], [])
        bp_total = len(bp) + (arr.dtype.itemsize - 1) * len(placeholder)
        if bp_total < sum(len(s) for s in lz4_subs):
            return [bp] + [placeholder] * (arr.dtype.itemsize - 1)
    return lz4_subs
