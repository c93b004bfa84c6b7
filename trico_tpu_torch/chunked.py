"""The v1 chunked FP container, "tpu" layout, over the port's codecs.

Counterpart of the FP path of ``trico_tpu/chunked.py`` for both widths: u32
words (f32) go through :mod:`.codec.fp_torch`, u64 words (f64) through
:mod:`.codec.fp64_torch`; the bytes are the same. The framing
(``parse_validated_framing``, ``rows_to_bytes``, ``bytes_to_rows``) and the
host codec for tail chunks and big-table chunks are ``trico_tpu``'s own host
code, which imports no JAX. Full chunks run on the ``device`` the caller
names: ``"cuda"`` launches the port's kernels and raises where there is no
card; ``"cpu"`` runs their plain versions.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from trico_tpu import native
from trico_tpu.chunked import (_host_fp_decode, _host_fp_encode,
                               _host_fp_encode_best, bytes_to_rows,
                               host_decode_full_chunks,
                               parse_validated_framing, rows_to_bytes)

from .codec import fp64_torch, fp_torch

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
_FLAG_TPU_LAYOUT = 4  # flags bit 2: v2 chunk layout


def _resolve_device(device) -> torch.device:
    """The torch device to run on; raises for a card that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def encode_chunked(values: np.ndarray, chunk_len: int = DEFAULT_CHUNK_LEN,
                   e1: int | None = None, e2: int | None = None,
                   layout: str = "tpu", optimize: bool | str = False, *,
                   device) -> bytes:
    """Encode a uint32 (f32) or uint64 (f64) raw-bits stream into a v1
    chunked container whose full chunks are v2-layout payloads encoded on
    ``device``.

    The defaults follow ``trico_tpu.chunked.encode_chunked``: exponents
    (4,6) for f32 and (20,20) for f64; ``chunk_len`` rounded down to a
    multiple of 8 (f32) or of 2 (f64). ``optimize=True`` picks each chunk's
    exponents from the full candidate set of its width, ``optimize="fast"``
    from the ``*_FAST`` set. The tail chunk is host-coded, in the reference
    layout, with the same choice."""
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
    if layout != "tpu":
        raise NotImplementedError('layout="ref" is ROADMAP queue 1 item 8')
    if e1 is None:
        e1, e2 = exp
    chunk_len = (chunk_len // group) * group or group
    n = len(values)
    if optimize:
        mat, sizes, tail = encode_adaptive(values, chunk_len, cands, device=dev)
    else:
        mat, sizes, tail = encode(values, chunk_len, e1, e2, device=dev)
    chunk_sizes = [int(s) for s in sizes]
    body = [rows_to_bytes(mat, sizes).tobytes()] if len(sizes) else []
    if len(tail):
        tp = (_host_fp_encode_best(tail, cands) if optimize
              else _host_fp_encode(tail, e1, e2))
        chunk_sizes.append(len(tp))
        body.append(tp)
    flags = _FLAG_TPU_LAYOUT | (_FLAG_F64 if group == 2 else 0)
    head = struct.pack("<BBIII", 1, flags, chunk_len, n, len(chunk_sizes))
    sizes_blob = struct.pack(f"<{len(chunk_sizes)}I", *chunk_sizes)
    return head + sizes_blob + b"".join(body)


def _host_decode_full(mat: np.ndarray, sizes, idx, chunk_len: int,
                      bits: int) -> np.ndarray:
    """Host decode of v2 full chunks ``mat[idx]`` → (len(idx), chunk_len):
    ``trico_tpu.chunked.host_decode_full_chunks`` (threaded C++) when the
    host library is built; else the NumPy oracle per chunk, after the port's
    own relayout (trico_tpu's NumPy relayout lives in its JAX modules)."""
    if native.available():
        return host_decode_full_chunks(mat, sizes, idx, chunk_len, bits, "tpu")
    relayout = (fp_torch.relayout_f32_v2_to_v1 if bits == 32
                else fp64_torch.relayout_f64_v2_to_v1)
    return np.stack([_host_fp_decode(relayout(mat[c, : sizes[c]]), bits)
                     for c in idx])


def decode_chunked(data, *, device) -> tuple[np.ndarray, int]:
    """Decode a v1 FP chunked container of v2-layout chunks → (uint32 or
    uint64 array, bits). Full chunks decode on ``device``, grouped by their
    hash_info byte; chunks whose tables exceed ``DEVICE_TABLE_WORDS`` and
    the tail chunk decode on the host."""
    dev = _resolve_device(device)
    data = bytes(data)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "fp":
        raise ValueError(f"{hdr.kind} container passed to decode_chunked "
                         "(FP containers only)")
    if hdr.layout != "tpu":
        raise NotImplementedError('layout="ref" is ROADMAP queue 1 item 8')
    bits = hdr.bits
    if bits == 32:
        dtype, B_of, decode = np.uint32, fp_torch.f32_max_chunk_bytes, fp_torch.decode_f32
    else:
        dtype, B_of, decode = np.uint64, fp64_torch.f64_max_chunk_bytes, fp64_torch.decode_f64
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    if n_chunks == 0:
        return np.zeros(0, dtype), bits
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    n_full = n_chunks - 1 if total % chunk_len or total == 0 else n_chunks
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
                rows[idx] = _host_decode_full(mat, sizes, idx, chunk_len, bits)
            else:
                rows[idx] = decode(mat[idx], chunk_len, e1, e2,
                                   device=dev).reshape(len(idx), chunk_len)
    for c in range(n_full, n_chunks):
        vals = _host_fp_decode(buf[offsets[c] : offsets[c + 1]], bits)
        out[c * chunk_len : c * chunk_len + len(vals)] = vals
    return out, bits
