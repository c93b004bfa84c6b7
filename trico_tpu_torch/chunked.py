"""The v1 chunked FP container, f32 "tpu" layout, over the port's codec.

Counterpart of the f32 path of ``trico_tpu/chunked.py``; the bytes are the
same. The framing (``parse_validated_framing``, ``rows_to_bytes``,
``bytes_to_rows``) and the host codec for tail chunks and big-table chunks
are ``trico_tpu``'s own host code, which imports no JAX. Full chunks run on
the ``device`` the caller names: ``"cuda"`` launches the port's kernels and
raises where there is no card; ``"cpu"`` runs their plain versions.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from trico_tpu import native
from trico_tpu.chunked import (_host_fp_decode, _host_fp_encode,
                               _host_fp_encode_best, bytes_to_rows,
                               parse_validated_framing, rows_to_bytes)

from .codec import fp_torch

DEFAULT_CHUNK_LEN = 4096
F32_TPU_EXP = (4, 6)
F32_TPU_CANDIDATES_FAST = fp_torch.F32_TPU_CANDIDATES_FAST
# Full chunks whose tables exceed this many words decode on host threads, as
# in trico_tpu.chunked.decode_chunked.
DEVICE_TABLE_WORDS = 1 << 12
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
    """Encode a uint32 raw-bits stream into a v1 chunked container whose
    full chunks are v2-layout payloads encoded on ``device``.

    ``optimize="fast"`` picks each chunk's exponents from
    ``F32_TPU_CANDIDATES_FAST``; the tail chunk is host-coded, in the
    reference layout, as in ``trico_tpu.chunked.encode_chunked``."""
    dev = _resolve_device(device)
    if values.dtype == np.uint64:
        raise NotImplementedError("f64 chunks are ROADMAP queue 1 item 5")
    if values.dtype != np.uint32:
        raise TypeError(values.dtype)
    if layout != "tpu":
        raise NotImplementedError('layout="ref" is ROADMAP queue 1 item 8')
    if optimize not in (False, "fast"):
        raise NotImplementedError(
            "optimize=True (the full adaptive candidate set) is ROADMAP "
            'queue 1 item 4; optimize="fast" is ported')
    if e1 is None:
        e1, e2 = F32_TPU_EXP
    chunk_len = (chunk_len // 8) * 8 or 8
    n = len(values)
    if optimize:
        mat, sizes, tail = fp_torch.encode_f32_adaptive(
            values, chunk_len, F32_TPU_CANDIDATES_FAST, device=dev)
    else:
        mat, sizes, tail = fp_torch.encode_f32(values, chunk_len, e1, e2,
                                               device=dev)
    chunk_sizes = [int(s) for s in sizes]
    body = [rows_to_bytes(mat, sizes).tobytes()] if len(sizes) else []
    if len(tail):
        tp = (_host_fp_encode_best(tail, F32_TPU_CANDIDATES_FAST) if optimize
              else _host_fp_encode(tail, e1, e2))
        chunk_sizes.append(len(tp))
        body.append(tp)
    head = struct.pack("<BBIII", 1, _FLAG_TPU_LAYOUT, chunk_len, n,
                       len(chunk_sizes))
    sizes_blob = struct.pack(f"<{len(chunk_sizes)}I", *chunk_sizes)
    return head + sizes_blob + b"".join(body)


def _host_decode_v2(mat: np.ndarray, sizes, idx, chunk_len: int) -> np.ndarray:
    """Host decode of v2 full chunks ``mat[idx]`` → (len(idx), chunk_len)."""
    if native.available():
        sub = native.relayout_chunks(mat[idx], chunk_len, 32, to_v2=False)
        B = mat.shape[1]
        return native.fp_decode_blocks(
            sub.reshape(-1), np.arange(len(idx), dtype=np.int64) * B,
            np.asarray(sizes, np.int64)[idx],
            np.full(len(idx), chunk_len, np.int64), 32,
        ).reshape(len(idx), chunk_len)
    return np.stack([
        _host_fp_decode(fp_torch.relayout_f32_v2_to_v1(mat[c, : sizes[c]]), 32)
        for c in idx])


def decode_chunked(data, *, device) -> tuple[np.ndarray, int]:
    """Decode a v1 f32 chunked container of v2-layout chunks → (uint32
    array, 32). Full chunks decode on ``device``, grouped by their hash_info
    byte; chunks whose tables exceed ``DEVICE_TABLE_WORDS`` and the tail
    chunk decode on the host."""
    dev = _resolve_device(device)
    data = bytes(data)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "fp":
        raise ValueError(f"{hdr.kind} container passed to decode_chunked "
                         "(FP containers only)")
    if hdr.bits == 64:
        raise NotImplementedError("f64 chunks are ROADMAP queue 1 item 5")
    if hdr.layout != "tpu":
        raise NotImplementedError('layout="ref" is ROADMAP queue 1 item 8')
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    if n_chunks == 0:
        return np.zeros(0, np.uint32), 32
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    n_full = n_chunks - 1 if total % chunk_len or total == 0 else n_chunks
    out = np.empty(total, np.uint32)
    buf = np.frombuffer(data, np.uint8)
    if n_full > 0:
        full_sizes = np.asarray(sizes[:n_full], np.int64)
        mat = bytes_to_rows(buf[offsets[0] : offsets[n_full]], full_sizes,
                            fp_torch.f32_max_chunk_bytes(chunk_len))
        rows = out[: n_full * chunk_len].reshape(n_full, chunk_len)
        for info in np.unique(mat[:, 0]):
            idx = np.nonzero(mat[:, 0] == info)[0]
            e1, e2 = fp_torch.exponents(int(info))
            if (1 << e1) + (1 << e2) > DEVICE_TABLE_WORDS:
                rows[idx] = _host_decode_v2(mat, sizes, idx, chunk_len)
            else:
                rows[idx] = fp_torch.decode_f32(
                    mat[idx], chunk_len, e1, e2, device=dev
                ).reshape(len(idx), chunk_len)
    for c in range(n_full, n_chunks):
        vals = _host_fp_decode(buf[offsets[c] : offsets[c + 1]], 32)
        out[c * chunk_len : c * chunk_len + len(vals)] = vals
    return out, 32
