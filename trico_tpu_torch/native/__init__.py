"""Native (C++) host runtime of the port.

The port's own copy of ``trico_tpu/native/``: ``codec.cpp`` is built on demand
with g++ (cached by source hash, under a file name of its own so that it never
aliases ``trico_tpu``'s library) and exposed via ctypes. This is the fast host
path: the scalar FP codec for tails, big-table chunks and v0 archives, the
reference-layout pack and parse, the LZ4 block codec and emitter, the BP block
codec, the row movers and the byte-plane shuffles. It is host code, not a
device kernel. If the toolchain is unavailable, callers fall back to the NumPy
implementations (:mod:`..codec.fp_ref`, ``bp_ref``, ``lz4_ref``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "codec.cpp"
_LOCK = threading.Lock()
_LIB = None
_LOAD_ERROR: str | None = None


def _build_dir() -> Path:
    d = Path(os.environ.get("TRICO_TPU_BUILD_DIR", _HERE.parent.parent / "build"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _compile() -> Path:
    src = _SRC.read_bytes()
    # TRICO_TPU_NATIVE_FLAGS appends extra g++ flags (the sanitizer CI jobs
    # build with -fsanitize=thread / address,undefined); flags participate in
    # the cache tag so sanitized builds never alias the production .so.
    extra = os.environ.get("TRICO_TPU_NATIVE_FLAGS", "").split()
    tag = hashlib.sha256(src + " ".join(extra).encode()).hexdigest()[:16]
    out = _build_dir() / f"libtrico_torch_native_{tag}.so"
    if out.exists():
        return out
    # a temporary name of this process's own: several processes building at
    # once (test workers) each write a whole file and rename it into place
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
        "-std=c++17", "-fvisibility=hidden", *extra, str(_SRC), "-o", str(tmp),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def get_lib():
    """Return the loaded native library, or None if unavailable."""
    global _LIB, _LOAD_ERROR
    if _LIB is not None or _LOAD_ERROR is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LOAD_ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_compile()))
        except Exception as e:  # pragma: no cover - toolchain missing
            _LOAD_ERROR = str(e)
            return None
        i64, u32, u64 = ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint64
        p = ctypes.c_void_p
        lib.tt_fp32_encode.restype = i64
        lib.tt_fp32_encode.argtypes = [p, u32, u32, u32, p, i64]
        lib.tt_fp64_encode.restype = i64
        lib.tt_fp64_encode.argtypes = [p, u32, u32, u32, p, i64]
        lib.tt_fp32_decode.restype = i64
        lib.tt_fp32_decode.argtypes = [p, i64, p, u32, ctypes.POINTER(u32)]
        lib.tt_fp64_decode.restype = i64
        lib.tt_fp64_decode.argtypes = [p, i64, p, u32, ctypes.POINTER(u32)]
        lib.tt_lz4_bound.restype = i64
        lib.tt_lz4_bound.argtypes = [i64]
        lib.tt_lz4_compress.restype = i64
        lib.tt_lz4_compress.argtypes = [p, i64, p, i64]
        lib.tt_lz4_decompress.restype = i64
        lib.tt_lz4_decompress.argtypes = [p, i64, p, i64]
        lib.tt_lz4_decompress_blocks.restype = i64
        lib.tt_lz4_decompress_blocks.argtypes = [p, p, p, i64, p, p, p]
        lib.tt_lz4_compress_blocks.restype = i64
        lib.tt_lz4_compress_blocks.argtypes = [p, p, p, i64, p, i64, p]
        lib.tt_fp32_encode_blocks.restype = i64
        lib.tt_fp32_encode_blocks.argtypes = [p, p, p, i64, p, p, p, i64, p]
        lib.tt_fp64_encode_blocks.restype = i64
        lib.tt_fp64_encode_blocks.argtypes = [p, p, p, i64, p, p, p, i64, p]
        lib.tt_warmup.restype = None
        lib.tt_warmup.argtypes = []
        lib.tt_fp32_search_encode.restype = i64
        lib.tt_fp32_search_encode.argtypes = [p, p, p, i64, p, p, i64, i64, p, i64, p]
        lib.tt_fp64_search_encode.restype = i64
        lib.tt_fp64_search_encode.argtypes = [p, p, p, i64, p, p, i64, i64, p, i64, p]
        lib.tt_fp32_decode_blocks.restype = i64
        lib.tt_fp32_decode_blocks.argtypes = [p, p, p, i64, p, p, p]
        lib.tt_fp64_decode_blocks.restype = i64
        lib.tt_fp64_decode_blocks.argtypes = [p, p, p, i64, p, p, p]
        lib.tt_lz4_emit.restype = i64
        lib.tt_lz4_emit.argtypes = [p, i64, p, p, p, i64]
        lib.tt_lz4_emit_blocks.restype = i64
        lib.tt_lz4_emit_blocks.argtypes = [p, p, i64, i64, p, p, p, i64, p]
        lib.tt_bp_encode_blocks.restype = i64
        lib.tt_bp_encode_blocks.argtypes = [p, i64, p, p, i64, p, i64, p]
        lib.tt_bp_decode_blocks.restype = i64
        lib.tt_bp_decode_blocks.argtypes = [p, p, p, i64, p, i64, p, p]
        lib.tt_rows_to_bytes.restype = None
        lib.tt_rows_to_bytes.argtypes = [p, i64, i64, p, p, p]
        lib.tt_bytes_to_rows.restype = None
        lib.tt_bytes_to_rows.argtypes = [p, p, p, i64, i64, p]
        lib.tt_fp32_pack_chunks.restype = i64
        lib.tt_fp32_pack_chunks.argtypes = [p, p, i64, i64, u32, u32, p, i64, p]
        lib.tt_fp32_parse_chunks.restype = i64
        lib.tt_fp32_parse_chunks.argtypes = [p, i64, i64, i64, p, p]
        lib.tt_fp64_pack_chunks.restype = i64
        lib.tt_fp64_pack_chunks.argtypes = [p, p, i64, i64, u32, u32, p, i64, p]
        lib.tt_fp64_parse_chunks.restype = i64
        lib.tt_fp64_parse_chunks.argtypes = [p, i64, i64, i64, p, p]
        lib.tt_fp32_relayout_chunks.restype = i64
        lib.tt_fp32_relayout_chunks.argtypes = [p, i64, i64, i64, ctypes.c_int32, p]
        lib.tt_fp64_relayout_chunks.restype = i64
        lib.tt_fp64_relayout_chunks.argtypes = [p, i64, i64, i64, ctypes.c_int32, p]
        lib.tt_shuffle_bytes.restype = None
        lib.tt_shuffle_bytes.argtypes = [p, i64, ctypes.c_int32, p, p]
        lib.tt_unshuffle_bytes.restype = None
        lib.tt_unshuffle_bytes.argtypes = [p, i64, ctypes.c_int32, p]
        # spin up the worker pool and fault-in codec arenas now, so one-shot
        # encodes (CLI --profile) don't pay thread spawn + page faults inline
        lib.tt_warmup()
        # pre-fault the malloc heap for per-call scratch buffers (tt_warmup
        # raised the trim threshold, so these pages stay resident after free)
        _scratch = np.empty(12 << 20, np.uint8)
        _scratch[::4096] = 1
        del _scratch
        _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def fp_encode(values: np.ndarray, e1: int, e2: int) -> bytes:
    """Native FP substream encode. values: uint32 or uint64 (raw float bits)."""
    lib = get_lib()
    values = np.ascontiguousarray(values)
    n = len(values)
    if values.dtype == np.uint32:
        cap = 5 + 3 * ((n + 7) // 8) + 4 * n + 8
        out = np.empty(cap, dtype=np.uint8)
        sz = lib.tt_fp32_encode(_ptr(values), n, e1, e2, _ptr(out), cap)
    elif values.dtype == np.uint64:
        cap = 5 + ((n + 1) // 2) + 8 * n + 8
        out = np.empty(cap, dtype=np.uint8)
        sz = lib.tt_fp64_encode(_ptr(values), n, e1, e2, _ptr(out), cap)
    else:
        raise TypeError(values.dtype)
    if sz < 0:
        raise RuntimeError(f"native fp encode failed: {sz}")
    return out[:sz].tobytes()


def fp_decode(data, bits: int) -> np.ndarray:
    """Native FP substream decode → uint32/uint64 raw-bits array."""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    buf = np.ascontiguousarray(buf)
    if len(buf) < 5:
        raise ValueError("truncated FP substream")
    n = int.from_bytes(buf[1:5].tobytes(), "big")
    n_out = ctypes.c_uint32(0)
    if bits == 32:
        out = np.empty(n, dtype=np.uint32)
        rc = lib.tt_fp32_decode(_ptr(buf), len(buf), _ptr(out), n, ctypes.byref(n_out))
    else:
        out = np.empty(n, dtype=np.uint64)
        rc = lib.tt_fp64_decode(_ptr(buf), len(buf), _ptr(out), n, ctypes.byref(n_out))
    if rc < 0:
        raise ValueError(f"corrupt FP substream (rc={rc})")
    return out


def relayout_chunks(mat: np.ndarray, L: int, bits: int, to_v2: bool) -> np.ndarray:
    """Batch v1<->v2 chunk relayout of a padded (C, B) payload matrix.

    Pure byte permutation per chunk (multithreaded native walk); the returned
    matrix has identical per-chunk sizes."""
    lib = get_lib()
    mat = np.ascontiguousarray(mat)
    C, B = mat.shape
    out = np.zeros_like(mat)
    fn = lib.tt_fp32_relayout_chunks if bits == 32 else lib.tt_fp64_relayout_chunks
    rc = fn(_ptr(mat), C, B, L, 1 if to_v2 else 0, _ptr(out))
    if rc != 0:
        raise RuntimeError("native relayout failed")
    return out


def lz4_compress(data) -> bytes:
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else np.ascontiguousarray(data)
    cap = int(lib.tt_lz4_bound(len(buf)))
    out = np.empty(cap, dtype=np.uint8)
    sz = lib.tt_lz4_compress(_ptr(buf), len(buf), _ptr(out), cap)
    if sz < 0:
        raise RuntimeError("lz4 compress failed")
    return out[:sz].tobytes()


def lz4_compress_blocks(plane: np.ndarray, block_len: int) -> list[bytes]:
    """Compress ``plane`` as independent ``block_len``-byte LZ4 blocks in
    parallel (hardware threads). Returns one bytes object per block."""
    lib = get_lib()
    plane = np.ascontiguousarray(plane, np.uint8).reshape(-1)
    n = len(plane)
    n_blocks = max((n + block_len - 1) // block_len, 1)
    src_off = (np.arange(n_blocks, dtype=np.int64) * block_len)
    src_sz = np.minimum(block_len, n - src_off)
    cap = int(lib.tt_lz4_bound(min(block_len, n)))
    dst = np.empty(n_blocks * cap, np.uint8)
    out_sz = np.zeros(n_blocks, np.int64)
    rc = lib.tt_lz4_compress_blocks(
        _ptr(plane), _ptr(src_off), _ptr(src_sz), n_blocks,
        _ptr(dst), cap, _ptr(out_sz),
    )
    if rc != 0:
        raise RuntimeError(f"lz4 block compress failed at block {-rc - 1}")
    return [dst[i * cap : i * cap + out_sz[i]].tobytes() for i in range(n_blocks)]


def fp_encode_jobs(planes: list[np.ndarray], exponents: list[tuple[int, int]]
                   ) -> list[bytes]:
    """Encode every (plane, exponent-pair) job concurrently.

    Jobs are the cross product ``planes x exponents``; returns payload bytes in
    plane-major order (``len(planes) * len(exponents)`` entries). This is the
    threaded engine behind the v0 writer's adaptive-exponent search — one
    native call instead of 15 serial encodes (reference encodes serially,
    trico.c:215-262)."""
    lib = get_lib()
    planes = [np.ascontiguousarray(pl) for pl in planes]
    bits = 32 if planes[0].dtype == np.uint32 else 64
    concat = np.concatenate(planes)
    lens = np.array([len(pl) for pl in planes], np.int64)
    plane_off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    K = len(exponents)
    n_jobs = len(planes) * K
    src_off = np.repeat(plane_off, K)
    src_n = np.repeat(lens, K)
    e1s = np.tile(np.array([e[0] for e in exponents], np.uint32), len(planes))
    e2s = np.tile(np.array([e[1] for e in exponents], np.uint32), len(planes))
    return _run_encode_jobs(lib, concat, src_off, src_n, e1s, e2s, bits)


def fp_search_encode(planes: list[np.ndarray],
                     exponents: list[tuple[int, int]],
                     prefix_n: int = 4096) -> list[bytes]:
    """Adaptive-exponent encode of all planes in ONE native call.

    Ranks the candidate ``exponents`` per plane on a ``prefix_n``-value prefix
    (full plane when short), then encodes each plane with its winner — both
    phases threaded, LPT-ordered, with no Python round-trip in between.
    Candidate 0 is the bias default (see tt_fp32_search_encode in codec.cpp).
    The reference encodes one plane, one fixed pair, serially (trico.c:215-262).
    """
    lib = get_lib()
    if isinstance(planes, np.ndarray) and planes.ndim == 2:
        soa = np.ascontiguousarray(planes)  # (P, n): plane p is row p
        concat = soa.reshape(-1)
        lens = np.full(soa.shape[0], soa.shape[1], np.int64)
    else:
        planes = [np.ascontiguousarray(pl) for pl in planes]
        concat = np.concatenate(planes)
        lens = np.array([len(pl) for pl in planes], np.int64)
    bits = 32 if concat.dtype == np.uint32 else 64
    P = len(lens)
    plane_off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    e1s = np.array([e[0] for e in exponents], np.uint32)
    e2s = np.array([e[1] for e in exponents], np.uint32)
    nmax = int(lens.max(initial=0))
    cap = (5 + 3 * ((nmax + 7) // 8) + 4 * nmax + 8) if bits == 32 \
        else (5 + ((nmax + 1) // 2) + 8 * nmax + 8)
    dst = np.empty(P * cap, np.uint8)
    out_sz = np.zeros(P, np.int64)
    fn = lib.tt_fp32_search_encode if bits == 32 else lib.tt_fp64_search_encode
    rc = fn(_ptr(concat), _ptr(plane_off), _ptr(lens), P,
            _ptr(e1s), _ptr(e2s), len(exponents), prefix_n,
            _ptr(dst), cap, _ptr(out_sz))
    if rc != 0:
        raise RuntimeError(f"native fp search encode plane {-rc - 1} failed")
    # zero-copy views into dst (dst is per-call, so the views stay valid)
    return [dst[p * cap : p * cap + out_sz[p]] for p in range(P)]


def fp_encode_sizes(planes: list[np.ndarray], exponents: list[tuple[int, int]]
                    ) -> list[int]:
    """Like :func:`fp_encode_jobs` but returns payload sizes only.

    Used for candidate ranking: the prefix-estimate phase of the adaptive
    search needs sizes, not bytes, so skip the payload extraction."""
    lib = get_lib()
    planes = [np.ascontiguousarray(pl) for pl in planes]
    bits = 32 if planes[0].dtype == np.uint32 else 64
    concat = np.concatenate(planes)
    lens = np.array([len(pl) for pl in planes], np.int64)
    plane_off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    K = len(exponents)
    src_off = np.repeat(plane_off, K)
    src_n = np.repeat(lens, K)
    e1s = np.tile(np.array([e[0] for e in exponents], np.uint32), len(planes))
    e2s = np.tile(np.array([e[1] for e in exponents], np.uint32), len(planes))
    return _run_encode_jobs(lib, concat, src_off, src_n, e1s, e2s, bits,
                            sizes_only=True)


def fp_encode_each(planes: list[np.ndarray], exponents: list[tuple[int, int]]
                   ) -> list[bytes]:
    """Encode plane i with exponent pair i, all planes concurrently."""
    lib = get_lib()
    planes = [np.ascontiguousarray(pl) for pl in planes]
    bits = 32 if planes[0].dtype == np.uint32 else 64
    concat = np.concatenate(planes)
    lens = np.array([len(pl) for pl in planes], np.int64)
    src_off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    e1s = np.array([e[0] for e in exponents], np.uint32)
    e2s = np.array([e[1] for e in exponents], np.uint32)
    return _run_encode_jobs(lib, concat, src_off, lens, e1s, e2s, bits)


def _run_encode_jobs(lib, concat, src_off, src_n, e1s, e2s, bits,
                     sizes_only: bool = False):
    n_jobs = len(src_n)
    nmax = int(src_n.max(initial=0))
    cap = (5 + 3 * ((nmax + 7) // 8) + 4 * nmax + 8) if bits == 32 \
        else (5 + ((nmax + 1) // 2) + 8 * nmax + 8)
    dst = np.empty(n_jobs * cap, np.uint8)
    out_sz = np.zeros(n_jobs, np.int64)
    fn = lib.tt_fp32_encode_blocks if bits == 32 else lib.tt_fp64_encode_blocks
    rc = fn(_ptr(concat), _ptr(src_off), _ptr(src_n), n_jobs,
            _ptr(e1s), _ptr(e2s), _ptr(dst), cap, _ptr(out_sz))
    if rc != 0:
        raise RuntimeError(f"native fp encode job {-rc - 1} failed")
    if sizes_only:
        return [int(s) for s in out_sz]
    return [dst[j * cap : j * cap + out_sz[j]].tobytes() for j in range(n_jobs)]


def split_bytes(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """An integer array's little-endian byte planes, as the rows of one
    ``(itemsize, arr.size)`` uint8 buffer, and per plane whether every byte
    equals its first (False for an empty array). Threaded over the pool for
    streams of 2 MiB and more."""
    lib = get_lib()
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    w = arr.dtype.itemsize
    planes = np.empty((w, arr.size), np.uint8)
    fills = np.zeros(w, bool)
    lib.tt_shuffle_bytes(_ptr(arr), arr.size, w, _ptr(planes), _ptr(fills))
    return planes, fills


def join_bytes(planes, dtype) -> np.ndarray:
    """Inverse of :func:`split_bytes`: ``itemsize`` byte planes of equal
    length, each its own buffer (or the rows of one), joined into a new
    array of ``dtype``."""
    lib = get_lib()
    dtype = np.dtype(dtype)
    w = dtype.itemsize
    planes = [np.ascontiguousarray(pl, np.uint8).reshape(-1) for pl in planes]
    if len(planes) != w:
        raise ValueError(f"{len(planes)} byte planes for a {w}-byte dtype")
    n = len(planes[0])
    if any(len(pl) != n for pl in planes):
        raise ValueError("byte planes of different lengths")
    out = np.empty(n, dtype.newbyteorder("<"))
    ptrs = (ctypes.c_void_p * w)(*(pl.ctypes.data for pl in planes))
    lib.tt_unshuffle_bytes(ptrs, n, w, _ptr(out))
    return out.astype(dtype, copy=False)


def lz4_shuffle_compress(arr: np.ndarray) -> list[np.ndarray]:
    """Byte-plane shuffle + per-plane LZ4 compress, all native.

    ``arr`` is an integer array; returns ``itemsize`` payloads (zero-copy
    views into a per-call buffer). Replaces the NumPy strided shuffle +
    per-plane python loop of the v0 writer (the reference does the same two
    steps serially in C, trico.c:332-377)."""
    lib = get_lib()
    soa, _ = split_bytes(arr)
    w, n = soa.shape
    lens = np.full(w, n, np.int64)
    offs = (np.arange(w, dtype=np.int64) * n)
    cap = int(lib.tt_lz4_bound(n))
    dst = np.empty(w * cap, np.uint8)
    out_sz = np.zeros(w, np.int64)
    rc = lib.tt_lz4_compress_blocks(_ptr(soa), _ptr(offs), _ptr(lens), w,
                                    _ptr(dst), cap, _ptr(out_sz))
    if rc != 0:
        raise RuntimeError(f"lz4 plane compress failed at plane {-rc - 1}")
    return [dst[k * cap : k * cap + out_sz[k]] for k in range(w)]


def lz4_decompress_unshuffle(data, src_offsets, src_sizes, n_elem: int,
                             dtype) -> np.ndarray:
    """Per-plane LZ4 decompress + byte-plane unshuffle, all native.

    Inverse of :func:`lz4_shuffle_compress`: ``itemsize`` compressed planes in
    one buffer -> the original little-endian integer array."""
    lib = get_lib()
    dtype = np.dtype(dtype)
    w = dtype.itemsize
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data)
    src_off = np.ascontiguousarray(src_offsets, np.int64)
    src_sz = np.ascontiguousarray(src_sizes, np.int64)
    dst_off = (np.arange(w, dtype=np.int64) * n_elem)
    dst_sz = np.full(w, n_elem, np.int64)
    soa = np.empty((w, n_elem), np.uint8)
    rc = lib.tt_lz4_decompress_blocks(
        _ptr(buf), _ptr(src_off), _ptr(src_sz), w,
        _ptr(soa), _ptr(dst_off), _ptr(dst_sz))
    if rc != 0:
        raise ValueError(f"corrupt LZ4 plane {-rc - 1}")
    return join_bytes(soa, dtype)


def lz4_compress_jobs(planes: list[np.ndarray]) -> list[bytes]:
    """Compress each plane as one whole LZ4 block, all planes concurrently.

    The v0 writer's byte planes (4 per u32 stream) are independent LZ4 blocks
    (trico.c:323-378); one threaded native call replaces the per-plane loop."""
    lib = get_lib()
    planes = [np.ascontiguousarray(pl, np.uint8).reshape(-1) for pl in planes]
    concat = np.concatenate(planes) if planes else np.zeros(0, np.uint8)
    lens = np.array([len(pl) for pl in planes], np.int64)
    src_off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    cap = int(lib.tt_lz4_bound(int(lens.max(initial=0))))
    dst = np.empty(len(planes) * cap, np.uint8)
    out_sz = np.zeros(len(planes), np.int64)
    rc = lib.tt_lz4_compress_blocks(
        _ptr(concat), _ptr(src_off), _ptr(lens), len(planes),
        _ptr(dst), cap, _ptr(out_sz),
    )
    if rc != 0:
        raise RuntimeError(f"lz4 plane compress failed at plane {-rc - 1}")
    return [dst[i * cap : i * cap + out_sz[i]].tobytes() for i in range(len(planes))]


def lz4_emit_blocks(blocks: np.ndarray, offsets: np.ndarray,
                    rle_lens: np.ndarray, tail: np.ndarray | None = None
                    ) -> list[bytes]:
    """Emit every LZ4 block of a plane from device-found candidates in ONE
    threaded native call (no per-block Python loop).

    ``blocks`` is (C, S) uint8, ``offsets``/``rle_lens`` are (C, S) int32 from
    :func:`trico_tpu_torch.codec.lz4_torch.find_matches`. ``tail`` (optional, < S
    bytes) is compressed with the host's own matcher as a final block."""
    lib = get_lib()
    blocks = np.ascontiguousarray(blocks, np.uint8)
    C, S = blocks.shape
    cand = np.ascontiguousarray(offsets, np.int32)
    rle = np.ascontiguousarray(rle_lens, np.int32)
    src_sz = np.full(C, S, np.int64)
    cap = int(lib.tt_lz4_bound(S))
    dst = np.empty(C * cap, np.uint8)
    out_sz = np.zeros(C, np.int64)
    rc = lib.tt_lz4_emit_blocks(_ptr(blocks), _ptr(src_sz), C, S,
                                _ptr(cand), _ptr(rle), _ptr(dst), cap,
                                _ptr(out_sz))
    if rc != 0:
        raise RuntimeError(f"lz4 emit failed at block {-rc - 1}")
    out = [dst[i * cap : i * cap + out_sz[i]].tobytes() for i in range(C)]
    if tail is not None and len(tail):
        out.append(lz4_compress(tail))
    return out


def bp_encode_blocks(values: np.ndarray, chunk_len: int) -> list[bytes]:
    """BP32-encode a flat u32/u64 stream as independent ``chunk_len``-value
    chunks across hardware threads (format: codec/bp_ref.py)."""
    lib = get_lib()
    values = np.ascontiguousarray(values)
    eb = values.dtype.itemsize
    assert eb in (4, 8), values.dtype
    n = len(values)
    n_blocks = max((n + chunk_len - 1) // chunk_len, 1)
    src_off = np.arange(n_blocks, dtype=np.int64) * chunk_len
    src_n = np.minimum(chunk_len, n - src_off)
    ng = (min(chunk_len, n) + 31) // 32
    cap = ng + 4 * eb * 8 * ng
    dst = np.empty(n_blocks * cap, np.uint8)
    out_sz = np.zeros(n_blocks, np.int64)
    rc = lib.tt_bp_encode_blocks(_ptr(values.view(np.uint8)), eb,
                                 _ptr(src_off), _ptr(src_n), n_blocks,
                                 _ptr(dst), cap, _ptr(out_sz))
    if rc != 0:
        raise RuntimeError(f"bp encode failed at block {-rc - 1}")
    return [dst[i * cap : i * cap + out_sz[i]].tobytes() for i in range(n_blocks)]


def bp_decode_blocks(data, src_offsets, src_sizes, dst_counts,
                     elem_bytes: int) -> np.ndarray:
    """Decode independent BP32 chunks in parallel → flat u32/u64 array."""
    lib = get_lib()
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data)
    src_off = np.ascontiguousarray(src_offsets, np.int64)
    src_sz = np.ascontiguousarray(src_sizes, np.int64)
    dst_n = np.ascontiguousarray(dst_counts, np.int64)
    dst_off = np.concatenate([[0], np.cumsum(dst_n)[:-1]]).astype(np.int64)
    out = np.empty(int(dst_n.sum()), np.uint32 if elem_bytes == 4 else np.uint64)
    rc = lib.tt_bp_decode_blocks(_ptr(buf), _ptr(src_off), _ptr(src_sz),
                                 len(src_sz), _ptr(out.view(np.uint8)),
                                 elem_bytes, _ptr(dst_off), _ptr(dst_n))
    if rc != 0:
        raise ValueError(f"corrupt BP32 chunk {-rc - 1}")
    return out


def fp_decode_blocks(data, src_offsets: np.ndarray, src_sizes: np.ndarray,
                     dst_counts: np.ndarray, bits: int) -> np.ndarray:
    """Decode independent FP substream chunks in parallel (hardware threads).

    ``data`` holds concatenated chunk payloads; chunk i spans
    ``src_offsets[i] : src_offsets[i] + src_sizes[i]`` and decodes to exactly
    ``dst_counts[i]`` values. Returns the concatenated raw-bits array."""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data)
    src_off = np.ascontiguousarray(src_offsets, np.int64)
    src_sz = np.ascontiguousarray(src_sizes, np.int64)
    dst_n = np.ascontiguousarray(dst_counts, np.int64)
    dst_off = np.concatenate([[0], np.cumsum(dst_n)[:-1]]).astype(np.int64)
    out = np.empty(int(dst_n.sum()), np.uint32 if bits == 32 else np.uint64)
    fn = lib.tt_fp32_decode_blocks if bits == 32 else lib.tt_fp64_decode_blocks
    rc = fn(_ptr(buf), _ptr(src_off), _ptr(src_sz), len(src_sz),
            _ptr(out), _ptr(dst_off), _ptr(dst_n))
    if rc != 0:
        raise ValueError(f"corrupt FP chunk {-rc - 1}")
    return out


def lz4_decompress_blocks(data, src_offsets: np.ndarray, src_sizes: np.ndarray,
                          dst_sizes: np.ndarray) -> np.ndarray:
    """Decode independent LZ4 blocks in parallel (hardware threads).

    ``data`` holds the concatenated compressed blocks; block i spans
    ``src_offsets[i] : src_offsets[i] + src_sizes[i]``. Returns the
    concatenated plain bytes (block i decodes to exactly ``dst_sizes[i]``)."""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data)
    src_off = np.ascontiguousarray(src_offsets, np.int64)
    src_sz = np.ascontiguousarray(src_sizes, np.int64)
    dst_sz = np.ascontiguousarray(dst_sizes, np.int64)
    dst_off = np.concatenate([[0], np.cumsum(dst_sz)[:-1]]).astype(np.int64)
    out = np.empty(int(dst_sz.sum()), np.uint8)
    rc = lib.tt_lz4_decompress_blocks(
        _ptr(buf), _ptr(src_off), _ptr(src_sz), len(src_sz),
        _ptr(out), _ptr(dst_off), _ptr(dst_sz),
    )
    if rc != 0:
        raise ValueError(f"corrupt LZ4 block {-rc - 1}")
    return out


def lz4_decompress(data, out_size: int) -> np.ndarray:
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else np.ascontiguousarray(data)
    out = np.empty(out_size, dtype=np.uint8)
    sz = lib.tt_lz4_decompress(_ptr(buf), len(buf), _ptr(out), out_size)
    if sz != out_size:
        raise ValueError(f"corrupt LZ4 block (got {sz}, want {out_size})")
    return out
