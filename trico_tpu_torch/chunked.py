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

The container format (the same as ``trico_tpu/chunked.py`` documents):

``[u8 container_version=1][u8 flags][u32 LE chunk_len][u32 LE total_count]``
``[u32 LE n_chunks][n_chunks x u32 LE chunk_size][concatenated chunk payloads]``

flags bit 0: element width (0 = u32, 1 = u64); bit 1: chunked LZ4; bit 2:
chunk layout (0 = reference, 1 = "tpu" v2, the group tags front-loaded);
bit 3: BP32 / BP64; flags == 10 (bits 1 and 3): a "fill" container, the
whole plane one repeated byte in 19 bytes. The final partial chunk is always
host-coded in the reference layout.

The framing (``parse_validated_framing``, ``rows_to_bytes``,
``bytes_to_rows``, ``validate_bp_chunk_headers``), the fill containers, the
LZ4 decoder and the host codecs for tails and big-table chunks are the
port's own copies of ``trico_tpu.chunked``'s host code, under the same names;
they run the C++ host library (:mod:`.native`) when it is built and the NumPy
oracles otherwise, with the same bytes. Full chunks run on ``device``:
``"cuda"``, the default, launches the port's kernels and raises where there
is no card; ``"cpu"`` runs their plain versions. ``device`` may also be a
:class:`~.shards.Mesh`: a device is the mesh of one shard, and the FP and
BP codecs split their full chunks over the shards (:mod:`.shards`); the
integer encodes run on its first shard. Where ``trico_tpu`` itself
takes the host on a device host (no full chunk or LZ4 block, f64
reference-layout chunks that are adaptive or lack the host library), so does
the port.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import _u32, _u64, native, profiling, shards, staging
from .codec import (bp_ref, bp_torch, fp64_torch, fp_cuda, fp_ref, fp_torch,
                    lz4_ref, lz4_torch, transpose)

DEFAULT_CHUNK_LEN = 4096
DEFAULT_BP_CHUNK = 16384  # values per BP chunk (64 KiB of u32)
# 1 MiB blocks: LZ4's match window is 64 KiB, so independent blocks cost only
# the first 64 KiB of warm-up each
DEFAULT_LZ4_BLOCK = 1 << 20
F32_TPU_EXP = (4, 6)
F64_DEFAULT_EXP = (20, 20)  # the reference's f64 default (trico.c:396)
F32_TPU_CANDIDATES = fp_torch.F32_TPU_CANDIDATES
F32_TPU_CANDIDATES_FAST = fp_torch.F32_TPU_CANDIDATES_FAST
F64_TPU_CANDIDATES = fp64_torch.F64_TPU_CANDIDATES
F64_TPU_CANDIDATES_FAST = fp64_torch.F64_TPU_CANDIDATES_FAST
# Full chunks whose tables exceed this many words decode on host threads, as
# in trico_tpu.chunked.decode_chunked: the decode's one gate, in
# decode_chunked (fp_cuda.tables_fit is the encode kernels' shared-memory
# gate, another decision).
DEVICE_TABLE_WORDS = 1 << 12
_FLAG_F64 = 1  # flags bit 0: element width
_FLAG_LZ4 = 2  # flags bit 1: chunked LZ4 container
_FLAG_TPU_LAYOUT = 4  # flags bit 2: v2 chunk layout
_FLAG_BP = 8  # flags bit 3: BP32 / BP64 container


def _resolve_device(device="cuda") -> shards.Mesh:
    """The mesh to run on: a :class:`~.shards.Mesh` as given, or a device
    (``"cuda"``, ``"cpu"``, a ``torch.device``) as the mesh of one shard;
    raises for a card that is not there."""
    if isinstance(device, shards.Mesh):
        return device
    return shards.Mesh([shards.torch_device(device)])


class ContainerHeader:
    """Parsed v1 chunked-container header (the 14-byte fixed prefix)."""

    __slots__ = ("bits", "kind", "layout", "chunk_len", "total", "n_chunks")

    def __init__(self, bits, kind, layout, chunk_len, total, n_chunks):
        self.bits = bits            # 32 | 64
        self.kind = kind            # "fp" | "lz4" | "bp" | "fill"
        self.layout = layout        # "ref" | "tpu"
        self.chunk_len = chunk_len
        self.total = total
        self.n_chunks = n_chunks


def parse_container_header(payload) -> ContainerHeader | None:
    """Parse a v1 chunked-container prefix, or None if ``payload`` is not one.

    This is the one place that interprets the flags byte: dispatchers route
    on the parsed fields, not on raw payload bytes."""
    buf = memoryview(payload)
    if len(buf) < 14 or buf[0] != 1:
        return None
    flags = buf[1]
    chunk_len, total, n_chunks = struct.unpack_from("<III", buf, 2)
    if flags == _FLAG_LZ4 | _FLAG_BP:
        # bits 1+3 together = "fill": one repeated byte for the whole plane
        return ContainerHeader(bits=32, kind="fill", layout="ref",
                               chunk_len=chunk_len, total=total,
                               n_chunks=n_chunks)
    if flags & ~15 or (flags & _FLAG_LZ4 and flags & _FLAG_BP):
        return None  # unknown flag bits / contradictory kind: not ours
    return ContainerHeader(
        bits=64 if flags & _FLAG_F64 else 32,
        kind="bp" if flags & _FLAG_BP else ("lz4" if flags & _FLAG_LZ4 else "fp"),
        layout="tpu" if flags & _FLAG_TPU_LAYOUT else "ref",
        chunk_len=chunk_len, total=total, n_chunks=n_chunks)


def parse_validated_framing(data: bytes) -> tuple[ContainerHeader, tuple, int]:
    """Parse and bounds-validate a v1 container's framing from untrusted
    bytes → ``(header, sizes, payload_offset)``, or raise ``ValueError``.

    The single place every decoder gets its chunk sizes from, so a crafted
    container can never drive out-of-bounds reads or writes in the native
    row movers. Checks: fixed prefix present, version 1, a nonzero chunk
    length, the size table and the payload bytes inside the buffer, and the
    chunk count consistent with the declared total (an undersized count
    would leave ``np.empty`` garbage in the decoded tail)."""
    if len(data) < 14:
        raise ValueError("truncated chunked container")
    ver, flags, chunk_len, total, n_chunks = struct.unpack_from("<BBIII", data, 0)
    if ver != 1:
        raise ValueError(f"unsupported chunked container version {ver}")
    hdr = parse_container_header(data)
    if hdr is None:
        raise ValueError("corrupt chunked container flags")
    if chunk_len == 0:
        raise ValueError("corrupt chunked container: zero chunk length")
    off = 14
    if off + 4 * n_chunks > len(data):
        raise ValueError("truncated chunked container")
    sizes = struct.unpack_from(f"<{n_chunks}I", data, off)
    off += 4 * n_chunks
    if off + sum(sizes) > len(data):
        raise ValueError("truncated chunked container")
    expected = (total + chunk_len - 1) // chunk_len
    # legacy LZ4 empty-stream containers carry one empty block for total=0
    ok = (n_chunks == expected or
          (hdr.kind == "lz4" and total == 0 and n_chunks <= 1))
    if not ok:
        raise ValueError("corrupt chunked container: chunk count does not "
                         "match declared element total")
    return hdr, sizes, off


def rows_to_bytes(mat: np.ndarray, sizes) -> np.ndarray:
    """Concatenate the first ``sizes[c]`` bytes of every row of a padded
    (C, B) payload matrix into one contiguous uint8 array: a threaded native
    memcpy walk, or a NumPy masked gather without the host library."""
    mat = np.ascontiguousarray(mat, np.uint8)
    sizes = np.asarray(sizes, np.int64)
    if native.available():
        lib = native.get_lib()
        dst_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        out = np.empty(int(sizes.sum()), np.uint8)
        lib.tt_rows_to_bytes(native._ptr(mat), mat.shape[0], mat.shape[1],
                             native._ptr(sizes), native._ptr(dst_off),
                             native._ptr(out))
        return out
    mask = np.arange(mat.shape[1], dtype=np.int64)[None, :] < sizes[:, None]
    return mat[mask]  # row-major boolean gather == concatenation in order


def bytes_to_rows(buf: np.ndarray, sizes, B: int) -> np.ndarray:
    """Inverse of :func:`rows_to_bytes`: scatter concatenated payloads into a
    zero-padded (C, B) matrix (row c gets ``sizes[c]`` bytes).

    ``sizes`` come from untrusted container framing, so they are validated
    here: a row size above ``B`` or a total other than ``len(buf)`` would
    make the native ``tt_bytes_to_rows`` copy past its row or its source."""
    sizes = np.asarray(sizes, np.int64)
    buf = np.ascontiguousarray(buf, np.uint8)
    if len(sizes) and (sizes.min() < 0 or sizes.max() > B):
        raise ValueError("corrupt container framing: chunk size exceeds "
                         "the maximum payload bound")
    if int(sizes.sum()) != len(buf):
        raise ValueError("corrupt container framing: payload bytes do not "
                         "match declared chunk sizes")
    if native.available():
        lib = native.get_lib()
        src_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        mat = np.empty((len(sizes), B), np.uint8)
        lib.tt_bytes_to_rows(native._ptr(buf), native._ptr(src_off),
                             native._ptr(sizes), len(sizes), B,
                             native._ptr(mat))
        return mat
    mat = np.zeros((len(sizes), B), np.uint8)
    mask = np.arange(B, dtype=np.int64)[None, :] < sizes[:, None]
    mat[mask] = buf
    return mat


def _payload_count(buf: np.ndarray, bits: int) -> int:
    """A chunk payload's value count, rounded up to its tag group."""
    n = int.from_bytes(buf[1:5].tobytes(), "big")
    group = 8 if bits == 32 else 2
    return ((n + group - 1) // group) * group


def _host_fp_encode(vals, e1, e2):
    if native.available():
        return native.fp_encode(vals, e1, e2)
    return fp_ref.compress(vals, e1, e2)


def _host_fp_decode(payload, bits):
    if native.available():
        return native.fp_decode(payload, bits)
    return fp_ref.decompress_f32(payload) if bits == 32 else fp_ref.decompress_f64(payload)


def _host_fp_encode_best(vals, candidates) -> bytes:
    """Host encode with the smallest payload over the candidate exponents
    (the first strictly smaller wins: the device argmin's tie rule)."""
    best = None
    for e1, e2 in candidates:
        p = _host_fp_encode(vals, e1, e2)
        if best is None or len(p) < len(best):
            best = p
    return best


def host_decode_full_chunks(mat: np.ndarray, sizes_arr, idx, chunk_len: int,
                            bits: int, layout: str) -> np.ndarray:
    """Host decode of the full chunks ``mat[idx]`` → (len(idx), chunk_len)
    raw words: the threaded native decoder when built, the NumPy oracle per
    chunk otherwise. ``sizes_arr`` aligns with ``mat`` rows; "tpu"-layout
    payloads are relaid out to the reference chunk layout first (a byte
    permutation, sizes unchanged)."""
    B = mat.shape[1]
    if native.available():
        sub = mat[idx]
        if layout == "tpu":
            sub = native.relayout_chunks(sub, chunk_len, bits, to_v2=False)
        return native.fp_decode_blocks(
            sub.reshape(-1),
            np.arange(len(idx), dtype=np.int64) * B,
            np.asarray(sizes_arr, np.int64)[idx],
            np.full(len(idx), chunk_len, np.int64), bits,
        ).reshape(len(idx), chunk_len)
    relayout = (fp_torch.relayout_f32_v2_to_v1 if bits == 32
                else fp64_torch.relayout_f64_v2_to_v1)
    rows = []
    for c in idx:
        p1 = mat[c, : sizes_arr[c]]
        if layout == "tpu":
            p1 = relayout(p1)
        rows.append(_host_fp_decode(p1, bits))
    return np.stack(rows)


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


def _fp_max_bytes(bits: int, L: int) -> int:
    return (fp_torch.f32_max_chunk_bytes(L) if bits == 32
            else fp64_torch.f64_max_chunk_bytes(L))


def _pack_ref(x, bits: int, e1: int, e2: int):
    """Reference-layout payload rows of (c, L) words on a device: the
    device predictor, then the C++ host library's pack → host tensors
    ((c, B) uint8, (c,) int32 sizes)."""
    e1, e2 = fp_cuda._norm_exponents(e1, e2)
    lib, L = native.get_lib(), x.shape[1]
    if bits == 32:
        fn, predict = lib.tt_fp32_pack_chunks, fp_torch.predict_f32_chunks
    else:
        fn, predict = lib.tt_fp64_pack_chunks, fp64_torch.predict_f64_chunks
    out, sizes = fp_torch.pack_native(fn, *predict(x, e1, e2), L, e1, e2,
                                      _fp_max_bytes(bits, L))
    return torch.from_numpy(out), torch.from_numpy(sizes.astype(np.int32))


def _encode_rows(full: np.ndarray, e1: int, e2: int, layout: str, cands,
                 mesh: shards.Mesh) -> tuple[np.ndarray, np.ndarray]:
    """(p, C, L) full chunks of u32 (f32) or u64 (f64) words → (this rank's
    payload rows (p, c, B), every chunk's size (p, C)): each shard encodes
    its chunks as one batch, at (e1, e2) or, given ``cands``, at each
    chunk's smallest candidate, and the sizes are all-gathered.
    Reference-layout chunks are packed by the C++ host library (on the
    device without it, f32 only); adaptive ones are searched in the v2
    layout and relaid out on the host (a byte permutation, sizes
    unchanged)."""
    bits, L = full.dtype.itemsize * 8, full.shape[2]
    f32 = bits == 32
    if cands is not None:
        cc = tuple(cands)
        enc = ((lambda x: fp_torch.encode_f32_chunks_v2_adaptive(x, cc)) if f32
               else (lambda x: fp64_torch.encode_f64_chunks_v2_adaptive(x, cc)))
    elif layout == "tpu":
        enc = ((lambda x: fp_torch.encode_f32_chunks_v2(x, e1, e2)) if f32
               else (lambda x: fp64_torch.encode_f64_chunks_v2(x, e1, e2)))
    elif native.available():
        enc = lambda x: _pack_ref(x, bits, e1, e2)  # noqa: E731
    else:
        enc = lambda x: fp_torch.encode_f32_chunks(x, e1, e2)  # noqa: E731
    payloads, sizes = shards.local_chunks(
        enc, full, mesh, [((_fp_max_bytes(bits, L),), np.uint8), ((), np.uint32)],
        ("fp_h2d", "fp_d2h"))
    if layout == "ref" and cands is not None:
        p, c, B = payloads.shape
        if native.available():
            payloads = native.relayout_chunks(payloads.reshape(p * c, B), L, 32,
                                              to_v2=False).reshape(p, c, B)
        else:
            for row, size in zip(payloads.reshape(p * c, B), sizes.reshape(-1)):
                row[:size] = fp_torch.relayout_f32_v2_to_v1(row[:size])
    return payloads, shards.gather_to_host(sizes, full.shape[1], mesh).astype(np.int64)


def _decode_rows(rows: np.ndarray, L: int, e1: int, e2: int, bits: int,
                 layout: str, mesh: shards.Mesh) -> np.ndarray:
    """(p, C, B) payload rows of one exponent pair → (p, C, L) u32 (f32) or
    u64 (f64) words on every rank: each shard decodes its chunks as one
    batch, and the words are gathered in chunk order. Reference-layout
    chunks are parsed by the C++ host library and replayed on the shards,
    or, f32 without the library, parsed on the shards too."""
    f32 = bits == 32
    dtype = np.uint32 if f32 else np.uint64
    inputs = rows
    if layout == "tpu":
        dec = ((lambda x: (fp_torch.decode_f32_chunks_v2(x, L, e1, e2),)) if f32
               else (lambda x: (fp64_torch.decode_f64_chunks_v2(x, L, e1, e2),)))
    elif native.available():
        lib = native.get_lib()
        p, C, B = rows.shape
        bc, xo = fp_torch.parse_native(
            lib.tt_fp32_parse_chunks if f32 else lib.tt_fp64_parse_chunks,
            rows.reshape(p * C, B), L, dtype)
        inputs = (bc.reshape(p, C, L), xo.reshape(p, C, L))
        dec = ((lambda b, x: (fp_torch.replay_f32_chunks(b, x, e1, e2),)) if f32
               else (lambda b, x: (fp64_torch.replay_f64_chunks(b, x, e1, e2),)))
    else:
        dec = lambda x: (fp_torch.decode_f32_chunks(x, L, e1, e2),)  # noqa: E731
    (vals,) = shards.local_chunks(dec, inputs, mesh, [((L,), dtype)],
                                  ("fp_read_h2d", "fp_read_d2h"))
    return shards.gather_to_host(vals, rows.shape[1], mesh)


def encode_fp_planes(planes: np.ndarray, chunk_len: int = DEFAULT_CHUNK_LEN,
                     e1: int | None = None, e2: int | None = None,
                     layout: str = "tpu", optimize: bool | str = False, *,
                     device="cuda") -> list[bytes]:
    """Encode (p, N) planes of uint32 (f32) or uint64 (f64) raw bits into
    one v1 chunked FP container per plane. The full chunks of all p planes
    ride one batch on each shard of ``device`` (a device or a
    :class:`~.shards.Mesh`); the tail chunks are host-coded, in the
    reference layout, with the same choice of exponents. The bytes do not
    depend on the shard count.

    The defaults follow ``trico_tpu.chunked.encode_chunked``: exponents
    (4,6) for f32 and (20,20) for f64; ``chunk_len`` rounded down to a
    multiple of 8 (f32) or of 2 (f64). ``optimize=True`` picks each chunk's
    exponents from the full candidate set of its width, ``optimize="fast"``
    from the ``*_FAST`` set. ``layout="tpu"`` writes v2 chunks,
    ``layout="ref"`` reference-layout chunks (packed by the C++ host
    library; without it, f32 chunks are packed on the device and f64
    chunks are host-coded, as in ``trico_tpu``).

    Its spans: ``fp_device_encode`` (the shards' encode, with its copies
    ``fp_h2d`` and ``fp_d2h``), ``fp_gather``, then for each plane
    ``fp_assembly``, ``fp_tails`` and ``fp_frame``."""
    mesh = _resolve_device(device)
    if planes.dtype == np.uint32:
        bits, exp, group = 32, F32_TPU_EXP, 8
        cands = F32_TPU_CANDIDATES_FAST if optimize == "fast" else F32_TPU_CANDIDATES
    elif planes.dtype == np.uint64:
        bits, exp, group = 64, F64_DEFAULT_EXP, 2
        cands = F64_TPU_CANDIDATES_FAST if optimize == "fast" else F64_TPU_CANDIDATES
    else:
        raise TypeError(planes.dtype)
    if layout not in ("tpu", "ref"):
        raise ValueError(f"unknown layout {layout!r}")
    if e1 is None:
        e1, e2 = exp
    chunk_len = (chunk_len // group) * group or group
    p, n = planes.shape
    flags = (_FLAG_TPU_LAYOUT if layout == "tpu" else 0) | (_FLAG_F64 if bits == 64 else 0)

    def host(vals) -> bytes:
        return _host_fp_encode_best(vals, cands) if optimize else _host_fp_encode(vals, e1, e2)

    if bits == 64 and layout == "ref" and (optimize or not native.available()):
        # trico_tpu/chunked.py:356-369: adaptive f64 reference-layout chunks
        # are a host best-of, and without the host library that packs them
        # f64 reference-layout chunks are host-coded
        out = []
        for plane in planes:
            body = [host(plane[i : i + chunk_len]) for i in range(0, n, chunk_len)]
            out.append(_frame(flags, chunk_len, n, [len(b) for b in body], body))
        return out
    C = n // chunk_len
    if C:
        full = planes[:, : C * chunk_len].reshape(p, C, chunk_len)
        with profiling.span("fp_device_encode", nbytes=full.nbytes):
            payloads, sizes = _encode_rows(full, e1, e2, layout,
                                           cands if optimize else None, mesh)
        with profiling.span("fp_gather", nbytes=full.nbytes):
            payloads = shards.gather_to_host(payloads, C, mesh)
    out = []
    for i in range(p):
        with profiling.span("fp_assembly", nbytes=int(sizes[i].sum()) if C else 0):
            chunk_sizes, body = _rows_body(payloads[i], sizes[i]) if C else ([], [])
        tail = planes[i, C * chunk_len :]
        if len(tail):
            with profiling.span("fp_tails", nbytes=tail.nbytes):
                tp = host(tail)
            chunk_sizes.append(len(tp))
            body.append(tp)
        with profiling.span("fp_frame", nbytes=sum(len(b) for b in body)):
            out.append(_frame(flags, chunk_len, n, chunk_sizes, body))
    return out


def encode_chunked(values: np.ndarray, chunk_len: int = DEFAULT_CHUNK_LEN,
                   e1: int | None = None, e2: int | None = None,
                   layout: str = "tpu", optimize: bool | str = False, *,
                   device="cuda") -> bytes:
    """Encode a uint32 (f32) or uint64 (f64) raw-bits stream into a v1
    chunked FP container: :func:`encode_fp_planes` of one plane. ``device``
    is ``"cuda"`` unless the caller asks for ``"cpu"`` or gives a mesh."""
    return encode_fp_planes(values[None], chunk_len, e1, e2, layout, optimize,
                            device=device)[0]


def decode_chunked(data, *, device="cuda") -> tuple[np.ndarray, int]:
    """Decode a v1 FP chunked container (bytes or a memoryview, read in
    place), either chunk layout → (uint32 or uint64 array, bits).

    The host parses and validates the framing before anything is launched.
    The full chunks are grouped by their hash_info byte and each group is
    split over the shards of ``device`` (a device or a
    :class:`~.shards.Mesh`). Groups whose tables pass
    ``DEVICE_TABLE_WORDS`` (f32 (14,18), f64 (20,20) winners) decode on the
    host, and so does the tail chunk, whose count must be what ``total``
    leaves; so do f64 reference-layout chunks when the host library that
    parses them is missing (trico_tpu/chunked.py:708-710).

    The tally counts the full chunks of each exponent pair and route as
    ``fp_chunks.<e1>_<e2>.<host|device>`` (calls: chunks, bytes: their
    decoded words' bytes), and the full chunks' words of any route under
    ``fp_read_words``; the host route is the span ``fp_host_chunks``."""
    mesh = _resolve_device(device)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "fp":
        raise ValueError(f"{hdr.kind} container passed to decode_chunked "
                         "(FP containers only)")
    bits, layout = hdr.bits, hdr.layout
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    out = np.empty(total, np.uint32 if bits == 32 else np.uint64)
    n_full = total // chunk_len
    if bits == 64 and layout == "ref" and not native.available():
        n_full = 0
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    buf = np.frombuffer(data, np.uint8)
    if n_full:
        full_sizes = np.asarray(sizes[:n_full], np.int64)
        mat = bytes_to_rows(buf[offsets[0] : offsets[n_full]], full_sizes,
                            _fp_max_bytes(bits, chunk_len))
        rows = out[: n_full * chunk_len].reshape(n_full, chunk_len)
        profiling.count("fp_read_words", nbytes=rows.nbytes)
        for info in np.unique(mat[:, 0]):
            idx = np.nonzero(mat[:, 0] == info)[0]
            e1, e2 = fp_torch.exponents(int(info))
            words = len(idx) * chunk_len * out.itemsize
            if (1 << e1) + (1 << e2) > DEVICE_TABLE_WORDS:
                profiling.count(f"fp_chunks.{e1}_{e2}.host", words, len(idx))
                with profiling.span("fp_host_chunks", nbytes=words):
                    rows[idx] = host_decode_full_chunks(mat, full_sizes, idx,
                                                        chunk_len, bits, layout)
            else:
                profiling.count(f"fp_chunks.{e1}_{e2}.device", words, len(idx))
                rows[idx] = _decode_rows(mat[idx][None], chunk_len, e1, e2,
                                         bits, layout, mesh)[0]
    for c in range(n_full, n_chunks):
        # host-coded in the reference layout: the tail chunk, or every chunk
        vals = _host_fp_decode(buf[offsets[c] : offsets[c + 1]], bits)
        start = c * chunk_len
        if len(vals) != min(chunk_len, total - start):
            raise ValueError("corrupt chunked container: a host-coded chunk "
                             "does not hold the count the total leaves it")
        out[start : start + len(vals)] = vals
    return out, bits


# ---------------------------------------------------------------------------
# BP32 / BP64 containers (flags bit 3)
# ---------------------------------------------------------------------------


def _host_bp_payloads(values: np.ndarray, chunk_len: int) -> list[bytes]:
    """The host BP coding of a stream, one payload per chunk."""
    if not len(values):
        return []
    if native.available():
        return native.bp_encode_blocks(values, chunk_len)
    return [bp_ref.encode_chunk(values[s : s + chunk_len])
            for s in range(0, len(values), chunk_len)]


def encode_bp_chunked(values: np.ndarray, chunk_len: int = DEFAULT_BP_CHUNK,
                      *, device="cuda") -> bytes:
    """BP container of a flat uint32 or uint64 stream: bit-plane-packed
    zigzag deltas in independent chunks (format: :mod:`.codec.bp_ref`).
    ``chunk_len`` is capped at 8192 for u64 and rounded down to a multiple
    of 32. The full chunks are encoded on ``device`` (a mesh's first
    shard), the tail chunk on the host; a stream with no full chunk is
    host-coded, as in ``trico_tpu``. The rows and sizes come back into the page-locked slots
    ``bp_rows`` and ``bp_sizes`` of :mod:`.staging`; ``_rows_body`` copies
    them out before this returns."""
    dev = _resolve_device(device).shards[0]
    values = np.ascontiguousarray(values)
    eb = values.dtype.itemsize
    if eb not in (4, 8):
        raise TypeError(values.dtype)
    if eb == 8:
        chunk_len = min(chunk_len, bp_torch.BP64_MAX_CHUNK)
    chunk_len = (chunk_len // 32) * 32 or 32
    n = len(values)
    C = n // chunk_len
    flags = _FLAG_BP | (_FLAG_F64 if eb == 8 else 0)
    if C == 0:
        body = _host_bp_payloads(values, chunk_len)
        return _frame(flags, chunk_len, n, [len(p) for p in body], body)
    full = values[: C * chunk_len].reshape(C, chunk_len)
    with profiling.span("bp_encode", nbytes=full.nbytes, sync=dev):
        if eb == 4:
            mat, sizes = bp_torch.encode_bp32_chunks(_u32.from_numpy(full).to(dev))
        else:
            mat, sizes = bp_torch.encode_bp64_chunks(_u64.from_numpy(full).to(dev))
    with profiling.span("bp_d2h", nbytes=mat.numel() * mat.element_size()
                        + sizes.numel() * sizes.element_size()):
        mat = staging.to_host(mat, "bp_rows")
        sizes = staging.to_host(sizes, "bp_sizes")
    with profiling.span("bp_assembly", nbytes=values.nbytes):
        chunk_sizes, body = _rows_body(mat, sizes)
        tail = values[C * chunk_len :]
        if len(tail):
            tp = _host_bp_payloads(tail, chunk_len)[0]
            chunk_sizes.append(len(tp))
            body.append(tp)
        return _frame(flags, chunk_len, n, chunk_sizes, body)


def validate_bp_chunk_headers(mat: np.ndarray, sizes: np.ndarray,
                              chunk_len: int, width_bits: int) -> None:
    """Validate the per-chunk BP width headers of padded full-chunk rows
    before their payloads go to the device.

    The host decoders reject ``w > width_bits`` and truncated plane payloads,
    but the device bit-plane parse would feed corrupt widths as negative
    displacements into the monotone compaction and return garbage. So the
    native checks are made here first: every width ≤ ``width_bits`` and each
    chunk's declared payload size exactly ``n_groups + 4*sum(w)`` (BP64
    planes are 32-bit words too)."""
    n_groups = chunk_len // 32
    widths = mat[:, :n_groups].astype(np.int64)
    if widths.size and int(widths.max()) > width_bits:
        raise ValueError("corrupt BP32 chunk: width exceeds element bits")
    if np.any(n_groups + 4 * widths.sum(axis=1) != sizes):
        raise ValueError("corrupt BP32 chunk: payload size does not match "
                         "width header")


def _bp_host_decode(payload, n, eb):
    if native.available():
        return native.bp_decode_blocks(payload, [0], [len(payload)], [n], eb)
    return bp_ref.decode_chunk(payload, n, eb * 8)


def _host_bp_decode_all(buf, hdr, sizes, off) -> np.ndarray:
    """Host decode of every chunk of a BP container."""
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    eb = hdr.bits // 8
    dt = np.uint32 if eb == 4 else np.uint64
    if n_chunks == 0 or total == 0:
        return np.zeros(total, dt)
    counts = np.minimum(chunk_len,
                        total - chunk_len * np.arange(n_chunks, dtype=np.int64))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    if native.available():
        return native.bp_decode_blocks(buf, offsets[:-1],
                                       np.asarray(sizes, np.int64), counts, eb)
    out = np.empty(total, dt)
    for c in range(n_chunks):
        out[c * chunk_len : c * chunk_len + counts[c]] = bp_ref.decode_chunk(
            buf[offsets[c] : offsets[c + 1]], int(counts[c]), eb * 8)
    return out


def decode_bp_chunked(data, *, device="cuda") -> np.ndarray:
    """Decode a BP container (bytes or a memoryview, read in place) → flat
    uint32 or uint64 array.

    The host parses the framing and validates every full chunk's width
    header before anything is launched; each shard of ``device`` (a device
    or a :class:`~.shards.Mesh`) decodes its range of the full chunks, the
    host the tail. Containers the device path cannot take (no full chunk,
    a chunk length off the 32-value grid, u64 chunks past 8192) decode on
    the host, as in ``trico_tpu``."""
    mesh = _resolve_device(device)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "bp":
        raise ValueError("not a BP32 container")
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    eb = hdr.bits // 8
    n_full = total // chunk_len
    buf = np.frombuffer(data, np.uint8)
    if (n_full == 0 or chunk_len % 32
            or (eb == 8 and chunk_len > bp_torch.BP64_MAX_CHUNK)):
        return _host_bp_decode_all(buf, hdr, sizes, off)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    full_sizes = np.asarray(sizes[:n_full], np.int64)
    if eb == 4:
        B, dec, dtype = (bp_torch.bp32_max_chunk_bytes(chunk_len),
                         bp_torch.decode_bp32_chunks, np.uint32)
    else:
        B, dec, dtype = (bp_torch.bp64_max_chunk_bytes(chunk_len),
                         bp_torch.decode_bp64_chunks, np.uint64)
    mat = bytes_to_rows(buf[offsets[0] : offsets[n_full]], full_sizes, B)
    validate_bp_chunk_headers(mat, full_sizes, chunk_len, eb * 8)
    out = np.empty(total, dtype)
    (vals,) = shards.local_chunks(lambda x: (dec(x, chunk_len),), mat[None], mesh,
                                  [((chunk_len,), dtype)], ("bp_read_h2d", "bp_read_d2h"))
    out[: n_full * chunk_len] = shards.gather_to_host(vals, n_full, mesh).reshape(-1)
    for c in range(n_full, n_chunks):
        count = total - c * chunk_len
        out[c * chunk_len :] = _bp_host_decode(buf[offsets[c] : offsets[c + 1]],
                                               count, eb)
    return out


# ---------------------------------------------------------------------------
# LZ4 byte-plane containers (flags bit 1) and the pick-best integer coding
# ---------------------------------------------------------------------------


def encode_fill(value: int, total: int) -> bytes:
    """A "fill" container: ``total`` copies of one byte in 19 bytes."""
    return _frame(_FLAG_LZ4 | _FLAG_BP, total, total, [1], [bytes([value])])


def decode_fill(data) -> np.ndarray:
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "fill":
        raise ValueError("not a fill container")
    if sizes != (1,) or hdr.chunk_len != hdr.total:
        raise ValueError("corrupt fill container")
    return np.full(hdr.total, data[off], np.uint8)


def _host_lz4_payloads(plane: np.ndarray, block_len: int) -> list[bytes]:
    """The host LZ4 coding of a byte plane, one payload per block (an empty
    plane is one empty block)."""
    n = len(plane)
    if native.available() and n:
        return native.lz4_compress_blocks(plane, block_len)
    comp = (native.lz4_compress if native.available()
            else lambda d: lz4_ref.compress(bytes(d)))
    return [comp(plane[i : i + block_len])
            for i in range(0, max(n, 1), block_len)]


def encode_lz4_chunked(plane: np.ndarray, block_len: int = DEFAULT_LZ4_BLOCK,
                       *, device="cuda") -> bytes:
    """Chunked-LZ4 container of a byte plane: independent LZ4 blocks of
    ``block_len`` bytes. With the C++ host library and at least one full
    block, the match search of the full blocks runs on ``device`` (a
    mesh's first shard) and the host emits them
    (:func:`.codec.lz4_torch.compress_plane`); otherwise the host codec
    compresses every block, as in ``trico_tpu``."""
    dev = _resolve_device(device).shards[0]
    plane = np.ascontiguousarray(plane, dtype=np.uint8).reshape(-1)
    n = len(plane)
    if native.available() and n >= block_len:
        payloads = lz4_torch.compress_plane(plane, block_len, device=dev)
    else:
        payloads = _host_lz4_payloads(plane, block_len)
    return _frame(_FLAG_LZ4, block_len, n, [len(p) for p in payloads], payloads)


def decode_lz4_chunked(data) -> np.ndarray:
    """Decode a chunked-LZ4 (or fill) container → the byte plane, on the
    host: independent blocks across the native library's threads, or the
    pure-Python decoder block by block. ``data`` (bytes or a memoryview)
    is read in place."""
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind == "fill":
        return decode_fill(data)
    if hdr.kind != "lz4":
        raise ValueError("not a chunked LZ4 container")
    block_len, total, n_blocks = hdr.chunk_len, hdr.total, hdr.n_chunks
    dst_sizes = np.minimum(
        block_len, total - block_len * np.arange(n_blocks, dtype=np.int64))
    if native.available():
        src_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64) + off
        return native.lz4_decompress_blocks(data, src_off, np.asarray(sizes), dst_sizes)
    out = np.empty(total, np.uint8)
    pos = off
    for i in range(n_blocks):
        size = int(dst_sizes[i])
        out[i * block_len : i * block_len + size] = np.frombuffer(
            lz4_ref.decompress(data[pos : pos + sizes[i]], size), np.uint8)
        pos += sizes[i]
    return out


def encode_int_best(arr: np.ndarray, block_len: int | None = None, *,
                    device="cuda") -> list[bytes]:
    """Integer stream → the smaller of LZ4 byte planes and one BP container,
    as the stream's ``itemsize`` substream payloads (the BP form pads with
    empty BP placeholder containers). Constant byte planes are 19-byte fill
    containers. The same choice as ``trico_tpu.chunked.encode_int_best``.
    Its spans: ``int_planes`` (the byte planes and the fill check), then
    those of :func:`.codec.lz4_torch.compress_plane` and
    :func:`encode_bp_chunked`."""
    arr = np.ascontiguousarray(arr)
    with profiling.span("int_planes", nbytes=arr.nbytes):
        planes, fills = transpose.split_byte_planes(arr)
    lz4_subs = [
        encode_fill(int(plane[0]), len(plane)) if fill
        else encode_lz4_chunked(plane, block_len or DEFAULT_LZ4_BLOCK,
                                device=device)
        for plane, fill in zip(planes, fills)]
    flat = arr.reshape(-1)
    if flat.dtype.itemsize in (4, 8):
        bp = encode_bp_chunked(flat, device=device)
        flags = _FLAG_BP | (_FLAG_F64 if flat.dtype.itemsize == 8 else 0)
        placeholder = _frame(flags, DEFAULT_BP_CHUNK, 0, [], [])
        bp_total = len(bp) + (arr.dtype.itemsize - 1) * len(placeholder)
        if bp_total < sum(len(s) for s in lz4_subs):
            return [bp] + [placeholder] * (arr.dtype.itemsize - 1)
    return lz4_subs
