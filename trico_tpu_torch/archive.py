"""The trico archive container, reference-format compatible: the writer and
reader of v0 archives on the host and of v1 archives through the port.

Counterpart of ``trico_tpu/archive.py``, under the same names, and the port's
own code throughout. With ``chunk_len`` set, :class:`ArchiveWriter` writes a
version-1 archive whose substreams are coded on ``device`` (``"cuda"`` by
default; ``"cpu"`` on request):

* FP substreams through :func:`trico_tpu_torch.chunked.encode_chunked` /
  :func:`~trico_tpu_torch.chunked.decode_chunked`, in either chunk layout;
* integer streams through :func:`~trico_tpu_torch.chunked.encode_int_best`
  (BP container or LZ4 byte planes, fill containers for constant planes) and
  :func:`~trico_tpu_torch.chunked.decode_bp_chunked`; the LZ4 decoder is the
  host's;
* ``attribute_uint8`` streams through
  :func:`~trico_tpu_torch.chunked.encode_lz4_chunked`.

A v1 archive written here is byte for byte the one ``trico_tpu`` writes on a
device host: the chunk layout defaults to "tpu", the v0 f32 default exponents
(4,10) map to the chunked default (4,6), and chunks adapt their exponents
inside ``encode_chunked``. v0 archives (no ``chunk_len``) are written and
read on the host, by the C++ host library or the NumPy oracles.

File layout (reference trico/trico.c:90-124 and README "Format specification"):

* header: ``[u32 LE magic 0x6f637254 ("Trco")][u32 LE version=0]``
* then stream blocks: ``[u8 stream_type][u32 LE element_count]`` followed by
  type-specific substreams, each framed ``[u32 LE compressed_size][payload]``:

  - vec3 float/double (vertices, normals): 3 FP substreams (x, y, z),
    exponents (4,10) f32 / (20,20) f64 (trico.c:215-262, 380-427)
  - vec2 float/double (uv): 2 FP substreams (u, v) (trico.c:534-618)
  - attribute float/double: 1 FP substream, no transpose (trico.c:279-321)
  - triangle u32 / attr u32 / colors: 4 LZ4 byte planes (LSB first)
    of count*3 (triangles) or count elements (trico.c:323-378, 698-753)
  - triangle u64 / attr u64: 8 LZ4 byte planes (trico.c:444-532, 770-858)
  - attr u16: 2 LZ4 planes; attr u8: 1 LZ4 substream (trico.c:630-696)

Deliberate deviations from reference *quirks* (SURVEY.md "Reference quirks"):

* #1: double-precision uv streams are tagged with the correct ``*_double``
  enums. (The reference tags them as float, trico.c:620-628, which makes its
  own double-uv round-trip broken; files we write with double uvs are
  therefore not a thing the reference could read correctly either way.)
* #2 is preserved: ``write_uv_per_triangle`` stores count = 3*n_triangles.
* #4: worst-case buffers are sized correctly.
* #5: attribute float/double readers return arrays (no pointer aliasing).
"""

from __future__ import annotations

import enum
import struct
from typing import Optional

import numpy as np

from . import chunked, native, profiling
from .codec import fp_ref, lz4_ref, transpose

__all__ = ["ArchiveReader", "ArchiveWriter", "StreamType"]

MAGIC = 0x6F637254  # "Trco" little-endian
VERSION = 0


class StreamType(enum.IntEnum):
    """Stream type tags (reference trico/trico.h:11-34)."""

    empty = 0
    vertex_float = 1
    vertex_double = 2
    triangle_uint32 = 3
    triangle_uint64 = 4
    uv_per_vertex_float = 5
    uv_per_vertex_double = 6
    uv_per_triangle_float = 7
    uv_per_triangle_double = 8
    vertex_normal_float = 9
    vertex_normal_double = 10
    triangle_normal_float = 11
    triangle_normal_double = 12
    vertex_color = 13
    triangle_color = 14
    attribute_float = 15
    attribute_double = 16
    attribute_uint8 = 17
    attribute_uint16 = 18
    attribute_uint32 = 19
    attribute_uint64 = 20


# default hash exponents (trico.c:231, 396)
F32_EXP = (4, 10)
F64_EXP = (20, 20)
# Adaptive-exponent candidate sets. The FP substream header's hash_info byte
# makes exponents self-describing (fps.c:120-121, 214-217), so any choice
# stays decodable by the reference library; picking the smallest result per
# plane beats the reference's fixed defaults (measured -5.6%% on the bunny's
# vertex payload, almost all of it from the y plane at large tables).
#
# The default set stops at (14,18): beyond that the DFCM table (2^e2 entries)
# blows past L2 and the *decode* pred-load chain — which is serial per value —
# misses cache on every value (measured 0.59 ms vs 0.33 ms per bunny plane for
# (16,20) vs (14,18), for 3.8%% size difference). optimize="max" adds the
# big-table candidates for callers who want minimum bytes regardless of
# decode speed.
F32_EXP_CANDIDATES = ((4, 10), (2, 8), (8, 14), (14, 18))
F32_EXP_CANDIDATES_MAX = F32_EXP_CANDIDATES + ((12, 18), (16, 20))
F64_EXP_CANDIDATES = ((20, 20), (10, 16), (16, 20))
F64_EXP_CANDIDATES_MAX = F64_EXP_CANDIDATES + ((20, 22),)


def _backends(use_native: bool = True):
    """Return (fp_encode, fp_decode, lz4_compress, lz4_decompress)."""
    if use_native and native.available():
        return (
            native.fp_encode,
            native.fp_decode,
            native.lz4_compress,
            lambda d, n: native.lz4_decompress(d, n),
        )
    return (
        lambda v, e1, e2: fp_ref.compress(v, e1, e2),
        lambda d, bits: (fp_ref.decompress_f32(d) if bits == 32 else fp_ref.decompress_f64(d)),
        lambda d: lz4_ref.compress(bytes(d)),
        lambda d, n: np.frombuffer(lz4_ref.decompress(bytes(d), n), dtype=np.uint8),
    )


class ArchiveWriter:
    """Builds a trico archive in memory.

    Mirrors the ``trico_open_archive_for_writing`` / ``trico_write_*`` /
    ``trico_get_buffer_pointer`` flow (trico.h:36-62) with a pythonic API.

    With ``chunk_len`` set, writes a *version-1* archive whose substream
    payloads are chunked containers (:mod:`trico_tpu_torch.chunked`), coded
    on ``device`` in the ``layout`` given ("tpu" by default, or "ref") with
    the chunked profile ``optimize`` (True, ``"fast"`` or False); not
    readable by the reference library. Default (None) writes
    reference-compatible version-0 archives on the host.
    """

    def __init__(self, use_native: bool = True, chunk_len: int | None = None,
                 layout: str | None = None, optimize: bool | str = True, *,
                 device="cuda"):
        self._device = chunked._resolve_device(device)
        self._fp_enc, _, self._lz4_c, _ = _backends(use_native)
        self._chunk_len = chunk_len
        # threaded batch engine for v0 streams (plane x candidate jobs run
        # concurrently; the reference encodes serially, trico.c:215-262)
        self._native = None
        if use_native and not chunk_len and native.available():
            self._native = native
        # whole-plane adaptive exponents (v0); chunked archives adapt
        # per chunk inside encode_chunked instead (device argmin — one
        # program, no 5x host encodes)
        # NOTE: must preserve the string profiles ("fast"/"max") — a plain
        # ``optimize and not chunk_len`` would collapse them to bool True
        self._optimize = optimize if not chunk_len else False
        version = 1 if chunk_len else VERSION
        self._parts: list[bytes] = [struct.pack("<II", MAGIC, version)]
        if chunk_len:
            # Chunk layout: v2 "tpu" (tags-first) unless the caller names the
            # reference layout. Sizes are identical either way; the container
            # is self-describing.
            if layout is None:
                layout = "tpu"
            dev = self._device

            def _enc(vals, e1, e2):
                # the v0 stream default (4,10) maps to the chunked-mode
                # default F32_TPU_EXP (self-describing per chunk); explicit
                # caller exponents pass through
                if (e1, e2) == F32_EXP and vals.dtype == np.uint32:
                    e1, e2 = chunked.F32_TPU_EXP
                return chunked.encode_chunked(vals, chunk_len, e1, e2,
                                              layout=layout, optimize=optimize,
                                              device=dev)

            self._fp_enc = _enc
            self._lz4_c = lambda plane: chunked.encode_lz4_chunked(
                plane, device=dev)

    # -- low-level helpers -------------------------------------------------

    def _begin(self, st: StreamType, count: int):
        if not (0 <= count < 2**32):
            raise ValueError("element count must fit in uint32")
        self._parts.append(struct.pack("<BI", int(st), count))

    def _sub(self, payload: bytes):
        self._parts.append(struct.pack("<I", len(payload)))
        self._parts.append(payload)

    def _write_fp_planes(self, st: StreamType, arr: np.ndarray, width: int, count: int):
        if arr.dtype == np.float32:
            raw, exp = arr.view(np.uint32), F32_EXP
        elif arr.dtype == np.float64:
            raw, exp = arr.view(np.uint64), F64_EXP
        else:
            raise TypeError(f"expected float32/float64, got {arr.dtype}")
        self._begin(st, count)
        # one contiguous (width, n) SoA block: plane i is row i (zero-copy
        # views; the native search encoder takes the block in one call)
        with profiling.span("fp_split", nbytes=raw.nbytes):
            soa = np.ascontiguousarray(raw.reshape(-1, width).T)
        for payload in self._fp_best_planes(soa, exp):
            self._sub(payload)

    def _fp_best_planes(self, planes, default_exp) -> list[bytes]:
        """Encode planes; with optimize, pick the smallest payload per plane
        over the candidate exponent set (self-describing, so decode is
        unaffected). All (plane, candidate) jobs run concurrently on the
        native path — wall time is one encode, not len(planes)*len(cands)."""
        if self._optimize == "max":
            cands = (F32_EXP_CANDIDATES_MAX if planes[0].dtype == np.uint32
                     else F64_EXP_CANDIDATES_MAX)
        elif self._optimize == "fast":
            # throughput profile: no candidate search, reference default
            # exponents only (v0 output == the reference's own byte layout
            # choices; chunked archives map "fast" to the small-table
            # candidate set instead — chunked.encode_chunked)
            cands = (default_exp,)
        elif self._optimize:
            cands = (F32_EXP_CANDIDATES if planes[0].dtype == np.uint32
                     else F64_EXP_CANDIDATES)
        else:
            cands = (default_exp,)
        if self._native is not None:
            if len(cands) == 1:
                return self._native.fp_encode_each(planes, list(cands) * len(planes))
            # one native call: rank candidates on a prefix encode per plane
            # (compression is roughly stationary along a plane, so a prefix
            # ranks reliably; worst case is a few bytes of missed
            # optimization, never corruption — exponents stay
            # self-describing), then full-encode each plane's winner. The
            # default pair wins near-ties (see tt_fp32_search_encode).
            n = max(len(p) for p in planes)
            return self._native.fp_search_encode(
                planes, list(cands), prefix_n=max(2048, n // 16))
        out = []
        for plane in planes:
            best = None
            for e in cands:
                payload = self._fp_enc(plane, *e)
                if best is None or len(payload) < len(best):
                    best = payload
            out.append(best)
        return out

    def _fp_best(self, plane: np.ndarray, default_exp) -> bytes:
        """Single-plane form of :meth:`_fp_best_planes`."""
        return self._fp_best_planes([plane], default_exp)[0]

    def _write_lz4_planes(self, st: StreamType, arr: np.ndarray, count: int):
        self._begin(st, count)
        if self._chunk_len:
            # v1: pick-best integer coding per stream — BP32 vs LZ4 byte
            # planes for u32/u64 (BP32 wins ~6% on index-like data), with
            # constant planes short-circuited to 19-byte fill containers
            # for every width (chunked.encode_int_best)
            for payload in chunked.encode_int_best(arr, device=self._device):
                self._sub(payload)
            return
        if self._native is not None:
            # fused native shuffle + threaded partitioned LZ4 (one call)
            for payload in self._native.lz4_shuffle_compress(arr):
                self._sub(payload)
            return
        for plane in transpose.byte_planes(arr):
            self._sub(self._lz4_c(plane))

    # -- typed writers (parity with trico.h:40-59) -------------------------

    def write_vertices(self, v):
        v = np.ascontiguousarray(v, dtype=np.float32)
        self._write_fp_planes(StreamType.vertex_float, v, 3, v.size // 3)

    def write_vertices_double(self, v):
        v = np.ascontiguousarray(v, dtype=np.float64)
        self._write_fp_planes(StreamType.vertex_double, v, 3, v.size // 3)

    def write_vertex_normals(self, v):
        v = np.ascontiguousarray(v, dtype=np.float32)
        self._write_fp_planes(StreamType.vertex_normal_float, v, 3, v.size // 3)

    def write_vertex_normals_double(self, v):
        v = np.ascontiguousarray(v, dtype=np.float64)
        self._write_fp_planes(StreamType.vertex_normal_double, v, 3, v.size // 3)

    def write_triangle_normals(self, v):
        v = np.ascontiguousarray(v, dtype=np.float32)
        self._write_fp_planes(StreamType.triangle_normal_float, v, 3, v.size // 3)

    def write_triangle_normals_double(self, v):
        v = np.ascontiguousarray(v, dtype=np.float64)
        self._write_fp_planes(StreamType.triangle_normal_double, v, 3, v.size // 3)

    def write_uv_per_vertex(self, uv):
        uv = np.ascontiguousarray(uv, dtype=np.float32)
        self._write_fp_planes(StreamType.uv_per_vertex_float, uv, 2, uv.size // 2)

    def write_uv_per_vertex_double(self, uv):
        uv = np.ascontiguousarray(uv, dtype=np.float64)
        self._write_fp_planes(StreamType.uv_per_vertex_double, uv, 2, uv.size // 2)

    def write_uv_per_triangle(self, uv):
        """uv: (n_triangles, 6) or flat; count stored = 3 * n_triangles
        (reference trico.c:577-580)."""
        uv = np.ascontiguousarray(uv, dtype=np.float32)
        self._write_fp_planes(StreamType.uv_per_triangle_float, uv, 2, uv.size // 2)

    def write_uv_per_triangle_double(self, uv):
        uv = np.ascontiguousarray(uv, dtype=np.float64)
        self._write_fp_planes(StreamType.uv_per_triangle_double, uv, 2, uv.size // 2)

    def write_triangles(self, tri):
        tri = np.ascontiguousarray(tri, dtype=np.uint32)
        self._write_lz4_planes(StreamType.triangle_uint32, tri, tri.size // 3)

    def write_triangles_long(self, tri):
        tri = np.ascontiguousarray(tri, dtype=np.uint64)
        self._write_lz4_planes(StreamType.triangle_uint64, tri, tri.size // 3)

    def write_vertex_colors(self, colors):
        colors = np.ascontiguousarray(colors, dtype=np.uint32)
        self._write_lz4_planes(StreamType.vertex_color, colors, colors.size)

    def write_triangle_colors(self, colors):
        colors = np.ascontiguousarray(colors, dtype=np.uint32)
        self._write_lz4_planes(StreamType.triangle_color, colors, colors.size)

    def write_attributes_float(self, a):
        a = np.ascontiguousarray(a, dtype=np.float32)
        self._begin(StreamType.attribute_float, a.size)
        self._sub(self._fp_best(a.view(np.uint32), F32_EXP))

    def write_attributes_double(self, a):
        a = np.ascontiguousarray(a, dtype=np.float64)
        self._begin(StreamType.attribute_double, a.size)
        self._sub(self._fp_best(a.view(np.uint64), F64_EXP))

    def write_attributes_uint8(self, a):
        a = np.ascontiguousarray(a, dtype=np.uint8)
        self._begin(StreamType.attribute_uint8, a.size)
        self._sub(self._lz4_c(a))

    def write_attributes_uint16(self, a):
        a = np.ascontiguousarray(a, dtype=np.uint16)
        self._write_lz4_planes(StreamType.attribute_uint16, a, a.size)

    def write_attributes_uint32(self, a):
        a = np.ascontiguousarray(a, dtype=np.uint32)
        self._write_lz4_planes(StreamType.attribute_uint32, a, a.size)

    def write_attributes_uint64(self, a):
        a = np.ascontiguousarray(a, dtype=np.uint64)
        self._write_lz4_planes(StreamType.attribute_uint64, a, a.size)

    # ----------------------------------------------------------------------

    def tobytes(self) -> bytes:
        with profiling.span("archive_join",
                            nbytes=sum(len(p) for p in self._parts)):
            return b"".join(self._parts)

    def save(self, path):
        with open(path, "wb") as f:
            for p in self._parts:
                f.write(p)


# number of FP/LZ4 substreams and element width per stream type
_FP_STREAMS = {
    StreamType.vertex_float: (3, 32),
    StreamType.vertex_double: (3, 64),
    StreamType.vertex_normal_float: (3, 32),
    StreamType.vertex_normal_double: (3, 64),
    StreamType.triangle_normal_float: (3, 32),
    StreamType.triangle_normal_double: (3, 64),
    StreamType.uv_per_vertex_float: (2, 32),
    StreamType.uv_per_vertex_double: (2, 64),
    StreamType.uv_per_triangle_float: (2, 32),
    StreamType.uv_per_triangle_double: (2, 64),
    StreamType.attribute_float: (1, 32),
    StreamType.attribute_double: (1, 64),
}
_LZ4_STREAMS = {
    StreamType.triangle_uint32: (4, np.uint32, 3),
    StreamType.triangle_uint64: (8, np.uint64, 3),
    StreamType.vertex_color: (4, np.uint32, 1),
    StreamType.triangle_color: (4, np.uint32, 1),
    StreamType.attribute_uint8: (1, np.uint8, 1),
    StreamType.attribute_uint16: (2, np.uint16, 1),
    StreamType.attribute_uint32: (4, np.uint32, 1),
    StreamType.attribute_uint64: (8, np.uint64, 1),
}


class ArchiveReader:
    """Reads a trico archive (reference- or self-produced).

    State machine matches the reference: the next stream's tag is always
    prefetched (trico.c:100-124); typed reads fail on tag mismatch; peeks do
    not advance (trico.c:860-941); skip works for every known type. The FP
    and BP substreams of a v1 archive decode on ``device``.
    """

    def __init__(self, data, use_native: bool = True, *, device="cuda"):
        self._device = dev = chunked._resolve_device(device)
        _, self._fp_dec, _, self._lz4_d = _backends(use_native)
        self._native = None
        if use_native and native.available():
            self._native = native
        self._data = memoryview(bytes(data) if not isinstance(data, (bytes, memoryview)) else data)
        if len(self._data) < 8:
            raise ValueError("not a trico archive (truncated header)")
        magic, version = struct.unpack_from("<II", self._data, 0)
        if magic != MAGIC:
            raise ValueError("not a trico archive (bad magic)")
        self.version = version
        if version == 1:
            def _dec(payload, bits):
                vals, got_bits = chunked.decode_chunked(payload, device=dev)
                if got_bits != bits:
                    raise ValueError("chunked container width mismatch")
                return vals

            self._fp_dec = _dec
            self._lz4_d = lambda payload, n: chunked.decode_lz4_chunked(payload)
        elif version != 0:
            raise ValueError(f"unsupported archive version {version}")
        self._pos = 8
        self._advance_stream_type()

    def _advance_stream_type(self):
        if self._pos < len(self._data):
            self._next = StreamType(self._data[self._pos])
            self._pos += 1
        else:
            self._next = StreamType.empty

    @property
    def next_stream_type(self) -> StreamType:
        return self._next

    def _peek_count(self) -> int:
        if self._pos + 4 > len(self._data):
            raise ValueError("truncated archive")
        return struct.unpack_from("<I", self._data, self._pos)[0]

    # peeks (trico.h:67-72)
    def num_vertices(self) -> int:
        return self._peek_count() if self._next in (StreamType.vertex_float, StreamType.vertex_double) else 0

    def num_triangles(self) -> int:
        return self._peek_count() if self._next in (StreamType.triangle_uint32, StreamType.triangle_uint64) else 0

    def num_uvs(self) -> int:
        uv = (StreamType.uv_per_vertex_float, StreamType.uv_per_vertex_double,
              StreamType.uv_per_triangle_float, StreamType.uv_per_triangle_double)
        return self._peek_count() if self._next in uv else 0

    def num_normals(self) -> int:
        nm = (StreamType.vertex_normal_float, StreamType.vertex_normal_double,
              StreamType.triangle_normal_float, StreamType.triangle_normal_double)
        return self._peek_count() if self._next in nm else 0

    def num_colors(self) -> int:
        return self._peek_count() if self._next in (StreamType.vertex_color, StreamType.triangle_color) else 0

    def num_attributes(self) -> int:
        at = (StreamType.attribute_float, StreamType.attribute_double, StreamType.attribute_uint8,
              StreamType.attribute_uint16, StreamType.attribute_uint32, StreamType.attribute_uint64)
        return self._peek_count() if self._next in at else 0

    # -- generic stream reader ---------------------------------------------

    def _read_u32(self) -> int:
        if self._pos + 4 > len(self._data):
            raise ValueError("truncated archive")
        v = struct.unpack_from("<I", self._data, self._pos)[0]
        self._pos += 4
        return v

    def _read_sub(self) -> memoryview:
        size = self._read_u32()
        if self._pos + size > len(self._data):
            raise ValueError("truncated archive")
        payload = self._data[self._pos : self._pos + size]
        self._pos += size
        return payload

    def read_stream(self, expect: Optional[StreamType] = None):
        """Read the next stream generically. Returns ``(stream_type, array)``.

        vec3/vec2 float streams → (count, width) float arrays; triangles →
        (count, 3) uint arrays; colors/attributes → 1-D arrays.
        """
        st = self._next
        if st == StreamType.empty:
            return st, None
        if expect is not None and st != expect:
            raise ValueError(f"expected {expect.name} stream, found {st.name}")
        count = self._read_u32()
        if st in _FP_STREAMS:
            width, bits = _FP_STREAMS[st]
            subs = [np.frombuffer(self._read_sub(), dtype=np.uint8)
                    for _ in range(width)]
            if self._native is not None and self.version == 0 and width > 1:
                # all planes through one threaded native call (the reference
                # decodes substreams one at a time, trico.c:950-958)
                for s in subs:
                    if len(s) < 5:
                        raise ValueError("truncated FP substream")
                counts = np.array(
                    [int.from_bytes(s[1:5].tobytes(), "big") for s in subs],
                    np.int64)
                sizes = np.array([len(s) for s in subs], np.int64)
                offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
                vals = self._native.fp_decode_blocks(
                    np.concatenate(subs), offs, sizes, counts, bits)
                planes = np.split(vals, np.cumsum(counts)[:-1])
            else:
                planes = [self._fp_dec(s, bits) for s in subs]
            for p in planes:
                if len(p) != count:
                    raise ValueError("substream count mismatch")
            ftype = np.float32 if bits == 32 else np.float64
            if width == 1:
                arr = planes[0].view(ftype)
            else:
                arr = transpose.soa_to_aos(planes).view(ftype).reshape(-1, width)
        else:
            nplanes, dtype, mult = _LZ4_STREAMS[st]
            n_elem = count * mult
            subs = [np.frombuffer(self._read_sub(), dtype=np.uint8)
                    for _ in range(nplanes)]
            bp_hdr = None
            if self.version == 1 and subs:
                bp_hdr = chunked.parse_container_header(subs[0])
                if bp_hdr is not None and bp_hdr.kind != "bp":
                    bp_hdr = None
            if bp_hdr is not None:
                # BP32 stream: full values live in substream 0; the remaining
                # substreams are empty placeholders keeping framing fixed
                arr = chunked.decode_bp_chunked(
                    subs[0], device=self._device).astype(dtype, copy=False)
                if len(arr) != n_elem:
                    raise ValueError("BP32 substream count mismatch")
            elif (self._native is not None and self.version == 0
                    and nplanes > 1 and n_elem):
                # fused native: threaded per-plane LZ4 decode + byte unshuffle
                sizes = np.array([len(s) for s in subs], np.int64)
                offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
                arr = self._native.lz4_decompress_unshuffle(
                    np.concatenate(subs), offs, sizes, n_elem, dtype)
            else:
                planes = [self._lz4_d(s, n_elem) for s in subs]
                if nplanes == 1:
                    arr = planes[0].view(dtype)
                else:
                    arr = transpose.from_byte_planes(planes, dtype)
            if mult == 3:
                arr = arr.reshape(-1, 3)
        self._advance_stream_type()
        return st, arr

    # -- typed readers (parity with trico.h:74-94) -------------------------

    def _typed(self, st: StreamType):
        _, arr = self.read_stream(expect=st)
        return arr

    def read_vertices(self):
        return self._typed(StreamType.vertex_float)

    def read_vertices_double(self):
        return self._typed(StreamType.vertex_double)

    def read_triangles(self):
        return self._typed(StreamType.triangle_uint32)

    def read_triangles_long(self):
        return self._typed(StreamType.triangle_uint64)

    def read_uv_per_vertex(self):
        return self._typed(StreamType.uv_per_vertex_float)

    def read_uv_per_vertex_double(self):
        return self._typed(StreamType.uv_per_vertex_double)

    def read_uv_per_triangle(self):
        return self._typed(StreamType.uv_per_triangle_float)

    def read_uv_per_triangle_double(self):
        return self._typed(StreamType.uv_per_triangle_double)

    def read_vertex_normals(self):
        return self._typed(StreamType.vertex_normal_float)

    def read_vertex_normals_double(self):
        return self._typed(StreamType.vertex_normal_double)

    def read_triangle_normals(self):
        return self._typed(StreamType.triangle_normal_float)

    def read_triangle_normals_double(self):
        return self._typed(StreamType.triangle_normal_double)

    def read_vertex_colors(self):
        return self._typed(StreamType.vertex_color)

    def read_triangle_colors(self):
        return self._typed(StreamType.triangle_color)

    def read_attributes_float(self):
        return self._typed(StreamType.attribute_float)

    def read_attributes_double(self):
        return self._typed(StreamType.attribute_double)

    def read_attributes_uint8(self):
        return self._typed(StreamType.attribute_uint8)

    def read_attributes_uint16(self):
        return self._typed(StreamType.attribute_uint16)

    def read_attributes_uint32(self):
        return self._typed(StreamType.attribute_uint32)

    def read_attributes_uint64(self):
        return self._typed(StreamType.attribute_uint64)

    def skip_next_stream(self) -> bool:
        """Skip the next stream without decoding payloads (cheap: framing only).

        Unlike the reference (which decodes then discards, trico.c:1670-1699)
        this just walks the [size][payload] framing.
        """
        st = self._next
        if st == StreamType.empty:
            return True
        count = self._read_u32()
        nsub = _FP_STREAMS[st][0] if st in _FP_STREAMS else _LZ4_STREAMS[st][0]
        for _ in range(nsub):
            self._read_sub()
        self._advance_stream_type()
        return True

    def streams(self):
        """Iterate (stream_type, array) until the archive is exhausted."""
        while self._next != StreamType.empty:
            yield self.read_stream()
