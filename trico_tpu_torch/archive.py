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
        # v0: whole-plane adaptive exponents; chunked archives adapt per
        # chunk inside chunked.encode_fp_planes (device argmin). The string
        # profiles ("fast"/"max") are kept as they are.
        self._optimize = optimize
        # Chunk layout: v2 "tpu" (tags-first) unless the caller names the
        # reference layout. Sizes are identical either way; the container
        # is self-describing.
        self._layout = layout or "tpu"
        version = 1 if chunk_len else VERSION
        self._parts: list[bytes] = [struct.pack("<II", MAGIC, version)]
        if chunk_len:
            self._lz4_c = lambda plane: chunked.encode_lz4_chunked(
                plane, device=self._device)

    # -- low-level helpers -------------------------------------------------

    def _begin(self, st: StreamType, count: int):
        if not (0 <= count < 2**32):
            raise ValueError("element count must fit in uint32")
        self._parts.append(struct.pack("<BI", int(st), count))

    def _sub(self, payload: bytes):
        self._parts.append(struct.pack("<I", len(payload)))
        self._parts.append(payload)

    def _write_fp_planes(self, st: StreamType, arr: np.ndarray, width: int, count: int,
                         f32_chunk_exp=chunked.F32_TPU_EXP):
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
        for payload in self._fp_best_planes(soa, exp, f32_chunk_exp):
            self._sub(payload)

    def _fp_best_planes(self, planes, default_exp,
                        f32_chunk_exp=chunked.F32_TPU_EXP) -> list[bytes]:
        """Encode (p, N) planes. v1: :func:`chunked.encode_fp_planes`, the
        full chunks of every plane in one batch on the device, f32 chunks at
        ``f32_chunk_exp`` without ``optimize`` (the v0 default (4,10) maps to
        the chunked default (4,6); exponents are self-describing per chunk).
        v0: with optimize, pick the smallest payload per plane over the
        candidate exponent set (self-describing, so decode is unaffected).
        All (plane, candidate) jobs run concurrently on the native path —
        wall time is one encode, not len(planes)*len(cands)."""
        if self._chunk_len:
            exp = f32_chunk_exp if planes.dtype == np.uint32 else default_exp
            return chunked.encode_fp_planes(planes, self._chunk_len, *exp,
                                            layout=self._layout,
                                            optimize=self._optimize,
                                            device=self._device)
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
        return self._fp_best_planes(plane[None], default_exp)[0]

    def _write_lz4_planes(self, st: StreamType, arr: np.ndarray, count: int):
        with profiling.span("int_encode", nbytes=arr.nbytes):
            self._begin(st, count)
            if self._chunk_len:
                # v1: pick-best integer coding per stream — BP32 vs LZ4 byte
                # planes for u32/u64 (BP32 wins ~6% on index-like data), with
                # constant planes short-circuited to 19-byte fill containers
                # for every width (chunked.encode_int_best)
                for payload in chunked.encode_int_best(arr, device=self._device):
                    self._sub(payload)
            elif self._native is not None:
                # fused native shuffle + threaded partitioned LZ4 (one call)
                for payload in self._native.lz4_shuffle_compress(arr):
                    self._sub(payload)
            else:
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

    def write_stream(self, name: str, arr) -> None:
        """Write ``arr`` as the stream that
        :func:`trico_tpu_torch.parallel.compress_mesh` takes under keyword
        ``name`` (``vertices``, ``triangles``, ``vertex_normals``, ...):
        float64 vertices, and triangles of u64 or with an index past u32, as
        the streams of 64-bit words; every other stream cast as its typed
        writer casts it. It codes two streams otherwise than the typed
        writers, as ``trico_tpu``'s ``compress_mesh`` does, whose bytes the
        port's are held to."""
        arr = np.asarray(arr)
        st = _KEYWORDS[name]
        if st == StreamType.vertex_float and arr.dtype == np.float64:
            st = StreamType.vertex_double
        elif st == StreamType.triangle_uint32 and (
                arr.dtype == np.uint64
                # no value of 4 bytes or fewer reaches 2**32
                or (arr.dtype.itemsize > 4 and arr.size and arr.max() >= 2**32)):
            st = StreamType.triangle_uint64
        if st in _FP_STREAMS:
            width, bits = _FP_STREAMS[st]
            a = np.ascontiguousarray(arr, np.float32 if bits == 32 else np.float64)
            # f32 chunks keep the v0 default (4,10) where optimize is off
            self._write_fp_planes(st, a, width, a.size // width, f32_chunk_exp=F32_EXP)
        else:
            _, dtype, mult = _LZ4_STREAMS[st]
            a = np.ascontiguousarray(arr, dtype)
            # uint8 attributes too take encode_int_best (a fill container
            # where constant), like every integer stream
            self._write_lz4_planes(st, a, a.size // mult)

    # ----------------------------------------------------------------------

    def nbytes(self) -> int:
        """Bytes written so far, the file header included."""
        return sum(len(p) for p in self._parts)

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


# The name a stream goes by: the keyword compress_mesh writes it from and the
# key it reads back under (stream_name); the stream type's own name where
# there is none.
_NAMES = {
    StreamType.vertex_float: "vertices",
    StreamType.vertex_double: "vertices",
    StreamType.triangle_uint32: "triangles",
    StreamType.triangle_uint64: "triangles",
    StreamType.vertex_normal_float: "vertex_normals",
    StreamType.vertex_normal_double: "vertex_normals",
    StreamType.triangle_normal_float: "triangle_normals",
    StreamType.triangle_normal_double: "triangle_normals",
    StreamType.vertex_color: "vertex_colors",
    StreamType.triangle_color: "triangle_colors",
    StreamType.uv_per_vertex_float: "uv_per_vertex",
    StreamType.uv_per_vertex_double: "uv_per_vertex",
    StreamType.uv_per_triangle_float: "uv_per_triangle",
    StreamType.uv_per_triangle_double: "uv_per_triangle",
}
# compress_mesh's keywords and the stream type each writes (write_stream)
_KEYWORDS = {
    "vertices": StreamType.vertex_float,
    "triangles": StreamType.triangle_uint32,
    "triangle_normals": StreamType.triangle_normal_float,
    "vertex_normals": StreamType.vertex_normal_float,
    "vertex_colors": StreamType.vertex_color,
    "uv_per_triangle": StreamType.uv_per_triangle_float,
    "uv_per_vertex": StreamType.uv_per_vertex_float,
    "attributes_uint8": StreamType.attribute_uint8,
    "attributes_uint16": StreamType.attribute_uint16,
    "attributes_uint32": StreamType.attribute_uint32,
    "attributes_uint64": StreamType.attribute_uint64,
}


def stream_name(st: StreamType) -> str:
    """The key a stream of type ``st`` reads back under: ``vertices``,
    ``triangles``, ``vertex_normals``, ... (``decompress_mesh``'s), or the
    stream type's own name."""
    return _NAMES.get(st, st.name)


def _fp_array(planes, count: int, bits: int) -> np.ndarray:
    """An FP stream's decoded planes → its (count, width) floats (or
    (count,) for one plane)."""
    for p in planes:
        if len(p) != count:
            raise ValueError("substream count mismatch")
    ftype = np.float32 if bits == 32 else np.float64
    if len(planes) == 1:
        return planes[0].view(ftype)
    with profiling.span("fp_interleave", nbytes=sum(p.nbytes for p in planes)):
        return transpose.soa_to_aos(planes).view(ftype).reshape(-1, len(planes))


def _int_array(words, n_elem: int, dtype, mult: int) -> np.ndarray:
    """An integer stream's words (one array) or byte planes (a list) → its
    ``n_elem`` values, (count, 3) for triangles."""
    if isinstance(words, np.ndarray):
        arr = words.astype(dtype, copy=False)
    elif len(words) == 1:
        arr = words[0].view(dtype)
    else:
        with profiling.span("int_join", nbytes=sum(p.nbytes for p in words)):
            arr = transpose.from_byte_planes(words, dtype)
    if len(arr) != n_elem:
        raise ValueError("integer substream count mismatch")
    return arr.reshape(-1, 3) if mult == 3 else arr


class ArchiveReader:
    """Reads a trico archive (reference- or self-produced).

    State machine matches the reference: the next stream's tag is always
    prefetched (trico.c:100-124); typed reads fail on tag mismatch; peeks do
    not advance (trico.c:860-941); skip works for every known type. The FP
    and BP substreams of a v1 archive decode on ``device`` (a device or a
    ``shards.Mesh``).

    Every stream is one walk (:meth:`read_stream`): its type, count and
    substream payloads, read in place; then one decode per container, by
    its kind (:meth:`decode_fp`, :meth:`decode_bp`, :meth:`decode_lz4`,
    which a subclass may route elsewhere; v0 substreams decode on the
    host); then one assembly of the decoded planes into the stream's array.
    Its spans: ``read.<name>`` around the stream (``name`` as
    :func:`stream_name`), ``read_framing`` around its substreams' reads,
    ``fp_decode``, ``bp_decode`` and ``lz4_decode`` around each v1
    container's decode, ``fp_interleave`` and ``int_join`` around the
    assembly's copies.
    """

    def __init__(self, data, use_native: bool = True, *, device="cuda"):
        self._device = chunked._resolve_device(device)
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
        if version not in (0, 1):
            raise ValueError(f"unsupported archive version {version}")
        self.version = version
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
            n_sub, bits = _FP_STREAMS[st]
            nbytes = count * n_sub * bits // 8
        else:
            n_sub, dtype, mult = _LZ4_STREAMS[st]
            nbytes = count * mult * np.dtype(dtype).itemsize
        with profiling.span(f"read.{stream_name(st)}", nbytes=nbytes):
            with profiling.span("read_framing"):
                subs = [self._read_sub() for _ in range(n_sub)]
            if st in _FP_STREAMS:
                arr = _fp_array(self._fp_planes(subs, bits), count, bits)
            else:
                arr = _int_array(self._int_words(subs, count * mult, dtype),
                                 count * mult, dtype, mult)
        self._advance_stream_type()
        return st, arr

    def _fp_planes(self, subs, bits: int) -> list[np.ndarray]:
        """The decoded words of each FP substream."""
        if self.version == 1:
            planes = []
            for s in subs:
                with profiling.span("fp_decode", nbytes=len(s)):
                    planes.append(self.decode_fp(s, bits))
            return planes
        subs = [np.frombuffer(s, dtype=np.uint8) for s in subs]
        if self._native is None or len(subs) == 1:
            return [self._fp_dec(s, bits) for s in subs]
        # all planes through one threaded native call (the reference
        # decodes substreams one at a time, trico.c:950-958)
        for s in subs:
            if len(s) < 5:
                raise ValueError("truncated FP substream")
        counts = np.array([int.from_bytes(s[1:5].tobytes(), "big") for s in subs],
                          np.int64)
        sizes = np.array([len(s) for s in subs], np.int64)
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        vals = self._native.fp_decode_blocks(np.concatenate(subs), offs, sizes,
                                             counts, bits)
        return np.split(vals, np.cumsum(counts)[:-1])

    def _int_words(self, subs, n_elem: int, dtype):
        """An integer stream's words (one array), or its byte planes (a
        list): a v1 BP container (substream 0; the others are empty
        placeholders that keep the framing fixed), else LZ4 byte planes."""
        if self.version == 1:
            hdr = chunked.parse_container_header(subs[0])
            if hdr is not None and hdr.kind == "bp":
                with profiling.span("bp_decode", nbytes=len(subs[0])):
                    return self.decode_bp(subs[0])
            return self.decode_lz4(subs)
        subs = [np.frombuffer(s, dtype=np.uint8) for s in subs]
        if self._native is not None and len(subs) > 1 and n_elem:
            # fused native: threaded per-plane LZ4 decode + byte unshuffle
            sizes = np.array([len(s) for s in subs], np.int64)
            offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
            return self._native.lz4_decompress_unshuffle(
                np.concatenate(subs), offs, sizes, n_elem, dtype)
        return [self._lz4_d(s, n_elem) for s in subs]

    # -- the v1 decoders, one per container kind ---------------------------

    def decode_fp(self, payload, bits: int) -> np.ndarray:
        """A v1 FP container → its u32 (``bits`` 32) or u64 words."""
        vals, got_bits = chunked.decode_chunked(payload, device=self._device)
        if got_bits != bits:
            raise ValueError("chunked container width mismatch")
        return vals

    def decode_bp(self, payload) -> np.ndarray:
        """A v1 BP container → its u32 or u64 words."""
        return chunked.decode_bp_chunked(payload, device=self._device)

    def decode_lz4(self, payloads) -> list[np.ndarray]:
        """An integer stream's v1 LZ4 (or fill) containers → its byte
        planes, on the host (the LZ4 token walk is sequential, lz4.c:1658):
        ``chunked.decode_lz4_chunked``, looked up at each call."""
        planes = []
        for p in payloads:
            with profiling.span("lz4_decode", nbytes=len(p)):
                planes.append(chunked.decode_lz4_chunked(p))
        return planes

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
