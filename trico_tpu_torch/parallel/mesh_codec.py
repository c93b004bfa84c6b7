"""Data-parallel mesh compression over several devices, in PyTorch.

Counterpart of ``trico_tpu/parallel/mesh_codec.py``; the names match. A
mesh (:class:`Mesh`, :func:`make_mesh`; :mod:`trico_tpu_torch.shards`) is
one axis of shards, ``"chunks"``, and the port's v1 codec runs on it as it
runs on one device, which is the mesh of one shard: there is one codec.
:func:`compress_mesh` is ``ArchiveWriter(chunk_len=..., layout="tpu")``
given the mesh as its device, and :func:`decompress_mesh` is its
``ArchiveReader``, with the FP and BP containers routed through
:func:`decode_plane_sharded` and :func:`decode_bp_sharded`.

* **encode**: the coordinate planes of a stream ride one batch of
  ``p * c`` chunks on each shard (``trico_tpu`` vmaps over planes), then the
  chunk sizes and the payload rows are gathered in chunk order
  (``chunked.encode_fp_planes``);
* **decode**: the same split of a container's full chunks, grouped by their
  hash_info byte; the decoded rows are gathered in chunk order
  (``chunked.decode_chunked``, ``chunked.decode_bp_chunked``).

Where ``torch.distributed`` is initialized, :func:`make_mesh` spans the
default process group and the gathers are ``dist.all_gather`` calls. The
archive bytes do not depend on the shard count or the process count.
``trico_tpu``'s TPU workarounds are not carried over: the vma check, the
cached jitted programs, the sharding constraints and, in one process, the
padding of the chunk count to a multiple of the shard count.

Every stream is one ``profiling.span`` of its own, around the finer spans
of its codec:

* ``write.<name>`` in :func:`compress_mesh`, ``name`` the keyword the
  stream was passed under (``vertices``, ``triangles``, ``vertex_normals``,
  ``vertex_colors``, ``uv_per_vertex``, ...), with its raw bytes; the tally
  counts ``archive.<name>``, the bytes the stream added to the archive (its
  header, count and framed substreams). These counts and the archive's
  8-byte file header add up to the archive's length;
* ``read.<name>`` in :func:`decompress_mesh` (the reader's walk), ``name``
  the key the stream is returned under, from its first substream read to
  its array, with the array's bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _u32, chunked, profiling, shards
from ..archive import ArchiveReader, ArchiveWriter, stream_name
from ..shards import Mesh, make_mesh


# ---------------------------------------------------------------------------
# trico_tpu's entry points of (p, C, L) f32 chunk planes at fixed exponents
# ---------------------------------------------------------------------------


def _exclusive_offsets(sizes: np.ndarray) -> np.ndarray:
    """Exclusive scan of (p, C) chunk sizes in (plane, chunk) order: each
    payload's offset in the deterministic archive layout."""
    flat = sizes.reshape(-1).astype(np.int64)
    return (np.cumsum(flat) - flat).reshape(sizes.shape)


def _sharded_encode(values: np.ndarray, e1: int, e2: int, mesh: Mesh):
    """(p, C, L) uint32 → (payloads (p, C, B), sizes (p, C), offsets (p, C))
    at fixed exponents in v2 chunks, whole on every rank."""
    payloads, sizes = chunked._encode_rows(values, e1, e2, "tpu", None, mesh)
    return (shards.gather_to_host(payloads, values.shape[1], mesh), sizes,
            _exclusive_offsets(sizes))


def encode_planes(planes: np.ndarray, chunk_len: int = 4096, e1: int = 4,
                  e2: int = 10, mesh: Mesh | None = None):
    """Encode (n_planes, N) uint32 planes data-parallel over the mesh.

    Returns (payloads (p, C, B) np.uint8, sizes (p, C), offsets (p, C), tails)
    — ``tails`` are the per-plane remainders for the host codec."""
    if mesh is None:
        mesh = make_mesh()
    planes = np.asarray(planes, np.uint32)
    p, N = planes.shape
    C = N // chunk_len
    vals = planes[:, : C * chunk_len].reshape(p, C, chunk_len)
    tails = [planes[i, C * chunk_len :] for i in range(p)]
    return (*_sharded_encode(vals, e1, e2, mesh), tails)


def roundtrip_step(values, chunk_len: int, mesh: Mesh, e1: int = 4,
                   e2: int = 10):
    """The whole pipeline at once: sharded encode, offsets (the collective),
    sharded decode, and the bit-exactness check against the input.

    ``values``: (n_planes, C, L) uint32 words (a NumPy array, or an int32
    tensor of their bits). Returns the tensors (exact, total_bytes,
    offsets)."""
    if torch.is_tensor(values):
        values = _u32.to_numpy(values)
    values = np.asarray(values, np.uint32)
    payloads, sizes, offsets = _sharded_encode(values, e1, e2, mesh)
    decoded = chunked._decode_rows(payloads, chunk_len, e1, e2, 32, "tpu", mesh)
    return (torch.tensor(bool(np.array_equal(decoded, values))),
            torch.tensor(int(sizes.sum())), torch.from_numpy(offsets))


# ---------------------------------------------------------------------------
# mesh → archive bytes, and back
# ---------------------------------------------------------------------------


def compress_mesh(vertices, triangles=None, *, triangle_normals=None,
                  attributes_uint16=None, vertex_normals=None,
                  vertex_colors=None, uv_per_triangle=None,
                  uv_per_vertex=None, attributes_uint8=None,
                  attributes_uint32=None, attributes_uint64=None,
                  chunk_len: int = 4096, mesh: Mesh | None = None,
                  optimize: bool | str = True, profile=None) -> bytes:
    """Encode a whole mesh into a v1 ``.trc`` archive over ``mesh`` (one
    shard per card by default: ``make_mesh()``).

    ``ArchiveWriter(chunk_len=..., layout="tpu", optimize=...)`` on the
    mesh, each stream written by ``ArchiveWriter.write_stream``: float
    vec3/vec2 attributes (vertices, float32 or float64; vertex and triangle
    normals; uvs) are split into coordinate planes and each plane into
    ``chunk_len``-value chunks (rounded down to a multiple of 8) split over
    the mesh. The bytes do not depend on the shard or the process count;
    they are ``trico_tpu``'s ``compress_mesh``'s, whose two differences from
    its writer ``write_stream`` keeps (at ``optimize=False`` f32 chunks keep
    the v0 default (4,10); uint8 attributes take ``encode_int_best``).
    Integer streams (triangles, vertex colors, integer attributes) take
    ``chunked.encode_int_best`` on the rank's first shard. Streams come in
    the reference encoder's order (trico_encoder/main.c:253-303).

    ``optimize``: True (the default) picks each chunk's exponents from the
    full candidate sets, ``"fast"`` from the small-table sets, False keeps
    fixed exponents. ``profile``: a recorder, any object with a
    ``stage(name, nbytes=0, sync=None)`` context manager (a
    ``profiling.StageTimer``, say); every ``profiling.span`` of the call
    goes to it. The tally counts the call under ``compress_mesh`` with the
    raw input bytes, and each stream under ``write.<keyword>`` (its raw
    bytes) and ``archive.<keyword>`` (the bytes it added to the archive)."""
    if mesh is None:
        mesh = make_mesh()
    streams = {"vertices": vertices, "triangles": triangles,
               "triangle_normals": triangle_normals,
               "attributes_uint16": attributes_uint16,
               "vertex_normals": vertex_normals, "vertex_colors": vertex_colors,
               # the reference's count quirk: uv-per-triangle floats carry 3
               # uv pairs per triangle and the count is of pairs
               # (trico.c:577-580)
               "uv_per_triangle": uv_per_triangle, "uv_per_vertex": uv_per_vertex,
               "attributes_uint8": attributes_uint8,
               "attributes_uint32": attributes_uint32,
               "attributes_uint64": attributes_uint64}
    streams = {name: np.asarray(a) for name, a in streams.items() if a is not None}
    profiling.count("compress_mesh", nbytes=sum(a.nbytes for a in streams.values()))
    w = ArchiveWriter(chunk_len=(chunk_len // 8) * 8 or 8, layout="tpu",
                      optimize=optimize, device=mesh)
    with profiling.recording(profile):
        for name, arr in streams.items():
            before = w.nbytes()
            with profiling.span(f"write.{name}", nbytes=arr.nbytes):
                w.write_stream(name, arr)
            profiling.count(f"archive.{name}", nbytes=w.nbytes() - before)
        return w.tobytes()


class _MeshReader(ArchiveReader):
    """``ArchiveReader`` on a mesh whose FP containers of the tpu layout go
    through :func:`decode_plane_sharded` and BP containers through
    :func:`decode_bp_sharded` (each looked up here at its call), counting
    each route in ``route_stats``."""

    def __init__(self, blob, mesh: Mesh, route_stats: dict):
        super().__init__(blob, device=mesh)
        self.mesh, self.route_stats = mesh, route_stats

    def decode_fp(self, payload, bits: int) -> np.ndarray:
        # route on the parsed container header, not on raw bytes
        hdr = chunked.parse_container_header(payload)
        if (hdr is not None and hdr.kind == "fp"
                and hdr.layout == "tpu" and hdr.bits == bits):
            self.route_stats["sharded_fp"] += 1
            return decode_plane_sharded(payload, self.mesh)
        self.route_stats["host_other"] += 1
        return chunked.decode_chunked(payload, device=self.mesh)[0]

    def decode_bp(self, payload) -> np.ndarray:
        self.route_stats["sharded_bp"] += 1
        return decode_bp_sharded(payload, self.mesh)

    def decode_lz4(self, payloads) -> list[np.ndarray]:
        self.route_stats["host_lz4"] += 1
        return super().decode_lz4(payloads)


def decompress_mesh(blob, mesh: Mesh | None = None,
                    route_stats: dict | None = None, profile=None) -> dict:
    """Decode a v1 archive of :func:`compress_mesh` over ``mesh``.

    The walk of ``ArchiveReader``, which routes every FP container of the
    tpu layout (f32 and f64) through :func:`decode_plane_sharded` and BP
    containers through :func:`decode_bp_sharded`, LZ4 containers through
    the host decoder (the LZ4 token walk is sequential, lz4.c:1658), and
    other FP containers through ``chunked.decode_chunked`` on the mesh.
    Returns a dict keyed by stream name (``vertices``, ``triangles``,
    ``vertex_normals``, ``vertex_colors``, ``uv_per_vertex``, ...); each
    stream's decode is the span ``read.<name>``.

    ``route_stats`` (optional dict) is filled with the counts of each
    route: ``sharded_fp`` and ``host_other`` (FP containers),
    ``sharded_bp`` and ``host_lz4`` (integer streams). ``profile``: a
    recorder, as :func:`compress_mesh` takes: an object with a
    ``stage(name, nbytes=0, sync=None)`` context manager, to which every
    ``profiling.span`` of the call goes."""
    if route_stats is None:
        route_stats = {}
    for k in ("sharded_fp", "sharded_bp", "host_lz4", "host_other"):
        route_stats.setdefault(k, 0)
    if mesh is None:
        mesh = make_mesh()
    with profiling.recording(profile):
        with profiling.span("read_framing"):
            r = _MeshReader(blob, mesh, route_stats)
        return {stream_name(st): arr for st, arr in r.streams()}


def decode_plane_sharded(container, mesh: Mesh | None = None) -> np.ndarray:
    """Decode one chunked FP container (f32 or f64) over the mesh → the
    flat uint32 (f32) or uint64 (f64) words: ``chunked.decode_chunked``."""
    return chunked.decode_chunked(container, device=mesh or make_mesh())[0]


def decode_vertices_sharded(container, mesh: Mesh | None = None) -> np.ndarray:
    """The f32-era name of :func:`decode_plane_sharded`."""
    return decode_plane_sharded(container, mesh)


def decode_bp_sharded(container, mesh: Mesh | None = None) -> np.ndarray:
    """Decode one BP32 or BP64 chunked container over the mesh → the flat
    uint32 or uint64 words: ``chunked.decode_bp_chunked``."""
    return chunked.decode_bp_chunked(container, device=mesh or make_mesh())
