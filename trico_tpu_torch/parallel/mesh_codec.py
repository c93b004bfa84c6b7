"""Data-parallel mesh compression over several devices, in PyTorch.

Counterpart of ``trico_tpu/parallel/mesh_codec.py``; the names match. The
chunks of every float stream are split over the shards of a :class:`Mesh`
(its one axis, ``"chunks"``), and each shard encodes or decodes its own
contiguous range of chunks as one batch, with no communication:

* **encode**: the coordinate planes of a stream ride one batch of
  ``p * c`` chunks on each shard (``trico_tpu`` vmaps over planes). Two
  collectives follow: the chunk sizes are all-gathered and exclusive-scanned
  in (plane, chunk) order, which fixes every payload's offset in the archive,
  and the payload rows are gathered in chunk order;
* **decode**: the same split of a container's full chunks, grouped by their
  hash_info byte; the decoded rows are gathered in chunk order.

In one process a collective is the host concatenation of each shard's
result, and a shard's results come to the host before the next shard
starts, so shards that share a card bound its peak memory. Where
``torch.distributed`` is initialized, the mesh spans the default process
group and the collectives are ``dist.all_gather`` calls (gloo with CPU
tensors, NCCL with CUDA tensors), each rank's rows padded to one shape.
Every rank holds the whole host input and ends with the whole result.

The archive bytes do not depend on the shard count or the process count:
they are the bytes of ``ArchiveWriter(chunk_len=..., layout="tpu")``.
``trico_tpu``'s ``_sharded_encode`` is :func:`_shardmap_encode_f32` at fixed
exponents here, and the TPU workarounds are not carried over: the vma
check, the cached jitted programs, the sharding constraints and, in one
process, the padding of the chunk count to a multiple of the shard count.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from .. import _u32, _u64, chunked
from ..archive import (_FP_STREAMS, _LZ4_STREAMS, F32_EXP, F64_EXP,
                       ArchiveReader, ArchiveWriter, StreamType)
from ..codec import bp_torch, fp64_torch, fp_torch, transpose


class Mesh:
    """The devices a call spreads its chunks over: one axis of ``size``
    shards. ``shards`` are this process's shards in order, one
    ``torch.device`` each (a device may repeat); ``group`` is the process
    group the mesh spans: None in one process, the default group where
    ``torch.distributed`` is initialized. Global shard ``rank * len(shards)
    + j`` is rank ``rank``'s local shard ``j``."""

    def __init__(self, shards, group=None):
        self.shards = tuple(torch.device(s) for s in shards)
        if not self.shards:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world_size = dist.get_world_size(group) if group is not None else 1
        self.size = self.world_size * len(self.shards)

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, rank={self.rank}, "
                f"shards={[str(s) for s in self.shards]})")


def make_mesh(n_devices: int | None = None, *, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards in all, on ``device``: ``"cuda"``
    (the default; raises where there is no card) or ``"cpu"``.

    In one process, ``make_mesh()`` has one shard per visible card, and
    ``make_mesh(n)`` n shards; with ``device="cuda"`` global shard ``g`` is
    on card ``g % device_count``, so shards repeat a card where there are
    more shards than cards (``device="cuda:k"`` puts every shard on card
    k). ``make_mesh(n, device="cpu")`` lists the CPU n times. Where
    ``torch.distributed`` is initialized, ``n_devices`` (one per rank by
    default) must be a multiple of the world size, and each rank holds
    ``n_devices / world_size`` shards."""
    dev = chunked._resolve_device(device)
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    if n_devices is None:
        n_devices = (world if group is not None or dev.type == "cpu"
                     else torch.cuda.device_count())
    if n_devices < 1 or n_devices % world:
        raise ValueError(f"{n_devices} shards cannot be split evenly over "
                         f"{world} processes")
    if group is not None and dev.type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("an NCCL process group needs a mesh on CUDA devices")
    n_local = n_devices // world
    first = (dist.get_rank() if group is not None else 0) * n_local
    if dev.type == "cuda" and dev.index is None:
        shards = [torch.device("cuda", g % torch.cuda.device_count())
                  for g in range(first, first + n_local)]
    else:
        shards = [dev] * n_local
    return Mesh(shards, group)


# ---------------------------------------------------------------------------
# the shards' chunk ranges and the two collectives
# ---------------------------------------------------------------------------


def _shard_bounds(C: int, mesh: Mesh) -> list[int]:
    """Chunk boundaries of the mesh's global shards: shard g takes chunks
    ``bounds[g]:bounds[g + 1]`` (an even split; counts differ by one at
    most)."""
    return [g * C // mesh.size for g in range(mesh.size + 1)]


def _rank_counts(C: int, mesh: Mesh) -> list[int]:
    """Chunks each rank's shards take together, in rank order."""
    b = _shard_bounds(C, mesh)
    n = len(mesh.shards)
    return [b[(r + 1) * n] - b[r * n] for r in range(mesh.world_size)]


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """u32 words → int32 bits, u64 words → int64 bits, bytes as they are."""
    if a.dtype == np.uint32:
        return _u32.from_numpy(a)
    if a.dtype == np.uint64:
        return _u64.from_numpy(a)
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8))


def _to_host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().view(dtype)


def _local_chunks(fn, rows: np.ndarray, mesh: Mesh, specs) -> list[np.ndarray]:
    """Apply ``fn`` to this process's chunks of host ``rows`` (p, C, ...):
    each local shard takes its range of the chunk axis as one batch of
    ``p * c`` chunks on its device, and ``fn`` returns one tensor per
    ``specs`` entry ``(trailing shape, NumPy dtype)``, each (p * c, ...).
    Returns the host arrays (p, c_rank, ...) of this rank's chunks, in
    order. A shard's results reach the host before the next shard starts."""
    p, C = rows.shape[:2]
    bounds = _shard_bounds(C, mesh)
    first = mesh.rank * len(mesh.shards)
    parts = [[] for _ in specs]
    for j, dev in enumerate(mesh.shards):
        lo, hi = bounds[first + j], bounds[first + j + 1]
        if hi == lo:
            continue
        x = _to_tensor(np.ascontiguousarray(rows[:, lo:hi]).reshape(
            p * (hi - lo), *rows.shape[2:])).to(dev)
        outs = fn(x)
        for part, out, (shape, dtype) in zip(parts, outs, specs):
            part.append(_to_host(out, dtype).reshape(p, hi - lo, *shape))
        del x, outs
    return [np.concatenate(part, axis=1) if part
            else np.zeros((p, 0, *shape), dtype)
            for part, (shape, dtype) in zip(parts, specs)]


def _gather_to_host(x: np.ndarray, C: int, mesh: Mesh) -> np.ndarray:
    """This rank's chunk rows (p, c_rank, ...) → every rank's, (p, C, ...) in
    chunk order, on every rank.

    In one process the rows are already all of them. Across processes it
    is one ``dist.all_gather`` of the rows as bytes, each rank's padded to
    the largest rank's count: CPU tensors for gloo, tensors on the rank's
    first shard for NCCL."""
    if mesh.group is None:
        return x
    counts = _rank_counts(C, mesh)
    cmax = max(counts)
    if cmax == 0:
        return x
    padded = np.zeros((x.shape[0], cmax, *x.shape[2:]), x.dtype)
    padded[:, : x.shape[1]] = x
    t = torch.from_numpy(padded.reshape(-1).view(np.uint8))
    if dist.get_backend(mesh.group) == "nccl":
        t = t.to(mesh.shards[0])
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return np.concatenate(
        [_to_host(q, x.dtype).reshape(padded.shape)[:, :c]
         for q, c in zip(parts, counts)], axis=1)


def _exclusive_offsets(sizes: np.ndarray) -> np.ndarray:
    """Exclusive scan of (p, C) chunk sizes in (plane, chunk) order: each
    payload's offset in the deterministic archive layout."""
    flat = sizes.reshape(-1).astype(np.int64)
    return (np.cumsum(flat) - flat).reshape(sizes.shape)


# ---------------------------------------------------------------------------
# sharded encode and decode of (p, C, L) chunk planes
# ---------------------------------------------------------------------------


def _shardmap_encode(encode, values: np.ndarray, B: int, mesh: Mesh):
    """Run ``encode`` ((c, L) words on a device → ((c, B) uint8 payloads,
    (c,) int32 sizes)) on each shard's chunks of (p, C, L) ``values``, then
    all-gather the sizes and exclusive-scan them. Returns this rank's
    payload rows (p, c_rank, B) and every chunk's size and offset (p, C),
    which every rank then knows."""
    payloads, sizes = _local_chunks(encode, values, mesh,
                                    [((B,), np.uint8), ((), np.uint32)])
    sizes = _gather_to_host(sizes, values.shape[1], mesh).astype(np.int64)
    return payloads, sizes, _exclusive_offsets(sizes)


def _shardmap_encode_f32(values: np.ndarray, e1, e2, mesh: Mesh, cands=None):
    """Sharded encode of (p, C, L) uint32 chunk planes into v2 payloads at
    fixed exponents, or per chunk adaptive over ``cands`` (default
    ``F32_TPU_CANDIDATES``) when ``e1`` is None; see :func:`_shardmap_encode`."""
    if e1 is None:
        cc = tuple(cands or fp_torch.F32_TPU_CANDIDATES)
        enc = lambda x: fp_torch.encode_f32_chunks_v2_adaptive(x, cc)  # noqa: E731
    else:
        enc = lambda x: fp_torch.encode_f32_chunks_v2(x, e1, e2)  # noqa: E731
    return _shardmap_encode(enc, values,
                            fp_torch.f32_max_chunk_bytes(values.shape[2]), mesh)


def _shardmap_encode_f64(values: np.ndarray, e1, e2, mesh: Mesh, cands=None):
    """The f64 form of :func:`_shardmap_encode_f32`: (p, C, L) uint64 chunk
    planes (whole u64 words; trico_tpu splits them into (hi, lo) u32
    planes), adaptive over ``F64_TPU_CANDIDATES`` by default."""
    if e1 is None:
        cc = tuple(cands or fp64_torch.F64_TPU_CANDIDATES)
        enc = lambda x: fp64_torch.encode_f64_chunks_v2_adaptive(x, cc)  # noqa: E731
    else:
        enc = lambda x: fp64_torch.encode_f64_chunks_v2(x, e1, e2)  # noqa: E731
    return _shardmap_encode(enc, values,
                            fp64_torch.f64_max_chunk_bytes(values.shape[2]), mesh)


def _sharded_decode(payloads: np.ndarray, L: int, e1: int, e2: int,
                    mesh: Mesh, bits: int = 32) -> np.ndarray:
    """(p, C, B) v2 payloads at one exponent pair → (p, C, L) uint32 (or,
    with ``bits=64``, uint64) words on every rank: each shard parses and
    replays its chunks, then the rows are gathered in chunk order."""
    if bits == 32:
        dec, dtype = fp_torch.decode_f32_chunks_v2, np.uint32
    else:
        dec, dtype = fp64_torch.decode_f64_chunks_v2, np.uint64
    (vals,) = _local_chunks(lambda x: (dec(x, L, e1, e2),), payloads, mesh,
                            [((L,), dtype)])
    return _gather_to_host(vals, payloads.shape[1], mesh)


def _split_planes(planes: np.ndarray, chunk_len: int):
    """(p, N) planes → ((p, C, L) full chunks, C)."""
    p, N = planes.shape
    C = N // chunk_len
    return planes[:, : C * chunk_len].reshape(p, C, chunk_len), C


def _sharded_encode(values: np.ndarray, e1: int, e2: int, mesh: Mesh):
    """(p, C, L) uint32 → (payloads (p, C, B), sizes (p, C), offsets (p, C))
    at fixed exponents, whole on every rank."""
    payloads, sizes, offsets = _shardmap_encode_f32(values, e1, e2, mesh)
    return _gather_to_host(payloads, values.shape[1], mesh), sizes, offsets


def encode_planes(planes: np.ndarray, chunk_len: int = 4096, e1: int = 4,
                  e2: int = 10, mesh: Mesh | None = None):
    """Encode (n_planes, N) uint32 planes data-parallel over the mesh.

    Returns (payloads (p, C, B) np.uint8, sizes (p, C), offsets (p, C), tails)
    — ``tails`` are the per-plane remainders for the host codec."""
    if mesh is None:
        mesh = make_mesh()
    planes = np.asarray(planes, np.uint32)
    vals, C = _split_planes(planes, chunk_len)
    tails = [planes[i, C * chunk_len :] for i in range(planes.shape[0])]
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
    decoded = _sharded_decode(payloads, chunk_len, e1, e2, mesh)
    return (torch.tensor(bool(np.array_equal(decoded, values))),
            torch.tensor(int(sizes.sum())), torch.from_numpy(offsets))


# ---------------------------------------------------------------------------
# mesh → archive bytes (reference archive assembly: trico/trico.c:126-213,
# one [size][payload] substream per plane)
# ---------------------------------------------------------------------------


class _NullTimer:
    """No-op StageTimer stand-in, so the path has no conditionals."""

    @staticmethod
    @contextlib.contextmanager
    def stage(name, nbytes=0, sync=None):
        yield


def _plane_containers(planes: np.ndarray, chunk_len: int, mesh: Mesh,
                      optimize, prof, width_bits: int) -> list[bytes]:
    """Sharded-encode (p, N) planes → one chunked v1 FP container (tpu
    layout) per plane: full chunks on the mesh, the partial last chunk
    host-coded. Without ``optimize`` the exponents are the archive's v0
    defaults, ``F32_EXP`` (4,10) or ``F64_EXP`` (20,20), as in
    trico_tpu."""
    if width_bits == 32:
        (e1, e2), encode = F32_EXP, _shardmap_encode_f32
        cands = (fp_torch.F32_TPU_CANDIDATES_FAST if optimize == "fast"
                 else fp_torch.F32_TPU_CANDIDATES)
        flags = chunked._FLAG_TPU_LAYOUT
    else:
        (e1, e2), encode = F64_EXP, _shardmap_encode_f64
        cands = (fp64_torch.F64_TPU_CANDIDATES_FAST if optimize == "fast"
                 else fp64_torch.F64_TPU_CANDIDATES)
        flags = chunked._FLAG_TPU_LAYOUT | chunked._FLAG_F64
    prof = prof or _NullTimer()
    p, N = planes.shape
    vals, C = _split_planes(planes, chunk_len)
    if C:
        with prof.stage("fp_device_encode", nbytes=vals.nbytes):
            payloads, sizes, _ = encode(vals, None if optimize else e1,
                                        None if optimize else e2, mesh,
                                        cands=cands if optimize else None)
        with prof.stage("fp_gather", nbytes=vals.nbytes):
            payloads = _gather_to_host(payloads, C, mesh)
    out = []
    for i in range(p):
        with prof.stage("fp_assembly",
                        nbytes=int(sizes[i].sum()) if C else 0):
            chunk_sizes, body = (chunked._rows_body(payloads[i], sizes[i])
                                 if C else ([], []))
        tail = planes[i, C * chunk_len :]
        if len(tail):
            with prof.stage("fp_tails", nbytes=tail.nbytes):
                tp = (chunked._host_fp_encode_best(tail, cands) if optimize
                      else chunked._host_fp_encode(tail, e1, e2))
            chunk_sizes.append(len(tp))
            body.append(tp)
        out.append(chunked._frame(flags, chunk_len, N, chunk_sizes, body))
    return out


def _f32_plane_containers(planes: np.ndarray, chunk_len: int, mesh: Mesh,
                          optimize: bool | str, prof=None) -> list[bytes]:
    """(p, N) uint32 planes → one v1 f32 container per plane, the bytes of
    ``chunked.encode_chunked(plane, layout="tpu")`` for any shard count.
    ``prof`` (a ``profiling.StageTimer``) splits the time into the shards'
    encode, the gather, container assembly and tail coding."""
    return _plane_containers(planes, chunk_len, mesh, optimize, prof, 32)


def _f64_plane_containers(planes: np.ndarray, chunk_len: int, mesh: Mesh,
                          optimize: bool | str = True, prof=None) -> list[bytes]:
    """(p, N) uint64 planes → one v1 f64 container per plane (chunk_len
    rounded down to even); adaptive chunks pick among
    ``F64_TPU_CANDIDATES``, and (20,20) winners decode on the host."""
    chunk_len = (chunk_len // 2) * 2 or 2
    return _plane_containers(planes, chunk_len, mesh, optimize, prof, 64)


class _MeshWriter(ArchiveWriter):
    """``ArchiveWriter(chunk_len=..., layout="tpu")`` whose float planes are
    coded over a mesh (:func:`_plane_containers`); the framing, the stream
    headers and the integer streams stay the writer's."""

    def __init__(self, chunk_len: int, mesh: Mesh, optimize, prof):
        super().__init__(chunk_len=chunk_len, layout="tpu", device=mesh.shards[0])
        self._mesh, self._mesh_optimize, self._prof = mesh, optimize, prof

    def _fp_best_planes(self, planes, default_exp) -> list[bytes]:
        build = (_f32_plane_containers if planes.dtype == np.uint32
                 else _f64_plane_containers)
        return build(planes, self._chunk_len, self._mesh, self._mesh_optimize,
                     self._prof)

    def _write_lz4_planes(self, st: StreamType, arr: np.ndarray, count: int):
        with self._prof.stage("int_encode", nbytes=arr.nbytes):
            super()._write_lz4_planes(st, arr, count)

    def write_attributes_uint8(self, a):
        # coded like every integer stream (encode_int_best), as in trico_tpu
        a = np.ascontiguousarray(a, np.uint8)
        self._write_lz4_planes(StreamType.attribute_uint8, a, a.size)


def compress_mesh(vertices, triangles=None, *, triangle_normals=None,
                  attributes_uint16=None, vertex_normals=None,
                  vertex_colors=None, uv_per_triangle=None,
                  uv_per_vertex=None, attributes_uint8=None,
                  attributes_uint32=None, attributes_uint64=None,
                  chunk_len: int = 4096, mesh: Mesh | None = None,
                  optimize: bool | str = True, profile=None) -> bytes:
    """Encode a whole mesh into a v1 ``.trc`` archive over ``mesh`` (one
    shard per card by default: ``make_mesh()``).

    Float vec3/vec2 attributes (vertices, float32 or float64; vertex and
    triangle normals; uvs) are split into coordinate planes and each plane
    into ``chunk_len``-value chunks (rounded down to a multiple of 8) split
    over the mesh; the size scan fixes every payload's offset and the host
    concatenates the gathered bytes in chunk order. The bytes equal
    ``ArchiveWriter(chunk_len=..., layout="tpu", optimize=...)``'s whatever
    the shard or process count (at ``optimize=False`` the f32 chunks keep
    the v0 default (4,10), as in trico_tpu). Integer streams (triangles,
    vertex colors, integer attributes) take ``chunked.encode_int_best`` on
    the rank's first shard. Streams come in the reference encoder's order
    (trico_encoder/main.c:253-303).

    ``optimize``: True (the default) picks each chunk's exponents from the
    full candidate sets, ``"fast"`` from the small-table sets, False keeps
    fixed exponents. ``profile``: a ``profiling.StageTimer``."""
    if mesh is None:
        mesh = make_mesh()
    w = _MeshWriter((chunk_len // 8) * 8 or 8, mesh, optimize,
                    profile or _NullTimer())
    verts = np.asarray(vertices)
    if verts.dtype == np.float64:
        w.write_vertices_double(verts)
    else:
        w.write_vertices(verts)
    if triangles is not None:
        tris = np.asarray(triangles)
        if tris.dtype == np.uint64 or (tris.size and tris.max() >= 2**32):
            w.write_triangles_long(tris)
        else:
            w.write_triangles(tris)
    if triangle_normals is not None:
        w.write_triangle_normals(triangle_normals)
    if attributes_uint16 is not None:
        w.write_attributes_uint16(attributes_uint16)
    if vertex_normals is not None:
        w.write_vertex_normals(vertex_normals)
    if vertex_colors is not None:
        w.write_vertex_colors(vertex_colors)
    if uv_per_triangle is not None:
        # the reference's count quirk: uv-per-triangle floats carry 3 uv
        # pairs per triangle and the count is of pairs (trico.c:577-580)
        w.write_uv_per_triangle(uv_per_triangle)
    if uv_per_vertex is not None:
        w.write_uv_per_vertex(uv_per_vertex)
    if attributes_uint8 is not None:
        w.write_attributes_uint8(attributes_uint8)
    if attributes_uint32 is not None:
        w.write_attributes_uint32(attributes_uint32)
    if attributes_uint64 is not None:
        w.write_attributes_uint64(attributes_uint64)
    return w.tobytes()


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


def decompress_mesh(blob, mesh: Mesh | None = None,
                    route_stats: dict | None = None) -> dict:
    """Decode a v1 archive of :func:`compress_mesh` over ``mesh``.

    Walks the framing on the host (``ArchiveReader``), routes every FP
    container of the tpu layout (f32 and f64) through
    :func:`decode_plane_sharded` and BP containers through
    :func:`decode_bp_sharded`, LZ4 containers through the host decoder (the
    LZ4 token walk is sequential, lz4.c:1658), and anything else through
    the reader on the rank's first shard. Returns a dict keyed by stream
    name (``vertices``, ``triangles``, ``vertex_normals``,
    ``vertex_colors``, ``uv_per_vertex``, ...).

    ``route_stats`` (optional dict) is filled with substream counts per
    route: ``sharded_fp``, ``sharded_bp``, ``host_lz4``, ``host_other``."""
    if route_stats is None:
        route_stats = {}
    for k in ("sharded_fp", "sharded_bp", "host_lz4", "host_other"):
        route_stats.setdefault(k, 0)
    if mesh is None:
        mesh = make_mesh()
    dev = mesh.shards[0]
    r = ArchiveReader(blob, device=dev)
    out: dict = {}
    while r.next_stream_type != StreamType.empty:
        st = r.next_stream_type
        if st in _FP_STREAMS:
            width, bits = _FP_STREAMS[st]
            count = r._read_u32()
            planes = []
            for _ in range(width):
                payload = bytes(r._read_sub())
                # route on the parsed container header, not on raw bytes
                hdr = chunked.parse_container_header(payload)
                if (hdr is not None and hdr.kind == "fp"
                        and hdr.layout == "tpu" and hdr.bits == bits):
                    planes.append(decode_plane_sharded(payload, mesh))
                    route_stats["sharded_fp"] += 1
                else:
                    planes.append(chunked.decode_chunked(payload, device=dev)[0])
                    route_stats["host_other"] += 1
            for p in planes:
                if len(p) != count:
                    raise ValueError("substream count mismatch")
            ftype = np.float32 if bits == 32 else np.float64
            arr = (transpose.soa_to_aos(planes).view(ftype).reshape(-1, width)
                   if width > 1 else planes[0].view(ftype))
        elif st in _LZ4_STREAMS:
            nplanes, dtype, mult = _LZ4_STREAMS[st]
            count = r._read_u32()
            subs = [bytes(r._read_sub()) for _ in range(nplanes)]
            hdr = chunked.parse_container_header(subs[0]) if subs else None
            if hdr is not None and hdr.kind == "bp":
                # a BP stream: substream 0 holds the values, the others are
                # empty placeholders
                arr = decode_bp_sharded(subs[0], mesh).astype(dtype, copy=False)
                route_stats["sharded_bp"] += 1
            else:
                planes = [chunked.decode_lz4_chunked(s) for s in subs]
                arr = (planes[0].view(dtype) if nplanes == 1
                       else transpose.from_byte_planes(planes, dtype))
                route_stats["host_lz4"] += 1
            if len(arr) != count * mult:
                raise ValueError("integer substream count mismatch")
            if mult == 3:
                arr = arr.reshape(-1, 3)
        else:
            st, arr = r.read_stream()
            out[_NAMES.get(st, st.name)] = arr
            route_stats["host_other"] += 1
            continue
        r._advance_stream_type()
        out[_NAMES.get(st, st.name)] = arr
    return out


def decode_plane_sharded(container: bytes, mesh: Mesh | None = None) -> np.ndarray:
    """Decode one chunked FP container of the tpu layout (f32 or f64) over
    the mesh → the flat uint32 (f32) or uint64 (f64) words.

    The host parses and validates the framing before anything is launched;
    the full chunks are grouped by their hash_info byte and each group is
    split over the shards. Groups whose tables pass
    ``chunked.DEVICE_TABLE_WORDS`` (f64 (20,20) winners) and the partial
    last chunk decode on the host."""
    if mesh is None:
        mesh = make_mesh()
    data = bytes(container)
    hdr, sizes, off = chunked.parse_validated_framing(data)
    if hdr.kind != "fp" or hdr.layout != "tpu":
        raise ValueError("expected a v1 FP tpu-layout chunked container")
    bits, chunk_len, total, n_chunks = (hdr.bits, hdr.chunk_len, hdr.total,
                                        hdr.n_chunks)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    dt = np.uint32 if bits == 32 else np.uint64
    if n_chunks == 0 or total == 0:
        return np.zeros(total, dt)  # the container of an empty stream
    n_full = n_chunks - 1 if total % chunk_len else n_chunks
    out = np.empty(total, dt)
    buf = np.frombuffer(data, np.uint8)
    if n_full:
        B = (fp_torch.f32_max_chunk_bytes(chunk_len) if bits == 32
             else fp64_torch.f64_max_chunk_bytes(chunk_len))
        full_sizes = np.asarray(sizes[:n_full], np.int64)
        mat = chunked.bytes_to_rows(buf[offsets[0] : offsets[n_full]],
                                    full_sizes, B)
        rows = out[: n_full * chunk_len].reshape(n_full, chunk_len)
        for info in np.unique(mat[:, 0]):
            idx = np.nonzero(mat[:, 0] == info)[0]
            e1, e2 = fp_torch.exponents(int(info))
            if (1 << e1) + (1 << e2) > chunked.DEVICE_TABLE_WORDS:
                rows[idx] = chunked.host_decode_full_chunks(
                    mat, full_sizes, idx, chunk_len, bits, "tpu")
            else:
                rows[idx] = _sharded_decode(mat[idx][None], chunk_len, e1, e2,
                                            mesh, bits)[0]
    for c in range(n_full, n_chunks):
        # the partial last chunk is host-coded in the reference layout
        vals = chunked._host_fp_decode(buf[offsets[c] : offsets[c + 1]], bits)
        out[c * chunk_len : c * chunk_len + len(vals)] = vals
    return out


def decode_vertices_sharded(container: bytes, mesh: Mesh | None = None) -> np.ndarray:
    """The f32-era name of :func:`decode_plane_sharded`."""
    return decode_plane_sharded(container, mesh)


def decode_bp_sharded(container: bytes, mesh: Mesh | None = None) -> np.ndarray:
    """Decode one BP32 or BP64 chunked container over the mesh → the flat
    uint32 or uint64 words.

    The host parses the framing and validates every full chunk's width
    header before anything is launched; each shard decodes its range of
    full chunks, the host the partial last one. Containers the device
    decode cannot take (a chunk length off the 32-value grid, u64 chunks
    past 8192) decode on the host."""
    if mesh is None:
        mesh = make_mesh()
    data = bytes(container)
    hdr, sizes, off = chunked.parse_validated_framing(data)
    if hdr.kind != "bp":
        raise ValueError("expected a BP32 chunked container")
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    eb = hdr.bits // 8
    buf = np.frombuffer(data, np.uint8)
    if chunk_len % 32 or (eb == 8 and chunk_len > bp_torch.BP64_MAX_CHUNK):
        return chunked._host_bp_decode_all(buf, hdr, sizes, off)
    dt = np.uint32 if eb == 4 else np.uint64
    if n_chunks == 0 or total == 0:
        return np.zeros(total, dt)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    n_full = n_chunks - 1 if total % chunk_len else n_chunks
    out = np.empty(total, dt)
    if n_full:
        if eb == 4:
            B, dec = bp_torch.bp32_max_chunk_bytes(chunk_len), bp_torch.decode_bp32_chunks
        else:
            B, dec = bp_torch.bp64_max_chunk_bytes(chunk_len), bp_torch.decode_bp64_chunks
        full_sizes = np.asarray(sizes[:n_full], np.int64)
        mat = chunked.bytes_to_rows(buf[offsets[0] : offsets[n_full]],
                                    full_sizes, B)
        chunked.validate_bp_chunk_headers(mat, full_sizes, chunk_len, eb * 8)
        (vals,) = _local_chunks(lambda x: (dec(x, chunk_len),), mat[None],
                                mesh, [((chunk_len,), dt)])
        out[: n_full * chunk_len] = _gather_to_host(vals, n_full, mesh).reshape(-1)
    for c in range(n_full, n_chunks):
        out[c * chunk_len :] = chunked._bp_host_decode(
            buf[offsets[c] : offsets[c + 1]], total - c * chunk_len, eb)
    return out
