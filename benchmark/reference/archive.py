"""Plain NumPy decoder of version-1 trico archives (FORMAT.md sections 1
and 4), over the decoders of :mod:`.fp`, :mod:`.bp` and :mod:`.lz4`.

An archive is ``[u32 LE magic "Trco"][u32 LE version 1]`` and stream
blocks ``[u8 type][u32 LE count]{[u32 LE size][payload]}``. Each payload is
a chunked container: ``[u8 1][u8 flags][u32 chunk_len][u32 total][u32
n_chunks][n_chunks x u32 size][payloads]``. Flags bit 0: 64-bit words; bit
1: LZ4 blocks; bit 2: v2 FP chunk layout; bit 3: BP; bits 1 and 3: a fill
container. The last FP chunk of a stream that does not fill it is in the
reference layout. Every byte of the archive has to be accounted for.

All archives handed to :func:`decode_archives` are decoded together, so
that the chunks and blocks of all of them share the lockstep passes.
"""

from __future__ import annotations

import struct

import numpy as np

from . import bp, fp, lz4

MAGIC = 0x6F637254
# stream type → (name, substreams, bits) of the float streams
FP_STREAMS = {
    1: ("vertices", 3, 32), 2: ("vertices", 3, 64),
    5: ("uv_per_vertex", 2, 32), 6: ("uv_per_vertex", 2, 64),
    7: ("uv_per_triangle", 2, 32), 8: ("uv_per_triangle", 2, 64),
    9: ("vertex_normals", 3, 32), 10: ("vertex_normals", 3, 64),
    11: ("triangle_normals", 3, 32), 12: ("triangle_normals", 3, 64),
    15: ("attributes_float", 1, 32), 16: ("attributes_double", 1, 64),
}
# stream type → (name, byte planes, values per counted element)
INT_STREAMS = {
    3: ("triangles", 4, 3), 4: ("triangles", 8, 3),
    13: ("vertex_colors", 4, 1), 14: ("triangle_colors", 4, 1),
    17: ("attributes_uint8", 1, 1), 18: ("attributes_uint16", 2, 1),
    19: ("attributes_uint32", 4, 1), 20: ("attributes_uint64", 8, 1),
}
WORD = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


class Container:
    """A parsed container: its kind, word bits, layout, chunk length,
    total, and each chunk's payload."""

    def __init__(self, data: np.ndarray):
        if len(data) < 14 or data[0] != 1:
            raise ValueError("not a version-1 chunked container")
        flags = int(data[1])
        self.chunk_len, self.total, n = struct.unpack_from("<III", data.tobytes()[:14], 2)
        if flags == 10:
            self.kind = "fill"
        elif flags & ~15 or (flags & 2 and flags & 8):
            raise ValueError(f"container flags {flags} name no kind")
        else:
            self.kind = "bp" if flags & 8 else "lz4" if flags & 2 else "fp"
        self.bits = 64 if flags & 1 else 32
        self.layout = "tpu" if flags & 4 else "ref"
        if self.chunk_len == 0:
            raise ValueError("container with a zero chunk length")
        head = 14 + 4 * n
        if head > len(data):
            raise ValueError("container truncated in its size table")
        sizes = np.frombuffer(data[14:head].tobytes(), "<u4").astype(np.int64)
        if head + int(sizes.sum()) != len(data):
            raise ValueError("container sizes do not add up to its bytes")
        want = -(-self.total // self.chunk_len)
        if n != want and not (self.kind == "lz4" and self.total == 0 and n <= 1):
            raise ValueError("container chunk count does not match its total")
        bounds = head + np.concatenate([[0], np.cumsum(sizes)])
        self.chunks = [data[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def counts(self) -> list[int]:
        """Values (bytes for LZ4) each chunk decodes to."""
        return [min(self.chunk_len, self.total - c * self.chunk_len)
                for c in range(len(self.chunks))]


class _Jobs:
    """Chunks and blocks of every archive, collected for the batch
    decoders; each job's result is read back by its index."""

    def __init__(self):
        self.lists = {"fp32": [], "fp64": [], "bp32": [], "bp64": [], "lz4": []}
        self.results = {}

    def add(self, kind: str, job) -> tuple[str, int]:
        self.lists[kind].append(job)
        return kind, len(self.lists[kind]) - 1

    def run(self) -> None:
        L = self.lists
        self.results = {
            "fp32": fp.decode_chunks(L["fp32"], 32) if L["fp32"] else [],
            "fp64": fp.decode_chunks(L["fp64"], 64) if L["fp64"] else [],
            "bp32": bp.decode_chunks(L["bp32"], 32) if L["bp32"] else [],
            "bp64": bp.decode_chunks(L["bp64"], 64) if L["bp64"] else [],
            "lz4": lz4.decode_blocks(L["lz4"]) if L["lz4"] else [],
        }

    def get(self, key) -> np.ndarray:
        return self.results[key[0]][key[1]]


def _plan_fp(c: Container, bits: int, jobs: _Jobs):
    if c.kind != "fp" or c.bits != bits:
        raise ValueError(f"a {c.kind} container in a {bits}-bit float stream")
    counts = c.counts()
    keys = []
    for k, (p, n) in enumerate(zip(c.chunks, counts)):
        layout = c.layout if n == c.chunk_len else "ref"
        keys.append((jobs.add(f"fp{bits}", (p, layout)), n))

    def done():
        parts = []
        for key, n in keys:
            words = jobs.get(key)
            if len(words) != n:
                raise ValueError("FP chunk count does not match its container")
            parts.append(words)
        dt = np.uint32 if bits == 32 else np.uint64
        return np.concatenate(parts) if parts else np.zeros(0, dt)
    return done


def _plan_plane(c: Container, jobs: _Jobs):
    """An LZ4 or fill byte plane."""
    if c.kind == "fill":
        if len(c.chunks) != 1 or len(c.chunks[0]) != 1 or c.chunk_len != c.total:
            raise ValueError("malformed fill container")
        return lambda: np.full(c.total, c.chunks[0][0], np.uint8)
    if c.kind != "lz4":
        raise ValueError(f"a {c.kind} container among byte planes")
    keys = [jobs.add("lz4", (p, n)) for p, n in zip(c.chunks, c.counts())]
    return lambda: (np.concatenate([jobs.get(k) for k in keys]) if keys
                    else np.zeros(0, np.uint8))


def _plan_bp(c: Container, jobs: _Jobs):
    keys = [jobs.add(f"bp{c.bits}", (p, n)) for p, n in zip(c.chunks, c.counts())]
    dt = np.uint32 if c.bits == 32 else np.uint64
    return lambda: (np.concatenate([jobs.get(k) for k in keys]) if keys
                    else np.zeros(0, dt))


def _plan_int(subs: list[Container], width: int, n_values: int, jobs: _Jobs):
    dt = WORD[width]
    if subs[0].kind == "bp":
        # the whole stream in the first container; the others are empty
        if np.dtype(dt).itemsize * 8 != subs[0].bits:
            raise ValueError("BP container width does not match the stream")
        if any(s.kind != "bp" or s.total or s.chunks for s in subs[1:]):
            raise ValueError("BP stream with a non-empty placeholder")
        get = _plan_bp(subs[0], jobs)
        return lambda: get().astype(dt, copy=False)
    planes = [_plan_plane(s, jobs) for s in subs]

    def done():
        ps = [p() for p in planes]
        if any(len(p) != n_values for p in ps):
            raise ValueError("byte plane length does not match the count")
        return np.stack(ps, axis=1).reshape(-1).view(np.dtype(dt).newbyteorder("<")).astype(dt)
    return done


def streams(blob: bytes) -> list[tuple[int, int, list[Container]]]:
    """Walk the framing of one archive → (stream type, count, containers)
    per stream, in order."""
    data = np.frombuffer(blob, np.uint8)
    if len(data) < 8:
        raise ValueError("archive shorter than its header")
    magic, version = struct.unpack_from("<II", blob, 0)
    if magic != MAGIC or version != 1:
        raise ValueError(f"not a version-1 trico archive ({magic:#x}, {version})")
    pos, out = 8, []
    while pos < len(data):
        if pos + 5 > len(data):
            raise ValueError("archive truncated in a stream header")
        st = int(data[pos])
        (count,) = struct.unpack_from("<I", blob, pos + 1)
        pos += 5
        if st in FP_STREAMS:
            nsub = FP_STREAMS[st][1]
        elif st in INT_STREAMS:
            nsub = INT_STREAMS[st][1]
        else:
            raise ValueError(f"unknown stream type {st}")
        subs = []
        for _ in range(nsub):
            if pos + 4 > len(data):
                raise ValueError("archive truncated in a substream size")
            (size,) = struct.unpack_from("<I", blob, pos)
            pos += 4
            if pos + size > len(data):
                raise ValueError("archive truncated in a substream")
            subs.append(Container(data[pos : pos + size]))
            pos += size
        out.append((st, count, subs))
    return out


def _plan_archive(blob: bytes, jobs: _Jobs):
    """Queue the chunks of one archive, and return the function that
    assembles its streams once the jobs have run."""
    plans = []
    for st, count, subs in streams(blob):
        if st in FP_STREAMS:
            name, nsub, bits = FP_STREAMS[st]
            plans.append((name, st, count, nsub, [_plan_fp(s, bits, jobs) for s in subs]))
        else:
            name, nsub, mult = INT_STREAMS[st]
            plans.append((name, st, count, mult, _plan_int(subs, nsub, count * mult, jobs)))

    def assemble() -> dict:
        out = {}
        for name, st, count, k, plan in plans:
            if name in out:
                raise ValueError(f"stream {name} twice in one archive")
            if st in FP_STREAMS:
                planes = [p() for p in plan]
                if any(len(p) != count for p in planes):
                    raise ValueError(f"{name}: plane length does not match the count")
                arr = np.stack(planes, axis=1) if k > 1 else planes[0]
            else:
                arr = plan()
                if len(arr) != count * k:
                    raise ValueError(f"{name}: value count does not match the count")
                if k == 3:
                    arr = arr.reshape(-1, 3)
            out[name] = arr
        return out
    return assemble


def decode_archives(blobs: list[bytes]) -> list[dict | ValueError]:
    """Decode version-1 archives → per archive, its streams by name as raw
    words (float streams as u32 / u64 bits, (count, width)), or the
    ValueError that says why it is malformed."""
    jobs = _Jobs()
    plans = []
    for blob in blobs:
        try:
            plans.append(_plan_archive(blob, jobs))
        except ValueError as e:
            plans.append(e)
    try:
        jobs.run()
    except ValueError as e:
        if len(blobs) == 1:
            return [e]
        # find the archive at fault: decode each on its own
        return [decode_archives([b])[0] for b in blobs]
    out = []
    for plan in plans:
        if isinstance(plan, ValueError):
            out.append(plan)
            continue
        try:
            out.append(plan())
        except ValueError as e:
            out.append(e)
    return out


def decode_archive(blob: bytes) -> dict:
    """Decode one archive; raises ValueError if it is malformed."""
    (res,) = decode_archives([blob])
    if isinstance(res, ValueError):
        raise res
    return res
