"""The port's benchmark: ``python -m trico_tpu_torch.bench [--device cpu]``.

Counterpart of the root ``bench.py``, leg for leg, on the port's entry
points. It prints one JSON line, last:

    {"metric": "fp32_encode_GBps_per_chip", "value": <GB/s>, "unit": "GB/s",
     "extra": {...}}

``value`` is the headline: the f32 v2 chunked encode (chunks of 4096,
exponents (4,6)) of bench.py's 8M-value stream, device-resident. The legs,
in order (the bench.py lines each ports):

1. headline (bench.py:87-131): ``fp_torch.encode_f32_chunks_v2`` /
   ``decode_f32_chunks_v2``: ``ratio``, ``decode_gbps``, ``exact``;
2. adaptive encode (:135-143): ``encode_f32_chunks_v2_adaptive`` with
   ``F32_TPU_CANDIDATES``: ``adaptive_encode_gbps``, ``adaptive_ratio``;
3. second shape (:149-162): encode and decode at (8192, 1024),
   ``miscompile_canary``: the bench's exactness check at another chunk
   length (the XLA:TPU miscompile it was named for has no counterpart);
4. ``scale`` (:164-206): 44,040,192 values made on the device;
5. ``fullmesh`` (:208-278): 3 planes of 14,680,064 values made on the
   device, and 88,080,384 triangle indices through BP32 at 16,384;
6. ``f64`` (:280-327): 16,777,216 doubles at (4,6);
7. ``bunny_*`` (:499-556): the Stanford bunny as a v0 archive on the host
   (best of 9 per stage) and as a v1 archive on the device;
8. ``fullmesh_archive`` (:409-496): ``parallel.compress_mesh`` /
   ``decompress_mesh`` of the 2M-vertex Lucy-class mesh on ``make_mesh()``,
   host clock, split by stage.

Legs 1-6 are timed with CUDA events on the stream the codecs launch on,
after one untimed call (which also builds the kernels), over bench.py's
rep counts; each reports input bytes over the mean rep time as GB/s and the
per-rep milliseconds under ``"ms"`` (mean, min, max). Legs 7-8 are host
clock, ending in a synchronize. ``extra`` also holds ``backend``, the
card's ``device`` (name and power limit from ``nvidia-smi``), the
``kernel_launches`` of the run by kernel and, under ``legs``, each leg's
seconds and peak device memory.

Data: legs 1, 3, 6, 7, 8 and leg 5's triangles come from NumPy (seeds as
in bench.py; leg 3 from a NumPy generator with seed 7), so their bytes
compare with trico_tpu's on the same arrays. Legs 4 and 5's vertex planes
are made on the device by ``torch.randn`` (seeds 0 and 10-12) in
bench.py's formula, the walk summed exactly in integers so that every run
makes the same data; torch's generator is not JAX's, so those legs' ratios
do not equal ``BENCH_r05.json``'s.

Exactness gate (bench.py:612-619): if any leg's round trip is not
bit-exact, ``value`` and ``decode_gbps`` read 0, ``inexact_roundtrip`` is
true, a message goes to stderr and the exit code is 1.

Sizes: bench.py's by default. ``TRICO_BENCH_VALUES`` sets the headline
stream (8,388,608 values) and ``TRICO_BENCH_CHUNK`` its chunk length
(4096); legs 3-6 keep bench.py's ratio to the headline stream (1, 5.25,
1.75 per plane and 3.5 triangles, 2), so a small value makes the whole
run small. ``TRICO_BENCH_MESH_VERTS`` sets leg 8's requested vertices
(2,000,000). Every other size and the rep counts are arguments of
:func:`run`.

The entry point runs on the card; ``--device cpu`` runs the plain versions
of the kernels on the CPU, to show that the run works: its times are the
host's, no device metric, and each leg takes the least rep count of
bench.py's formula (10 for legs 1-2, 2 for legs 4-6). Without a card the
default run raises and prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import _u32, _u64, chunked
from .archive import ArchiveReader, ArchiveWriter
from .codec import bp_torch, fp64_torch, fp_cuda, fp_torch
from .io.stl import read_stl
from .parallel import mesh_codec
from .profiling import StageTimer

N_VALUES = 8 * 1024 * 1024  # bench.py:561: the headline stream
CHUNK_LEN = 4096  # bench.py:563: chunked.DEFAULT_CHUNK_LEN
EXP = (4, 6)  # bench.py:94: chunked.F32_TPU_EXP
CANARY_LEN = 1024  # bench.py:149: (8192, 1024)
BP_CHUNK = 16384  # bench.py:232: the BP32 default
ARCHIVE_CHUNK = 4096  # bench.py:467, :539
ARCHIVE_VERTS = 2_000_000  # bench.py:419
BUNNY = Path(__file__).resolve().parents[1] / "tests" / "data" / "StanfordBunny.stl"
BUNNY_REF_TRC_BYTES = 584613  # the reference encoder's bunny archive
REP_BYTES = 1.5e9  # bench.py:115: reps move at least this many input bytes


def bench_stream(n: int) -> np.ndarray:
    """bench.py:87-90's f32 stream, as uint32 bits."""
    r = np.random.default_rng(0)
    t = np.linspace(0, 500 * np.pi, n)
    vals = (np.sin(t) * 10 + np.cumsum(r.normal(0, 1e-3, n))).astype(np.float32)
    return vals.view(np.uint32)


def canary_stream(n: int) -> np.ndarray:
    """bench.py:154-156's formula (a walk plus a sine of amplitude 10) from
    a NumPy generator with seed 7, as uint32 bits."""
    r = np.random.default_rng(7)
    vals = (np.cumsum(r.normal(0, 1e-3, n))
            + np.sin(np.linspace(0., 3000., n)) * 10).astype(np.float32)
    return vals.view(np.uint32)


def bench_stream64(n: int) -> np.ndarray:
    """bench.py:290-293's f64 stream, as uint64 bits."""
    r = np.random.default_rng(3)
    vals = (np.cumsum(r.normal(0, 1e-3, n))
            + np.sin(np.linspace(0., 3000., n)) * 10)
    return vals.view(np.uint64)


def fullmesh_indices(n_triangles: int = 28 << 20) -> np.ndarray:
    """bench.py:231-235's triangle stream: 3 * n_triangles u32 indices (the
    largest 29,361,164 at the default, so no byte plane is constant)."""
    i = np.arange(3 * n_triangles, dtype=np.uint32)
    return i // 3 + (i % 3) * 7 + i % 1024


def lucy_mesh(n_verts: int):
    """bench.py:415-431's synthetic Lucy-class mesh: a smooth scan surface
    on a grid of side ``int(sqrt(n_verts))``, as (vertices (V, 3) float32,
    triangles (T, 3) uint32)."""
    side = int(np.sqrt(n_verts))
    th = np.linspace(0.2, np.pi - 0.2, side, dtype=np.float32)[:, None]
    ph = np.linspace(0.0, 1.7 * np.pi, side, dtype=np.float32)[None, :]
    r = 10.0 + np.cumsum(np.random.default_rng(0).normal(
        0, 1e-3, (side, side)).astype(np.float32), axis=1)
    verts = np.stack([(r * np.sin(th) * np.cos(ph)).ravel(),
                      (r * np.sin(th) * np.sin(ph)).ravel(),
                      (r * np.cos(th) * np.ones_like(ph)).ravel()],
                     axis=1).astype(np.float32)
    i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1), indexing="ij")
    v00 = (i * side + j).ravel()
    v01, v10 = v00 + 1, v00 + side
    tris = np.concatenate([np.stack([v00, v10, v01], 1),
                           np.stack([v01, v10, v10 + 1], 1)]).astype(np.uint32)
    return verts, tris


WALK_ULP = 2.0 ** -32  # the grid a device-made walk is summed on


def device_stream(n: int, seed: int, amplitude: float, device) -> torch.Tensor:
    """bench.py:169-173's formula made on ``device``: a walk of
    ``torch.randn(n) * 1e-3`` steps plus ``sin(linspace(0, 3000, n)) *
    amplitude``, as float32 bits in int32. The data must be the same in
    every run, so nothing depends on how a kernel splits its work: the
    steps are summed as integers of ``WALK_ULP`` (a float ``cumsum`` on a
    card is a parallel scan whose rounding depends on timing), and the
    sine's arguments are each one product in float64 (a float32
    ``linspace`` rounds differently where a thread's share begins)."""
    g = torch.Generator(device).manual_seed(seed)
    step = torch.randn(n, generator=g, device=device) * 1e-3
    walk = torch.cumsum(torch.round(step.double() / WALK_ULP).long(), 0)
    t = torch.arange(n, device=device).double() * (3000. / max(n - 1, 1))
    return (walk.double() * WALK_ULP + torch.sin(t) * amplitude).float().view(torch.int32)


def _reps(nbytes: int, least: int, reps: int | None,
          device: torch.device) -> int:
    """bench.py's rep count: at least ``least``, and enough reps to move
    1.5 GB of input; on the CPU, ``least``. ``reps`` overrides it."""
    if reps is not None:
        return reps
    if device.type == "cpu":
        return least
    return max(least, int(REP_BYTES // nbytes) + 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, reps: int, device: torch.device):
    """Call ``fn`` once untimed, then ``reps`` times: (its last result, the
    milliseconds of each rep). On a card each rep is bounded by CUDA events
    recorded on the current stream, where the codecs launch; on the CPU by
    the host clock."""
    out = fn()
    _sync(device)
    if device.type == "cuda":
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        marks[0].record()
        for i in range(reps):
            out = fn()
            marks[i + 1].record()
        torch.cuda.synchronize(device)
        return out, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def time_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of ``fn`` on the card, after one warm-up: the
    ``reps`` calls run back to back between two CUDA events, with no event
    between them as :func:`timed` records (the kernel timer of
    ``chip_smoke.py`` and ``tools/``)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ms_stats(ms: list[float]) -> dict:
    return {"mean": sum(ms) / len(ms), "min": min(ms), "max": max(ms),
            "reps": len(ms)}


def gbps(nbytes: int, ms: list[float]) -> float:
    """Input bytes over the mean rep time, in GB/s."""
    return nbytes / 1e6 / (sum(ms) / len(ms))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _total(sizes: torch.Tensor) -> int:
    return int(sizes.sum().item())


# ---------------------------------------------------------------------------
# the legs; each returns its keys and frees its tensors when it returns
# ---------------------------------------------------------------------------


def headline_leg(x: torch.Tensor, reps: int) -> dict:
    """Legs 1 and 2 on the (C, L) words ``x``."""
    dev, L = x.device, x.shape[1]
    nbytes = _nbytes(x)
    (payloads, sizes), enc_ms = timed(
        lambda: fp_torch.encode_f32_chunks_v2(x, *EXP), reps, dev)
    dec, dec_ms = timed(
        lambda: fp_torch.decode_f32_chunks_v2(payloads, L, *EXP), reps, dev)
    exact = bool(torch.equal(dec, x))
    del dec
    (_, sz_a), ada_ms = timed(
        lambda: fp_torch.encode_f32_chunks_v2_adaptive(
            x, fp_torch.F32_TPU_CANDIDATES), reps, dev)
    comp, comp_a = _total(sizes), _total(sz_a)
    return {"gbps": gbps(nbytes, enc_ms), "decode_gbps": gbps(nbytes, dec_ms),
            "adaptive_encode_gbps": gbps(nbytes, ada_ms),
            "ratio": nbytes / comp, "adaptive_ratio": nbytes / comp_a,
            "compressed_bytes": comp, "adaptive_compressed_bytes": comp_a,
            "chunk_len": L, "headline_exact": exact,
            "ms": {"encode": ms_stats(enc_ms), "decode": ms_stats(dec_ms),
                   "adaptive_encode": ms_stats(ada_ms)}}


def canary_leg(xc: torch.Tensor) -> bool:
    """Leg 3: one encode and decode of the (C, L) words ``xc``."""
    payloads, _ = fp_torch.encode_f32_chunks_v2(xc, *EXP)
    back = fp_torch.decode_f32_chunks_v2(payloads, xc.shape[1], *EXP)
    return bool(torch.equal(back, xc))


def scale_leg(xs: torch.Tensor, reps: int | None) -> dict:
    """Leg 4 on the (C, L) words ``xs``."""
    dev, L = xs.device, xs.shape[1]
    nbytes = _nbytes(xs)
    n = _reps(nbytes, 2, reps, dev)
    (payloads, sizes), enc_ms = timed(
        lambda: fp_torch.encode_f32_chunks_v2(xs, *EXP), n, dev)
    dec, dec_ms = timed(
        lambda: fp_torch.decode_f32_chunks_v2(payloads, L, *EXP), n, dev)
    return {"n_values": xs.numel(),
            "encode_gbps": round(gbps(nbytes, enc_ms), 3),
            "decode_gbps": round(gbps(nbytes, dec_ms), 3),
            "ratio": round(nbytes / _total(sizes), 4),
            "compressed_bytes": _total(sizes),
            "exact": bool(torch.equal(dec, xs)), "reps": n,
            "ms": {"encode": ms_stats(enc_ms), "decode": ms_stats(dec_ms)}}


def fullmesh_leg(vchunks: torch.Tensor, tchunks: torch.Tensor,
                 reps: int | None) -> dict:
    """Leg 5: the vertex planes' chunks ``vchunks`` (3 C, L) at (4,6) and
    the triangle indices ``tchunks`` (Ct, BPL) through BP32, timed as one
    encode and one decode of both."""
    dev, L, BPL = vchunks.device, vchunks.shape[1], tchunks.shape[1]
    raw_bytes = _nbytes(vchunks) + _nbytes(tchunks)
    n = _reps(raw_bytes, 2, reps, dev)

    def encode():
        return (*fp_torch.encode_f32_chunks_v2(vchunks, *EXP),
                *bp_torch.encode_bp32_chunks(tchunks))

    (vp, vs, tp, ts), enc_ms = timed(encode, n, dev)
    (dv, dt), dec_ms = timed(
        lambda: (fp_torch.decode_f32_chunks_v2(vp, L, *EXP),
                 bp_torch.decode_bp32_chunks(tp, BPL)), n, dev)
    fp_bytes, bp_bytes = _total(vs), _total(ts)
    return {"verts": vchunks.numel() // 3, "tris": tchunks.numel() // 3,
            "raw_GB": round(raw_bytes / 1e9, 3),
            "encode_gbps": round(gbps(raw_bytes, enc_ms), 3),
            "decode_gbps": round(gbps(raw_bytes, dec_ms), 3),
            "ratio": round(raw_bytes / (fp_bytes + bp_bytes), 4),
            "fp_bytes": fp_bytes, "bp32_bytes": bp_bytes,
            "exact": bool(torch.equal(dv, vchunks) and torch.equal(dt, tchunks)),
            "reps": n,
            "ms": {"encode": ms_stats(enc_ms), "decode": ms_stats(dec_ms)}}


def f64_leg(x64: torch.Tensor, reps: int | None) -> dict:
    """Leg 6 on the (C, L) u64 words ``x64``."""
    dev, L = x64.device, x64.shape[1]
    nbytes = _nbytes(x64)
    n = _reps(nbytes, 2, reps, dev)
    (payloads, sizes), enc_ms = timed(
        lambda: fp64_torch.encode_f64_chunks_v2(x64, *EXP), n, dev)
    dec, dec_ms = timed(
        lambda: fp64_torch.decode_f64_chunks_v2(payloads, L, *EXP), n, dev)
    return {"n_values": x64.numel(), "exponents": list(EXP),
            "encode_gbps": round(gbps(nbytes, enc_ms), 3),
            "decode_gbps": round(gbps(nbytes, dec_ms), 3),
            "ratio": round(nbytes / _total(sizes), 4),
            "compressed_bytes": _total(sizes),
            "exact": bool(torch.equal(dec, x64)), "reps": n,
            "ms": {"encode": ms_stats(enc_ms), "decode": ms_stats(dec_ms)}}


def bunny_leg(path, device: torch.device, chunk_len: int, reps: int) -> dict:
    """Leg 7: the bunny's vertices and triangles as a v0 archive on the
    host, best of ``reps`` per stage after a warm-up, and as a v1 archive
    of ``chunk_len``-value chunks on ``device``."""
    verts, tris = read_stl(path)
    w0 = ArchiveWriter(device=device)
    w0.write_vertices(verts)
    w0.write_triangles(tris)
    best = {}
    for _ in range(reps):
        prof = StageTimer()
        w = ArchiveWriter(device=device)
        with prof.stage("encode_vertices_fp", verts.nbytes, sync=device):
            w.write_vertices(verts)
        with prof.stage("encode_triangles_lz4", tris.nbytes, sync=device):
            w.write_triangles(tris)
        blob = w.tobytes()
        r = ArchiveReader(blob, device=device)
        with prof.stage("decode_vertices_fp", verts.nbytes, sync=device):
            v2 = r.read_vertices()
        with prof.stage("decode_triangles_lz4", tris.nbytes, sync=device):
            t2 = r.read_triangles()
        for k in prof.stages:
            best[k] = max(best.get(k, 0.0), prof.gbps(k))
    exact = bool(np.array_equal(v2.view(np.uint32), verts.view(np.uint32))
                 and np.array_equal(t2, tris))
    w1 = ArchiveWriter(chunk_len=chunk_len, device=device)
    w1.write_vertices(verts)
    w1.write_triangles(tris)
    blob1 = w1.tobytes()
    r1 = ArchiveReader(blob1, device=device)
    exact1 = bool(np.array_equal(r1.read_vertices().view(np.uint32),
                                 verts.view(np.uint32))
                  and np.array_equal(r1.read_triangles(), tris))
    return {"bunny_trc_bytes": len(blob), "bunny_ref_trc_bytes": BUNNY_REF_TRC_BYTES,
            "bunny_exact": exact, "bunny_trc_v1_bytes": len(blob1),
            "bunny_v1_exact": exact1,
            **{f"bunny_{k}_gbps": round(v, 3) for k, v in best.items()}}


def archive_leg(n_verts: int, device: torch.device, chunk_len: int) -> dict:
    """Leg 8: ``compress_mesh`` / ``decompress_mesh`` of the Lucy-class
    mesh's vertices and triangles on ``make_mesh()`` (one shard per card):
    one warm-up, then one timed run split by stage."""
    verts, tris = lucy_mesh(n_verts)
    raw_bytes = verts.nbytes + tris.nbytes
    mesh = mesh_codec.make_mesh(device=device)
    mesh_codec.compress_mesh(verts, tris, chunk_len=chunk_len, mesh=mesh)
    _sync(device)
    prof = StageTimer()
    t0 = time.perf_counter()
    blob = mesh_codec.compress_mesh(verts, tris, chunk_len=chunk_len, mesh=mesh,
                                    profile=prof)
    _sync(device)
    enc_dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = mesh_codec.decompress_mesh(blob, mesh)
    _sync(device)
    dec_dt = time.perf_counter() - t0
    exact = bool(np.array_equal(out["vertices"].view(np.uint32),
                                verts.view(np.uint32))
                 and np.array_equal(out["triangles"], tris))
    stages = {k: round(s.seconds, 4) for k, s in prof.stages.items()}
    accounted = sum(stages.values())
    return {"n_vertices": len(verts), "n_triangles": len(tris),
            "raw_bytes": raw_bytes, "archive_bytes": len(blob),
            "ratio": round(raw_bytes / len(blob), 3),
            "encode_wall_s": round(enc_dt, 4), "decode_wall_s": round(dec_dt, 4),
            "encode_gbps": round(raw_bytes / 1e9 / enc_dt, 3),
            "decode_gbps": round(raw_bytes / 1e9 / dec_dt, 3),
            "stage_seconds": stages,
            "assembly_frac": round(stages.get("fp_assembly", 0.0) / enc_dt, 4),
            "other_frac": round(max(enc_dt - accounted, 0.0) / enc_dt, 4),
            "exact": exact, "backend": f"{device.type}-mesh-{mesh.size}dev"}


def smi(query: str, device: torch.device) -> list[str]:
    """The fields of ``nvidia-smi --query-gpu=<query>`` for the card
    ``device``."""
    rows = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    return [s.strip() for s in rows[device.index or 0].split(",")]


def card(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them; on the
    CPU, no card."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    name, limit = smi("name,power.limit", device)
    return {"name": name, "power_limit": limit}


class _Legs:
    """Runs each leg with the device's peak memory counter reset, and keeps
    its seconds and peak."""

    def __init__(self, device: torch.device):
        self.device = device
        self.record: dict = {}

    def __call__(self, name: str, fn, *args):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(self.device)
        peak = (torch.cuda.max_memory_allocated(self.device) / 2**20
                if cuda else None)
        self.record[name] = {"seconds": round(time.perf_counter() - t0, 3),
                             "peak_mib": None if peak is None else round(peak, 1)}
        print(f"bench: {name} {self.record[name]['seconds']} s, peak "
              f"{self.record[name]['peak_mib']} MiB", file=sys.stderr, flush=True)
        return out


def run(*, device="cuda", n_values: int = N_VALUES, chunk_len: int = CHUNK_LEN,
        canary_len: int = CANARY_LEN, bp_chunk: int = BP_CHUNK, bunny=BUNNY,
        archive_chunk: int = ARCHIVE_CHUNK, archive_verts: int = ARCHIVE_VERTS,
        reps: int | None = None) -> dict:
    """Run the eight legs on ``device`` and return the result line as a
    dict. Legs 3-6 keep bench.py's ratio to ``n_values``: the canary
    ``n_values`` values (8192 chunks of ``canary_len`` 1024), the scale leg
    21/4 of it (44,040,192), the full mesh 7/4 per plane (14,680,064) and
    7/2 triangles (29,360,128), f64 twice it (16,777,216). ``reps``
    replaces every leg's rep count (bench.py's formula; the bunny's best of
    9)."""
    dev = chunked._resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    legs = _Legs(dev)
    L = chunk_len

    def words(a: np.ndarray, length: int, to) -> torch.Tensor:
        C = len(a) // length
        return to(a[: C * length].reshape(C, length)).to(dev)

    def head():
        x = words(bench_stream(n_values), L, _u32.from_numpy)
        return headline_leg(x, _reps(_nbytes(x), 10, reps, dev))

    def canary():
        return canary_leg(words(canary_stream(n_values), canary_len,
                                _u32.from_numpy))

    def scale():
        C = n_values * 21 // 4 // L
        return scale_leg(device_stream(C * L, 0, 10.0, dev).view(C, L), reps)

    def fullmesh():
        C = n_values * 7 // 4 // L
        vchunks = torch.cat([device_stream(C * L, 10 + ax, 3.0 + ax, dev).view(C, L)
                             for ax in range(3)])
        tchunks = words(fullmesh_indices(n_values * 7 // 2), bp_chunk,
                        _u32.from_numpy)
        return fullmesh_leg(vchunks, tchunks, reps)

    def f64():
        return f64_leg(words(bench_stream64(2 * n_values), L, _u64.from_numpy), reps)

    fp_cuda.reset_launches()
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        h = legs("headline", head)
        canary_ok = legs("canary", canary)
        scale_r = legs("scale", scale)
        fullmesh_r = legs("fullmesh", fullmesh)
        f64_r = legs("f64", f64)
        bunny_r = legs("bunny", bunny_leg, bunny, dev, archive_chunk,
                       9 if reps is None else reps)
        archive_r = legs("fullmesh_archive", archive_leg, archive_verts, dev,
                         archive_chunk)
    launches = dict(fp_cuda.launches)

    extra = {"decode_gbps": h["decode_gbps"],
             "adaptive_encode_gbps": h["adaptive_encode_gbps"],
             "ratio": h["ratio"], "adaptive_ratio": h["adaptive_ratio"],
             "compressed_bytes": h["compressed_bytes"],
             "adaptive_compressed_bytes": h["adaptive_compressed_bytes"],
             "chunk_len": h["chunk_len"], "n_values": n_values,
             "miscompile_canary": canary_ok, "ms": h["ms"],
             "scale": {"lucy42M": scale_r}, "fullmesh": fullmesh_r, "f64": f64_r,
             "exact": h["headline_exact"] and canary_ok,
             "backend": dev.type, "device": card(dev),
             **bunny_r, "fullmesh_archive": archive_r,
             "kernel_launches": launches, "legs": legs.record}
    line = {"metric": "fp32_encode_GBps_per_chip", "value": round(h["gbps"], 3),
            "unit": "GB/s", "extra": extra}
    exact = {"headline": h["headline_exact"], "canary": canary_ok,
             "scale": scale_r["exact"], "fullmesh": fullmesh_r["exact"],
             "f64": f64_r["exact"], "bunny": bunny_r["bunny_exact"],
             "bunny_v1": bunny_r["bunny_v1_exact"],
             "fullmesh_archive": archive_r["exact"]}
    if not all(exact.values()):
        # a lossless codec has no throughput when it loses data
        line["value"] = 0.0
        extra["decode_gbps"] = 0.0
        extra["inexact_roundtrip"] = True
        print("BENCH FAILURE: round-trip not bit-exact in "
              f"{', '.join(k for k, ok in exact.items() if not ok)}; "
              "throughput voided", file=sys.stderr)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trico_tpu_torch.bench",
        description="Benchmark the port's codecs; prints one JSON line.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU")
    args = ap.parse_args(argv)
    line = run(device=args.device,
               n_values=int(os.environ.get("TRICO_BENCH_VALUES", N_VALUES)),
               chunk_len=int(os.environ.get("TRICO_BENCH_CHUNK", CHUNK_LEN)),
               archive_verts=int(os.environ.get("TRICO_BENCH_MESH_VERTS",
                                                ARCHIVE_VERTS)))
    print(json.dumps(line), flush=True)
    return 1 if line["extra"].get("inexact_roundtrip") else 0


if __name__ == "__main__":
    sys.exit(main())
