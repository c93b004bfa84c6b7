"""The port's spans (``trico_tpu_torch.profiling.span``) on meshes of CPU
shards: which spans a write and a read of a mesh with triangles and colours,
and of a point cloud, open; that each is annotated once in a profiler trace
whichever recorder is active (the benchmark's ``Spans``, a ``StageTimer`` or
none); that with tracing off no span annotates or waits for the device; that
tracing changes no archive byte; and that the tally's bytes and chunk counts
equal what the archive and its planes hold.

The LZ4 block is cut to 4096 bytes inside each test, so the device match
search runs on planes of a few kilobytes (``chunked.encode_int_best`` reads
``DEFAULT_LZ4_BLOCK`` at call time)."""

import contextlib
import importlib.util
import json

import numpy as np
import pytest
import torch

from conftest import REPO
from torch_cases import recording, require_native
from trico_tpu_torch import chunked, profiling
from trico_tpu_torch.codec import fp_torch, transpose
from trico_tpu_torch.parallel import mesh_codec as mc

BLOCK = 4096
SIDE = 81  # 6561 vertices: 25 full chunks of 256 and a tail; 38,400 indices: 2 full BP chunks
CHUNK = 256

WRITE_FP = {"write.vertices", "fp_split", "fp_device_encode", "fp_h2d", "fp_d2h",
            "fp_gather", "fp_assembly", "fp_tails", "fp_frame", "archive_join"}
WRITE_INT = {"write.triangles", "write.vertex_colors", "int_encode", "int_planes",
             "lz4_search", "lz4_d2h", "lz4_emit", "bp_encode", "bp_d2h", "bp_assembly"}
READ_FP = {"read.vertices", "read_framing", "fp_decode", "fp_read_h2d", "fp_read_d2h",
           "fp_host_chunks", "fp_interleave"}
READ_INT = {"read.triangles", "read.vertex_colors", "bp_decode", "bp_read_h2d",
            "bp_read_d2h", "lz4_decode", "int_join"}
TALLY_ONLY = ("compress_mesh", "archive.", "fp_read_words", "fp_chunks.", "byte_planes.")


def _grid_mesh(side: int, seed: int = 5) -> dict:
    """A seeded surface on a side x side grid; its triangles cell by cell,
    shuffled within runs of 16 (so BP codes them: the LZ4 planes come out
    larger); RGBA colours of random RGB and an opaque alpha (LZ4 codes them,
    alpha a fill plane)."""
    rng = np.random.default_rng(seed)
    v = np.arange(side * side)
    walk = np.cumsum(rng.normal(0, 1e-3, side * side))
    verts = np.stack([(v % side) * 0.01, (v // side) * 0.01,
                      np.sin(v * 0.05) + walk], axis=1).astype(np.float32)
    i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1), indexing="ij")
    a = (i * side + j).ravel()
    tris = np.stack([np.stack([a, a + 1, a + side], 1),
                     np.stack([a + 1, a + side + 1, a + side], 1)], 1).reshape(-1, 3)
    n = len(tris)
    tris = tris[np.argsort(np.arange(n) // 16 * 16 + rng.random(n) * 16)].astype(np.uint32)
    rgb = rng.integers(0, 1 << 24, side * side, dtype=np.uint32)
    return {"vertices": verts, "triangles": tris,
            "vertex_colors": rgb | np.uint32(0xFF000000)}


CASES = {"mesh": (_grid_mesh(SIDE), WRITE_FP | WRITE_INT, READ_FP | READ_INT),
         "points": ({"vertices": _grid_mesh(SIDE)["vertices"]}, WRITE_FP, READ_FP)}


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    require_native()  # the LZ4 emitter behind the device match search
    monkeypatch.setattr(chunked, "DEFAULT_LZ4_BLOCK", BLOCK)


def _mesh():
    return mc.make_mesh(2, device="cpu")


def _write(streams: dict, profile=None) -> bytes:
    return mc.compress_mesh(**streams, chunk_len=CHUNK, mesh=_mesh(), profile=profile)


def _bench_spans():
    """The benchmark's recorder, loaded from its file (it annotates every
    stage itself)."""
    spec = importlib.util.spec_from_file_location("bench_spans",
                                                  REPO / "benchmark" / "spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Spans()


def _tally_since(before: dict) -> dict:
    now = profiling.tally()
    return {k: (c - before.get(k, (0, 0))[0], b - before.get(k, (0, 0))[1])
            for k, (c, b) in now.items() if (c, b) != before.get(k, (0, 0))}


def _annotations(tmp_path, fn) -> dict:
    """Run ``fn`` under torch.profiler (CPU) and count the trace's
    user_annotation events by name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    counts: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_write_opens_its_spans_in_the_recorder(case):
    streams, want, _ = CASES[case]
    prof = profiling.StageTimer()
    _write(streams, prof)
    assert set(prof.stages) == want
    assert prof.stages["fp_assembly"].calls == 3
    assert prof.stages["archive_join"].calls == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_read_opens_its_spans_in_the_recorder(case):
    streams, _, want = CASES[case]
    blob = _write(streams)
    prof, stats = profiling.StageTimer(), {}
    out = mc.decompress_mesh(blob, _mesh(), route_stats=stats, profile=prof)
    assert set(prof.stages) == want
    if case == "mesh":  # both integer routes are covered
        assert stats["sharded_bp"] == 1 and stats["host_lz4"] == 1
    for name, arr in streams.items():
        assert np.array_equal(out[name].view(np.uint32), arr.view(np.uint32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_read_under_the_profiler_alone_annotates_its_spans(case, tmp_path):
    streams, _, want = CASES[case]
    blob = _write(streams)
    got = _annotations(tmp_path, lambda: mc.decompress_mesh(blob, _mesh()))
    assert set(got) == want


@pytest.mark.parametrize("recorder", ["none", "stage_timer", "benchmark_spans"])
def test_each_span_is_annotated_once(recorder, tmp_path):
    streams = CASES["mesh"][0]
    blob = _write(streams)
    make = {"none": lambda: None, "stage_timer": profiling.StageTimer,
            "benchmark_spans": _bench_spans}[recorder]
    before = profiling.tally()

    def run():
        _write(streams, make())
        mc.decompress_mesh(blob, _mesh(), profile=make())

    got = _annotations(tmp_path, run)
    calls = {k: c for k, (c, _) in _tally_since(before).items()
             if not k.startswith(TALLY_ONLY)}
    assert set(calls) == WRITE_FP | WRITE_INT | READ_FP | READ_INT
    assert got == calls


def test_with_tracing_off_no_span_annotates_or_waits(monkeypatch):
    streams = CASES["mesh"][0]
    entered, synced, waited = [], [], []
    real_rf = torch.profiler.record_function
    real_wait = profiling._synchronize
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or real_rf(*a, **k))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(a))
    monkeypatch.setattr(profiling, "_synchronize",
                        lambda s: waited.append(s) or real_wait(s))
    assert not profiling.tracing()
    blob = _write(streams)
    mc.decompress_mesh(blob, _mesh())
    assert entered == [] and synced == [] and waited == []
    # a recorder makes the same spans wait for their device
    _write(streams, profiling.StageTimer())
    assert waited and synced == []  # the CPU has nothing to wait for


def test_tracing_changes_no_archive_byte(tmp_path):
    streams = CASES["mesh"][0]
    blob = _write(streams)
    assert _write(streams, profiling.StageTimer()) == blob
    assert _write(streams, _bench_spans()) == blob
    traced = []
    _annotations(tmp_path, lambda: traced.append(_write(streams)))
    assert traced == [blob]


def test_the_tally_counts_eight_copied_bytes_per_searched_plane_byte():
    streams = CASES["mesh"][0]
    before = profiling.tally()
    _write(streams)
    got = _tally_since(before)
    searched = 0
    for name in ("triangles", "vertex_colors"):
        for plane in transpose.byte_planes(streams[name]):
            if np.any(plane != plane[0]) and len(plane) >= BLOCK:
                searched += len(plane) // BLOCK * BLOCK
    assert searched and got["lz4_d2h"][1] == 8 * searched
    raw = sum(a.nbytes for a in streams.values())
    assert got["compress_mesh"] == (1, raw)


def test_the_tally_counts_full_chunks_per_exponent_pair_and_route():
    blob = _write(CASES["mesh"][0])
    with recording(mc, "decode_plane_sharded") as calls:
        before = profiling.tally()
        mc.decompress_mesh(blob, _mesh())
        got = _tally_since(before)
    want: dict = {}
    words = 0
    for container, *_ in calls:
        hdr, sizes, off = chunked.parse_validated_framing(container)
        n_full = hdr.n_chunks - (1 if hdr.total % hdr.chunk_len else 0)
        starts = off + np.concatenate([[0], np.cumsum(sizes)])[:n_full]
        for info in np.frombuffer(container, np.uint8)[starts]:
            e1, e2 = fp_torch.exponents(int(info))
            route = "host" if (1 << e1) + (1 << e2) > chunked.DEVICE_TABLE_WORDS else "device"
            key = f"fp_chunks.{e1}_{e2}.{route}"
            want[key] = want.get(key, 0) + 1
        words += n_full * hdr.chunk_len
    assert len(calls) == 3 and "fp_chunks.14_18.host" in want
    assert {k: c for k, (c, _) in got.items() if k.startswith("fp_chunks.")} == want
    host = sum(n for k, n in want.items() if k.endswith(".host"))
    assert got["fp_host_chunks"][1] == host * CHUNK * 4
    assert got["fp_read_words"][1] == words * 4


class _Recorder:
    def __init__(self):
        self.seen = []

    def stage(self, name, nbytes=0, sync=None):
        self.seen.append((name, nbytes, sync))
        return contextlib.nullcontext()


def test_a_span_forwards_to_the_active_recorder_and_tallies():
    outer, inner = _Recorder(), _Recorder()
    before = profiling.tally()
    with profiling.recording(outer):
        with profiling.span("a", nbytes=3, sync="cpu"):
            pass
        with profiling.recording(None):  # None keeps the active recorder
            with profiling.span("b"):
                pass
        with pytest.raises(KeyError):
            with profiling.recording(inner):
                with profiling.span("c", nbytes=5):
                    raise KeyError("inside")
        with profiling.span("d"):
            pass
    assert not profiling.tracing()
    with profiling.span("e"):
        pass
    profiling.count("f", nbytes=7, calls=4)
    assert outer.seen == [("a", 3, "cpu"), ("b", 0, None), ("d", 0, None)]
    assert inner.seen == [("c", 5, None)]
    assert _tally_since(before) == {"a": (1, 3), "b": (1, 0), "c": (1, 5), "d": (1, 0),
                                    "e": (1, 0), "f": (4, 7)}
