"""The ``lucy_attrs`` configuration and its cell ``lucy_attrs.mesh``: the
generator makes its four streams in their declared dtypes, the vertices and
triangles of ``lucy``; the six per-stream readers read the program's spans
and counts on a hand-built run, and None where the program has none of
them; a traced tiny run of the cell reports all six, the ratios the same
for a seed; and the roofline's byte count takes in the normals' float
containers.

``conftest.tiny_root`` cuts the configurations named in
``conftest.TINY_SIDES``; this module adds ``lucy_attrs`` to them when it is
collected, so that the tests that run every cell on the tiny copy run this
one at a tiny size too."""

import json

import numpy as np
import pytest

import conftest
from benchmark import harness, meshgen, roofline
from benchmark.devtrace import Trace
from benchmark.reference.archive import streams
from benchmark.spans import Spans
from conftest import REPO, copy_benchmark, grid, shrink

conftest.TINY_SIDES.setdefault("lucy_attrs", 48)

CELL = "lucy_attrs.mesh"
ATTRS = json.loads((REPO / "benchmark" / "configs" / "lucy_attrs.json").read_text())
LUCY = json.loads((REPO / "benchmark" / "configs" / "lucy.json").read_text())
READERS = ("normals_write_ms.write", "normals_read_ms.read", "colors_write_ms.write",
           "colors_read_ms.read", "normals_ratio", "colors_ratio")
SEED = 2**33 + 17


def reader(name):
    return harness.load_reader(REPO / "benchmark", name)


def small(config: dict, side: int = 40) -> dict:
    config = dict(config)
    grid(config, side)
    return config


def test_the_configuration_is_lucy_with_normals_and_colours():
    assert {k: ATTRS[k] for k in ("published", "vertices", "triangles", "grid_side")} == {
        k: LUCY[k] for k in ("published", "vertices", "triangles", "grid_side")}
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in manifest["configs"] if c["name"] == "lucy_attrs")
    assert entry["source"] == ATTRS["source"] and len(entry["source"]) <= 200
    cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("lucy_attrs", "mesh", 1)
    raw = ATTRS["vertices"] * (12 + 12 + 4) + ATTRS["triangles"] * 12
    assert raw == 729_121_564


@pytest.mark.parametrize("k", [0, 1])
def test_it_makes_its_four_streams_and_lucys_geometry(k):
    got = meshgen.make_streams(small(ATTRS), ["all"], SEED, k)
    assert list(got) == list(ATTRS["streams"])
    for stream, spec in ATTRS["streams"].items():
        assert got[stream].dtype == spec.split()[0]
    n = len(got["vertices"])
    assert got["vertex_normals"].shape == (n, 3) and got["vertex_colors"].shape == (n,)
    assert np.allclose(np.linalg.norm(got["vertex_normals"], axis=1), 1, atol=1e-6)
    lucy = meshgen.make_streams(small(LUCY), ["all"], SEED, k)
    for stream in ("vertices", "triangles"):
        assert np.array_equal(got[stream].view(np.uint32), lucy[stream].view(np.uint32))


def _archive(seed=SEED, k=0) -> tuple[bytes, dict]:
    from trico_tpu_torch.parallel import mesh_codec
    s = meshgen.make_streams(small(ATTRS), ["all"], seed, k)
    return mesh_codec.compress_mesh(**s, chunk_len=256,
                                    mesh=mesh_codec.make_mesh(1, device="cpu")), s


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def hand_run() -> harness.Run:
    """Two writes (pool entries 0 and 1) and two reads. The recorder holds
    write.vertex_normals 30 + 50 ms and write.vertex_colors 20 + 20 ms of
    the writes; the trace holds read.vertex_normals 10 + 30 ms and
    read.vertex_colors 6 + 4 ms of the reads (microseconds)."""
    blobs = [_archive(k=k)[0] for k in (0, 1)]
    run = harness.Run({}, {}, {}, "cpu")
    run.requests = [harness.Request("write", k, 0.0, 1.0, 1, b) for k, b in enumerate(blobs)]
    run.requests += [harness.Request("read", k, 1.0, 2.0, 1, b) for k, b in enumerate(blobs)]
    run.spans = Spans()
    run.spans.records = [("write.vertex_normals", "write", 0.0, 0.03),
                         ("write.vertex_normals", "write", 1.0, 1.05),
                         ("write.vertex_colors", "write", 0.1, 0.12),
                         ("write.vertex_colors", "write", 1.1, 1.12),
                         ("write.vertex_normals", "read", 5.0, 9.0)]  # of no write
    run.trace = Trace([_ann("read.vertex_normals", 0, 10_000),
                       _ann("read.vertex_normals", 100_000, 30_000),
                       _ann("read.vertex_colors", 20_000, 6_000),
                       _ann("read.vertex_colors", 200_000, 4_000)])
    return run


def _stream_bytes(blob: bytes, stream_type: int) -> tuple[int, int]:
    """(raw, archive) bytes of a normals (9) or colours (13) stream: its
    header, and each substream's size and container."""
    for st, count, subs in streams(blob):
        if st == stream_type:
            size = 5 + sum(4 + 14 + 4 * len(c.chunks) + sum(map(len, c.chunks)) for c in subs)
            return count * (12 if st == 9 else 4), size
    raise AssertionError(f"no stream {stream_type}")


def test_the_readers_read_the_spans_and_counts_of_a_hand_built_run():
    from trico_tpu_torch.parallel import mesh_codec
    # the program has opened and counted its per-stream spans
    mesh_codec.decompress_mesh(_archive()[0], mesh_codec.make_mesh(1, device="cpu"))
    run = hand_run()
    got = {name: reader(name)(run) for name in READERS}
    assert got["normals_write_ms.write"] == pytest.approx(40.0)
    assert got["colors_write_ms.write"] == pytest.approx(20.0)
    assert got["normals_read_ms.read"] == pytest.approx(20.0)
    assert got["colors_read_ms.read"] == pytest.approx(5.0)
    for name, st in (("normals_ratio", 9), ("colors_ratio", 13)):
        parts = [_stream_bytes(r.archive, st) for r in run.of("write")]
        assert got[name] == sum(r for r, _ in parts) / sum(a for _, a in parts)
        assert got[name] > 1


def test_the_archive_count_is_what_the_ratio_reads():
    from trico_tpu_torch import profiling
    before = profiling.tally()
    blob, s = _archive(k=1)
    after = profiling.tally()
    counted = {k: after[k][1] - before.get(k, (0, 0))[1] for k in after
               if k.startswith(("archive.", "write."))}
    assert counted["write.vertex_normals"] == s["vertex_normals"].nbytes
    assert (s["vertex_normals"].nbytes, counted["archive.vertex_normals"]) == _stream_bytes(blob, 9)
    assert (s["vertex_colors"].nbytes, counted["archive.vertex_colors"]) == _stream_bytes(blob, 13)


def test_the_readers_give_none_where_the_program_has_no_per_stream_spans(monkeypatch):
    from trico_tpu_torch import profiling
    run = hand_run()
    real = profiling.tally
    monkeypatch.setattr(profiling, "tally", lambda: {
        k: v for k, v in real().items() if not k.startswith(("write.", "read.", "archive."))})
    assert {name: reader(name)(run) for name in READERS} == dict.fromkeys(READERS)
    monkeypatch.delattr(profiling, "tally")
    assert {name: reader(name)(run) for name in READERS} == dict.fromkeys(READERS)


@pytest.fixture
def root(tmp_path):
    root = copy_benchmark(tmp_path)
    shrink(root, {"lucy_attrs": 48})
    return root


def test_a_traced_tiny_run_reports_the_six_and_the_ratios_repeat(root):
    a = harness.run_cell(root, CELL, SEED, 0.3, True, device="cpu")
    b = harness.run_cell(root, CELL, SEED, 0.6, True, device="cpu")
    for res in (a, b):
        assert res["correct"] and res["failed"] == 0
        assert set(READERS) <= set(res["metrics"])
        assert all(res["metrics"][n]["value"] > 0 for n in READERS)
    for name in ("normals_ratio", "colors_ratio"):
        assert a["metrics"][name]["value"] == b["metrics"][name]["value"], name


def test_a_tiny_run_without_per_stream_spans_reports_none_of_them(root, monkeypatch):
    from trico_tpu_torch import profiling
    real = profiling.tally
    monkeypatch.setattr(profiling, "tally", lambda: {
        k: v for k, v in real().items() if not k.startswith(("write.", "read.", "archive."))})
    res = harness.run_cell(root, CELL, SEED, 0.3, True, device="cpu")
    assert res["correct"] and res["failed"] == 0
    assert not set(READERS) & set(res["metrics"])


def test_the_roofline_counts_the_normals_full_chunks():
    blob, s = _archive()
    without = _archive_without_normals(s)
    want = 0
    for st, _, subs in streams(blob):
        if st != 9:
            continue
        for c in subs:
            want += sum(n * 4 + len(p) for p, n in zip(c.chunks, c.counts())
                        if n == c.chunk_len)
    assert want > 0
    assert roofline.fp_full_chunk_bytes(blob) == roofline.fp_full_chunk_bytes(without) + want


def _archive_without_normals(s: dict) -> bytes:
    from trico_tpu_torch.parallel import mesh_codec
    rest = {k: v for k, v in s.items() if k != "vertex_normals"}
    return mesh_codec.compress_mesh(**rest, chunk_len=256,
                                    mesh=mesh_codec.make_mesh(1, device="cpu"))
