"""Each stream of a mesh is a span of its own: ``compress_mesh`` opens
``write.<keyword>`` once for every stream it is given and tallies the bytes
the stream added to the archive under ``archive.<keyword>``;
``decompress_mesh`` opens ``read.<name>`` once for every stream it returns.
The per-stream counts and the 8-byte file header add up to the archive,
and no recorder changes an archive byte: the archive is
``ArchiveWriter(layout="tpu")``'s for 1, 2 and 3 shards, and the
benchmark's NumPy reference reads every stream back word for word.

The streams are the benchmark generator's (``benchmark/meshgen.py``), as a
``lucy_attrs`` cell makes them, on small grids of CPU shards."""

import json

import numpy as np
import pytest

from benchmark import meshgen
from benchmark.reference import decode_archive
from conftest import REPO
from trico_tpu_torch import ArchiveWriter, profiling
from trico_tpu_torch.parallel import mesh_codec as mc

CHUNK = 256
SIDE = 40  # 1600 vertices: six full chunks of 256 a plane and a tail
ATTRS = json.loads((REPO / "benchmark" / "configs" / "lucy_attrs.json").read_text())
FILE_HEADER = 8  # magic and version


def attrs_streams(side: int, seed: int = 2**40 + 7) -> dict:
    """The four streams of ``lucy_attrs`` on a grid of ``side``."""
    config = dict(ATTRS, grid_side=side, vertices=side * side,
                  triangles=2 * (side - 1) ** 2)
    return meshgen.make_streams(config, ["all"], seed, 0)


def _cases() -> dict:
    s = attrs_streams(SIDE)
    n = len(s["vertices"])
    rng = np.random.default_rng(11)
    f64, _ = meshgen.scan_surface(SIDE, meshgen.rng(5, 0), np.float64)
    every = dict(
        s, triangle_normals=s["vertex_normals"][: len(s["triangles"]) // 2],
        attributes_uint16=rng.integers(0, 1 << 16, n).astype(np.uint16),
        uv_per_triangle=rng.random((300, 6)).astype(np.float32),
        uv_per_vertex=s["vertex_normals"][:, :2].copy(),
        attributes_uint8=rng.integers(0, 256, n).astype(np.uint8),
        attributes_uint32=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        attributes_uint64=rng.integers(0, 1 << 63, n, dtype=np.uint64))
    return {
        "vertices": {"vertices": s["vertices"]},
        "triangles": {k: s[k] for k in ("vertices", "triangles")},
        "normals_colors": s,
        "normals_alone": {k: s[k] for k in ("vertices", "vertex_normals")},
        "f64_vertices": {"vertices": f64, "triangles": s["triangles"]},
        "u64_triangles": {"vertices": s["vertices"],
                          "triangles": s["triangles"].astype(np.uint64)},
        "every_stream": every,
    }


CASES = _cases()
# the key decompress_mesh returns a stream under, where it is not the
# keyword compress_mesh took it by
READ_NAME = {"attributes_uint8": "attribute_uint8", "attributes_uint16": "attribute_uint16",
             "attributes_uint32": "attribute_uint32", "attributes_uint64": "attribute_uint64"}


def _write(streams: dict, profile=None, shards: int = 2, **kw) -> bytes:
    return mc.compress_mesh(**streams, chunk_len=kw.pop("chunk_len", CHUNK),
                            mesh=mc.make_mesh(shards, device="cpu"), profile=profile, **kw)


def _tally_since(before: dict) -> dict:
    now = profiling.tally()
    return {k: (c - before.get(k, (0, 0))[0], b - before.get(k, (0, 0))[1])
            for k, (c, b) in now.items() if (c, b) != before.get(k, (0, 0))}


def _of(stages_or_tally: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in stages_or_tally.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_write_opens_one_span_per_stream_with_its_raw_bytes(case):
    streams = CASES[case]
    prof = profiling.StageTimer()
    _write(streams, prof)
    got = _of(prof.stages, "write.")
    assert set(got) == set(streams)
    for name, stage in got.items():
        assert (stage.calls, stage.nbytes) == (1, streams[name].nbytes), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_streams_archive_bytes_and_the_file_header_add_up_to_the_archive(case):
    streams = CASES[case]
    before = profiling.tally()
    blob = _write(streams)
    got = _tally_since(before)
    archive = _of(got, "archive.")
    assert set(archive) == set(streams)
    assert all(calls == 1 and nbytes > 5 for calls, nbytes in archive.values())
    assert FILE_HEADER + sum(nbytes for _, nbytes in archive.values()) == len(blob)
    assert got["compress_mesh"] == (1, sum(a.nbytes for a in streams.values()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_read_opens_one_span_per_stream_it_returns(case):
    streams = CASES[case]
    blob = _write(streams)
    prof = profiling.StageTimer()
    out = mc.decompress_mesh(blob, mc.make_mesh(2, device="cpu"), profile=prof)
    assert set(out) == {READ_NAME.get(k, k) for k in streams}
    got = _of(prof.stages, "read.")
    assert set(got) == set(out)
    for name, stage in got.items():
        assert (stage.calls, stage.nbytes) == (1, out[name].nbytes), name
    for name, want in streams.items():
        got_words = out[READ_NAME.get(name, name)]
        assert np.array_equal(got_words.reshape(-1).view(np.uint8),
                              np.ascontiguousarray(want).reshape(-1).view(np.uint8)), name


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_a_recorder_changes_no_byte_and_the_archive_is_the_writers(shards):
    streams = attrs_streams(96)  # two full chunks of 4096 a plane and a tail
    blob = _write(streams, shards=shards, chunk_len=4096)
    assert _write(streams, profiling.StageTimer(), shards=shards, chunk_len=4096) == blob
    w = ArchiveWriter(chunk_len=4096, layout="tpu", device="cpu")
    w.write_vertices(streams["vertices"])
    w.write_triangles(streams["triangles"])
    w.write_vertex_normals(streams["vertex_normals"])
    w.write_vertex_colors(streams["vertex_colors"])
    assert blob == w.tobytes()


@pytest.mark.parametrize("optimize", [True, "fast"], ids=["optimize", "fast"])
def test_the_plain_reference_reads_every_stream_back_word_for_word(optimize):
    streams = attrs_streams(96)
    blob = _write(streams, chunk_len=4096, optimize=optimize)
    out = decode_archive(blob)
    assert set(out) == set(streams)
    for name, want in streams.items():
        words = np.ascontiguousarray(want).view(out[name].dtype)
        assert out[name].shape == words.shape and np.array_equal(out[name], words), name
