"""The generator makes each stream in the dtype the configuration declares,
and refuses a stream or a dtype it does not make rather than make another;
its reader of a binary STL gives the benchmark's copy of the Bunny as the
configuration states it."""

import hashlib
import json

import numpy as np
import pytest

from benchmark import meshgen
from conftest import REPO, grid

VELLUM = json.loads((REPO / "benchmark" / "configs" / "vellum.json").read_text())
ASSETS = json.loads((REPO / "benchmark" / "configs" / "assets.json").read_text())
BUNNY = next(m for m in ASSETS["meshes"] if "file" in m)


def tiny(streams: dict, side: int = 12) -> dict:
    return dict(VELLUM, name="tiny", grid_side=side, vertices=side * side,
                triangles=2 * (side - 1) ** 2, streams=streams)


@pytest.mark.parametrize("name", ["lucy", "vellum", "assets"])
def test_the_configurations_declare_what_they_run(name):
    config = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    for mesh in meshgen.meshes(config):
        if "file" not in mesh:
            grid(mesh, 8)
    for k in range(len(meshgen.meshes(config))):
        got = meshgen.make_streams(config, ["all"], 3, k)
        assert set(got) == set(config["streams"])
        for stream, spec in config["streams"].items():
            assert got[stream].dtype == spec.split()[0]


@pytest.mark.parametrize("streams", [
    {"vertices": "float32 (V, 3)", "triangles": "int32 (T, 3)"},
    {"vertices": "float32 (V, 3)", "vertex_colors": "uint64 RGBA16 (V,)"},
], ids=["signed-triangles", "u64-colours"])
def test_a_stream_it_cannot_make_is_refused(streams):
    with pytest.raises(ValueError, match="cannot make"):
        meshgen.make_streams(tiny(streams), ["all"], 5, 0)


def test_float64_vertices_of_a_file_are_refused():
    config = dict(ASSETS, streams={"vertices": "float64 (V, 3)"})
    with pytest.raises(ValueError, match="cannot make"):
        meshgen.make_streams(config, ["all"], 5, 1)


@pytest.mark.parametrize("streams", [
    {"vertices": "float64 (V, 3)"},
    {"vertices": "float32 (V, 3)", "triangles": "uint64 (T, 3)"},
    {"vertices": "float32 (V, 3)", "vertex_normals": "float32 (V, 3)"},
], ids=["f64-vertices", "u64-triangles", "normals"])
def test_a_stream_is_made_in_the_declared_dtype(streams):
    """Float64 vertices are the float32 surface computed in float64 (the
    same walk, not widened), uint64 triangles the same indices, and
    normals each vertex over its length."""
    got = meshgen.make_streams(tiny(streams), ["all"], 5, 0)
    base = meshgen.make_streams(tiny({"vertices": "float32 (V, 3)",
                                      "triangles": "uint32 (T, 3)"}), ["all"], 5, 0)
    for stream, spec in streams.items():
        assert got[stream].dtype == spec.split()[0]
        assert got[stream].shape == base["triangles" if stream == "triangles" else "vertices"].shape
    v = got["vertices"]
    if v.dtype == np.float64:
        np.testing.assert_allclose(v, base["vertices"], rtol=1e-5)
        assert not np.array_equal(v, base["vertices"].astype(np.float64))
    else:
        assert np.array_equal(v, base["vertices"])
    if "triangles" in streams:
        assert np.array_equal(got["triangles"], base["triangles"].astype(np.uint64))
    if "vertex_normals" in streams:
        n = got["vertex_normals"]
        want = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
        assert np.array_equal(n, want)
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1, rtol=1e-6)


def test_a_stream_the_configuration_lacks_is_refused():
    with pytest.raises(ValueError, match="has no stream"):
        meshgen.make_streams(tiny({"vertices": "float32 (V, 3)"}), ["triangles"], 5, 0)


def test_the_stl_reader_gives_the_bunny_the_configuration_states():
    """The benchmark's copy of the scan has the configuration's sha256; the
    reader gives its counts (34,834 vertices, not the README's 35,947),
    distinct vertices in (x, y, z) order, and triangles whose corners are
    the file's, exactly."""
    path = meshgen.HERE / BUNNY["file"]
    raw = path.read_bytes()
    assert hashlib.sha256(raw).hexdigest() == BUNNY["sha256"]
    verts, tris = meshgen.read_stl(path)
    assert (len(verts), len(tris)) == (BUNNY["vertices"], BUNNY["triangles"]) == (34834, 69451)
    assert BUNNY["published"] == {"vertices": 35947, "triangles": 69451}
    assert verts.dtype == np.float32 and tris.dtype == np.uint32
    n = len(tris)
    corners = np.frombuffer(raw, np.uint8, 50 * n, 84).reshape(n, 50)[:, 12:48]
    assert np.array_equal(verts[tris].reshape(n, 9), np.ascontiguousarray(corners).view("<f4"))
    order = np.lexsort((verts[:, 2], verts[:, 1], verts[:, 0]))
    assert np.array_equal(order, np.arange(len(verts)))
    assert len(np.unique(verts, axis=0)) == len(verts)
    assert np.array_equal(meshgen.file_mesh(BUNNY, meshgen.HERE)[0], verts)


def test_a_file_that_is_not_the_stated_one_is_refused(tmp_path):
    (tmp_path / "data").mkdir()
    path = tmp_path / BUNNY["file"]
    raw = (meshgen.HERE / BUNNY["file"]).read_bytes()
    path.write_bytes(raw[:-50])
    with pytest.raises(ValueError, match="bytes for"):
        meshgen.read_stl(path)
    with pytest.raises(ValueError, match="sha256"):
        meshgen.file_mesh(BUNNY, tmp_path)
