"""The generator makes each stream in the dtype the configuration declares,
and refuses a stream or a dtype it does not make rather than make another."""

import json

import pytest

from benchmark import meshgen
from conftest import REPO

VELLUM = json.loads((REPO / "benchmark" / "configs" / "vellum.json").read_text())


def tiny(streams: dict, side: int = 12) -> dict:
    return dict(VELLUM, name="tiny", grid_side=side, vertices=side * side,
                triangles=2 * (side - 1) ** 2, streams=streams)


def test_the_configurations_declare_what_they_run():
    for name in ("lucy", "vellum"):
        config = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
        config.update(grid_side=8, vertices=64, triangles=98)
        got = meshgen.make_streams(config, ["all"], 3, 1)
        assert set(got) == set(config["streams"])
        for stream, spec in config["streams"].items():
            assert got[stream].dtype == spec.split()[0]


@pytest.mark.parametrize("streams", [
    {"vertices": "float64 (V, 3)"},
    {"vertices": "float32 (V, 3)", "triangles": "uint64 (T, 3)"},
    {"vertices": "float32 (V, 3)", "triangles": "int32 (T, 3)"},
    {"vertices": "float32 (V, 3)", "vertex_normals": "float32 (V, 3)"},
    {"vertices": "float32 (V, 3)", "vertex_colors": "uint64 RGBA16 (V,)"},
], ids=["f64-vertices", "u64-triangles", "signed-triangles", "normals", "u64-colours"])
def test_a_stream_it_cannot_make_is_refused(streams):
    with pytest.raises(ValueError, match="cannot make"):
        meshgen.make_streams(tiny(streams), ["all"], 5, 0)


def test_a_stream_the_configuration_lacks_is_refused():
    with pytest.raises(ValueError, match="has no stream"):
        meshgen.make_streams(tiny({"vertices": "float32 (V, 3)"}), ["triangles"], 5, 0)
