"""BENCHMARK.json keeps to the contract's names and references, and the
harness finds every configuration, traffic mix and metric by its name."""

import json
import re

import pytest

from benchmark import harness
from conftest import REPO, copy_benchmark, shrink

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_names_and_units_keep_to_the_allowed_characters():
    names = ([m["name"] for m in METRICS] + [w["name"] for w in MANIFEST["workloads"]]
             + [c["name"] for c in MANIFEST["configs"]]
             + [w["traffic"] for w in MANIFEST["workloads"]]
             + [k for c in MANIFEST["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        got = [x["name"] for x in MANIFEST[group]]
        assert len(got) == len(set(got)), group
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(
        MANIFEST["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_layer_metric_moves_a_metric_its_cells_report(cell):
    e2e = {m["name"] for m in harness.cell_metrics(MANIFEST, cell, "end_to_end")}
    layers = harness.cell_metrics(MANIFEST, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    assert all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.load_reader(REPO / "benchmark", metric))


@pytest.mark.parametrize("kind,name", [("configs", w["config"]) for w in MANIFEST["workloads"]]
                         + [("traffic", w["traffic"]) for w in MANIFEST["workloads"]])
def test_every_configuration_and_mix_is_a_file_of_its_name(kind, name):
    data = harness.load_json(REPO / "benchmark" / kind / f"{name}.json")
    assert data is not None


def test_configuration_files_name_what_they_reduce():
    """A reduced key is a top-level count, or ``<mesh>.<count>`` of one of
    several meshes; each differs from its published count, and no other
    count does."""
    for c in MANIFEST["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        group = {m["name"]: m for m in data["meshes"]} if "meshes" in data else {None: data}
        changed = {key if name is None else f"{name}.{key}"
                   for name, mesh in group.items() for key in mesh["published"]
                   if mesh[key] != mesh["published"][key]}
        assert changed == set(c["reduced"])


def test_a_new_configuration_mix_and_metric_are_picked_up_with_no_edit(tmp_path):
    """Add a file of each kind and a cell in a copy: the harness runs the
    new cell and reports the new metric, and no file that was there
    changes."""
    root = copy_benchmark(tmp_path)
    shrink(root)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "vellum.json").read_text())
    config.update(name="tiny", grid_side=24, vertices=576, triangles=2 * 23 ** 2)
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "mesh.json").read_text())
    traffic.update(streams=["vertices", "vertex_colors"], pool=3)
    (bench / "traffic" / "colours.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "writes_per_s.py").write_text(
        "def read(run):\n    return len(run.of('write')) / run.window_s\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny", "source": "https://example.org",
                                "file": "benchmark/configs/tiny.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "tiny.colours", "config": "tiny",
                                  "traffic": "colours", "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({"name": "writes_per_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.1, "source": "host_clock",
                                   "workloads": ["tiny.colours"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    res = harness.run_cell(root, "tiny.colours", 5, 0.5, False, device="cpu")
    assert res["correct"] and res["metrics"]["writes_per_s"]["value"] > 0
    assert {"ratio", "setup_s"} <= set(res["metrics"])
    assert all(p.read_bytes() == b for p, b in before.items())
