"""Fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests -q``). Tests marked ``card`` need an
NVIDIA card and skip without one; whether there is one is decided inside
the fixture, never while a module is imported."""

import hashlib
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# a configuration's grid side, or for one of several meshes each grid
# mesh's side and the triangles kept of a mesh read from a file
TINY_SIDES = {"lucy": 48, "vellum": 40,
              "assets": {"bunny": 3000, "armadillo": 24, "dragon": 32, "happy_buddha": 40}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")


def shrink(root: Path, sides=TINY_SIDES) -> None:
    """Cut the configurations of a copy of the benchmark to tiny grids."""
    for name, side in sides.items():
        path = root / "benchmark" / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        if isinstance(side, dict):
            for mesh in config["meshes"]:
                if "file" in mesh:
                    cut_stl(root / "benchmark", mesh, side[mesh["name"]])
                else:
                    grid(mesh, side[mesh["name"]])
        else:
            grid(config, side)
        path.write_text(json.dumps(config))


def grid(mesh: dict, side: int) -> None:
    mesh.update(grid_side=side, vertices=side * side, triangles=2 * (side - 1) ** 2)


def cut_stl(bench: Path, mesh: dict, triangles: int) -> None:
    """Keep the first ``triangles`` of a copy's STL, and name the cut file's
    sha256 and counts in ``mesh``."""
    from benchmark import meshgen
    path = bench / mesh["file"]
    raw = path.read_bytes()
    path.write_bytes(raw[:80] + triangles.to_bytes(4, "little") + raw[84:84 + 50 * triangles])
    verts, _ = meshgen.read_stl(path)
    mesh.update(sha256=hashlib.sha256(path.read_bytes()).hexdigest(),
                vertices=len(verts), triangles=triangles)


def copy_benchmark(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's folder, alone, under ``dest``."""
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = copy_benchmark(tmp_path_factory.mktemp("tiny"))
    shrink(root)
    return root
