"""Fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests -q``). Tests marked ``card`` need an
NVIDIA card and skip without one; whether there is one is decided inside
the fixture, never while a module is imported."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_SIDES = {"lucy": 48, "vellum": 40}


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
        config.update(grid_side=side, vertices=side * side, triangles=2 * (side - 1) ** 2)
        path.write_text(json.dumps(config))


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
