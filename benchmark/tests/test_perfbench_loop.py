"""The harness's closed loop runs every cell on CPU shards at tiny sizes
through its internal entry, traced and not; the command itself refuses to
run without a card, and in a folder without the program; and nothing the
run loads is JAX or the JAX package."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, latency
from conftest import REPO, copy_benchmark

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_of_every_cell_is_correct(tiny_root, cell, trace, capsys):
    res = harness.run_cell(tiny_root, cell, 2**31 + 11, 0.3, trace, device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    section = "per_layer" if trace else "end_to_end"
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    names = {m["name"] for m in harness.cell_metrics(manifest, cell, section)}
    # the device's metrics read nothing on the CPU; the spans' do; a p95
    # reads nothing under latency.LEAST requests of its kind
    assert set(res["metrics"]) <= names
    reads = res["checks"]["reads_checked_whole"]["strided"]
    if res["attempted"] - reads < latency.LEAST:
        names.discard("write_p95_ms")
    if reads < latency.LEAST:
        names.discard("read_p95_ms")
    if not trace:
        assert set(res["metrics"]) == names
    else:
        spans = ("_ms.write", "_ms.read", "_MBps", "p95_ms")
        assert {n for n in names if n.endswith(spans)} <= set(res["metrics"])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == res
    assert list(res)[-1] == "checks"
    assert 0 <= res["setup_build_s"] <= res["metrics"].get("setup_s", {"value": 1e9})["value"]
    assert res["checks"]["archives_checked"]["value"] >= 2  # every pool entry's archive
    assert out.err.strip().splitlines()[-1].startswith("check requests_failed")


def test_the_same_seed_makes_the_same_inputs_and_archives(tiny_root):
    a = harness.run_cell(tiny_root, "vellum.mesh", 2**33 + 5, 0.2, False, device="cpu")
    b = harness.run_cell(tiny_root, "vellum.mesh", 2**33 + 5, 0.2, False, device="cpu")
    assert a["metrics"]["ratio"] == b["metrics"]["ratio"]


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_the_command_exits_without_a_result_where_there_is_no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(["--workload", "lucy.mesh", "--seed", "1", "--seconds", "1", "--trace", "0"], REPO)
    assert p.returncode != 0 and "{" not in p.stdout


def test_the_command_exits_without_a_result_in_a_folder_without_the_program(tmp_path):
    root = copy_benchmark(tmp_path)
    p = _run(["--workload", "lucy.mesh", "--seed", "1", "--seconds", "1", "--trace", "0"], root)
    assert p.returncode != 0 and "{" not in p.stdout


REHEARSAL = r"""
import sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from benchmark import harness
root = Path({root!r})
for cell in {cells!r}:
    harness.run_cell(root, cell, 7, 0.2, cell.endswith("mesh"), device="cpu")
print("MODULES", " ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_rehearsal_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = REHEARSAL.format(repo=str(REPO), root=str(tiny_root), cells=CELLS)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(p.stdout.split("MODULES", 1)[1].split())
    assert "trico_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
