"""On the card: the command runs a cell end to end and prints a correct
result with the card's device fields."""

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["vellum.mesh", "assets.mesh"])
def test_the_command_runs_a_cell_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                        "--seed", "4000000001", "--seconds", "2", "--trace", str(trace)],
                       cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
