"""The fixed-work scaling run of the port (``python -m
trico_tpu_torch.tools.mp_scaling``) on the CPU, over gloo.

The tool runs once at 30,000 vertices on a mesh of four CPU shards split
over one and two processes, with ``jax`` and ``trico_tpu`` blocked in the
parent and in every rank (a ``sitecustomize`` on the ranks' path, which
each process that loads it also records). Its report must have every
field, the same archive in both configurations, and that archive must be
``trico_tpu.parallel.mesh_codec.compress_mesh``'s on JAX's 8 CPU devices
for the same data (``scripts/mp_scaling.py``'s formula). Tolerance: every
archive byte equal. A rank that fails makes the run exit 1, and without
``--device`` the tool needs a card.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import trico_tpu.chunked as jc
from trico_tpu.parallel import mesh_codec as jmc
from trico_tpu_torch.tools import mp_scaling

REPO = Path(__file__).resolve().parents[1]
N_VERTS = 30_000
BLOCK = """import os, sys
sys.modules["jax"] = None
sys.modules["trico_tpu"] = None
open(os.path.join({marks!r}, str(os.getpid())), "w").write(" ".join(sys.argv))
"""
ROW_KEYS = {"n_processes", "shards_per_proc", "wall_s", "cpu_s_total",
            "gather_s", "gather_frac", "stage_seconds", "archive_bytes",
            "archive_sha256", "archive_bytes_by_rank", "kernel_launches",
            "process_s", "efficiency_vs_1proc"}


def blocked_env(tmp_path: Path) -> tuple[dict, Path]:
    """An environment whose Python processes cannot import JAX or
    trico_tpu, and the directory where each records its pid."""
    site, marks = tmp_path / "site", tmp_path / "marks"
    site.mkdir()
    marks.mkdir()
    (site / "sitecustomize.py").write_text(BLOCK.format(marks=str(marks)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), str(REPO)]))
    return env, marks


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_scaling")
    env, marks = blocked_env(tmp)
    out = tmp / "report.json"
    res = subprocess.run([sys.executable, "-m", "trico_tpu_torch.tools.mp_scaling",
                          "--device", "cpu", "--verts", str(N_VERTS), "--procs", "1,2",
                          "--shards", "4", "--json", str(out)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    return res, out, marks


def test_runs_with_jax_blocked_in_every_rank(report):
    res, out, marks = report
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == json.loads(out.read_text())
    argvs = [p.read_text() for p in marks.iterdir()]
    assert len(argvs) == 4  # the parent, one rank, then two
    assert sum("--worker" in a for a in argvs) == 3


def test_report_has_every_field(report):
    result = json.loads(report[1].read_text())
    assert result["ok"] and result["exact"] and result["backend"] == "cpu"
    assert result["device"] == {"name": "cpu", "power_limit": None}
    rows = result["configs"]
    assert [r["n_processes"] for r in rows] == [1, 2]
    assert [r["shards_per_proc"] for r in rows] == [4, 2]
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r["wall_s"] > 0 and r["cpu_s_total"] > 0
        assert set(r["stage_seconds"]) >= {"fp_device_encode", "fp_gather",
                                           "fp_assembly"}
        assert r["gather_s"] == r["stage_seconds"]["fp_gather"]
        assert r["gather_frac"] == r["gather_s"] / r["wall_s"]
        assert r["efficiency_vs_1proc"] == rows[0]["wall_s"] / r["wall_s"]
        assert r["kernel_launches"] == dict.fromkeys(r["kernel_launches"], 0)  # CPU
    assert rows[0]["efficiency_vs_1proc"] == 1.0
    launches = result["decode_kernel_launches"]
    assert launches == dict.fromkeys(launches, 0) and len(launches) == 9  # CPU


def test_bytes_identical_across_configurations(report):
    result = json.loads(report[1].read_text())
    rows = result["configs"]
    assert result["byte_identical_across_configs"]
    assert rows[1]["archive_bytes_by_rank"] == [rows[0]["archive_bytes"]] * 2
    assert rows[0]["archive_sha256"] == rows[1]["archive_sha256"]


def test_archive_matches_trico_tpu(report, monkeypatch):
    """The same data as scripts/mp_scaling.py:56-59, through trico_tpu's
    compress_mesh on JAX's 8 CPU devices as a device host runs it."""
    monkeypatch.setattr(jc, "_tpu_available", lambda: True)
    rng = np.random.default_rng(7)
    verts = (np.sin(np.linspace(0, 600 * np.pi, 3 * N_VERTS)) * 8
             + rng.normal(0, 1e-3, 3 * N_VERTS).cumsum()
             ).astype(np.float32).reshape(N_VERTS, 3)
    assert mp_scaling.scaling_verts(N_VERTS).tobytes() == verts.tobytes()
    want = jmc.compress_mesh(verts, chunk_len=4096,
                             mesh=jmc.make_mesh(min(8, len(jax.devices()))))
    row = json.loads(report[1].read_text())["configs"][0]
    assert (row["archive_bytes"], row["archive_sha256"]) == (
        len(want), hashlib.sha256(want).hexdigest())


def test_a_failed_rank_exits_1(monkeypatch, capsys):
    """The two-process configuration's rank 0 cannot listen on its port
    (another socket holds it): the run exits 1 at once, with rank 1 killed,
    not left waiting for its group."""
    with socket.socket() as held:
        held.bind(("localhost", 0))
        held.listen()
        monkeypatch.setattr(mp_scaling, "free_port", lambda: held.getsockname()[1])
        t0 = time.monotonic()
        rc = mp_scaling.main(["--device", "cpu", "--verts", "3000", "--procs",
                              "1,2", "--shards", "2"])
    assert rc == 1
    assert time.monotonic() - t0 < 120
    assert "2 processes: rank 0 exited 1" in capsys.readouterr().err


def test_run_ranks_kills_the_others_on_a_failure():
    t0 = time.monotonic()
    (rc0, text0), (rc1, _) = mp_scaling.run_ranks(
        [[sys.executable, "-c", "print('bye'); raise SystemExit(3)"],
         [sys.executable, "-c", "import time; time.sleep(300)"]])
    assert time.monotonic() - t0 < 60
    assert (rc0, text0.strip(), rc1) == (3, "bye", -9)


def test_configurations_are_checked():
    with pytest.raises(ValueError, match="must be 1"):
        mp_scaling.run(procs=(2, 4), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        mp_scaling.run(procs=(1, 3), shards=4, n_verts=100, device="cpu")


def test_runs_on_the_card_unless_asked(tmp_path):
    """Without ``--device`` the shards are on the card: with no card the
    tool exits non-zero, starts no rank and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a card")
    env, marks = blocked_env(tmp_path)
    res = subprocess.run([sys.executable, "-m", "trico_tpu_torch.tools.mp_scaling",
                          "--verts", "1000"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr and res.stdout == ""
    assert len(list(marks.iterdir())) == 1  # the parent alone
