"""The port's mesh codec across two OS processes: the counterpart of
tests/test_multiprocess.py.

Two ranks of ``python -m trico_tpu_torch.parallel.mp_worker`` join one
``torch.distributed`` process group over gloo on localhost, two CPU shards
each (a mesh of four shards), with ``jax`` and ``trico_tpu`` blocked in
both. Both ranks' archives must be the same bytes, equal to the port's
one-process archive on ``make_mesh(4, device="cpu")`` and to trico_tpu's
one-process archive of the same data (``_single_process_blobs`` of
tests/test_multiprocess.py).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import test_multiprocess as jax_multiprocess
from trico_tpu_torch.parallel import make_mesh, mp_worker

REPO = Path(__file__).resolve().parents[1]
# the worker as ``python -m`` runs it, with JAX and trico_tpu unimportable
LAUNCH = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.modules['trico_tpu'] = None; "
          "sys.argv = ['mp_worker', *sys.argv[1:]]; "
          "runpy.run_module('trico_tpu_torch.parallel.mp_worker', "
          "run_name='__main__')")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(args_of, timeout=540):
    """Start one worker per argument list, wait for all; kill all on a
    timeout. Returns (return codes, outputs)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", LAUNCH, *map(str, args)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for args in args_of]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outputs


def test_two_processes_two_shards_each(tmp_path):
    out = tmp_path / "mp_blob"
    port = _free_port()
    rcs, outputs = _run_ranks([[rank, 2, port, out, "--device", "cpu",
                                "--shards-per-rank", 2] for rank in (0, 1)])
    for rank, (rc, text) in enumerate(zip(rcs, outputs)):
        assert rc == 0, f"rank {rank} failed:\n{text}"
        assert f"[rank {rank}/2] ok" in text
    blobs = [(tmp_path / f"mp_blob.rank{r}").read_bytes() for r in (0, 1)]
    assert blobs[0] == blobs[1], "the ranks wrote different archives"
    assert blobs[0] == mp_worker.worker_blobs(make_mesh(4, device="cpu")), \
        "two processes wrote other bytes than one process"
    assert blobs[0] == jax_multiprocess._single_process_blobs(), \
        "the port's archive differs from trico_tpu's"


def test_worker_exits_nonzero_on_failure(tmp_path):
    """A worker whose mesh cannot be made (no shard) exits non-zero and
    writes nothing."""
    rcs, outputs = _run_ranks(
        [[0, 1, _free_port(), tmp_path / "x", "--device", "cpu",
          "--shards-per-rank", 0]], timeout=120)
    assert rcs[0] != 0, outputs[0]
    assert not (tmp_path / "x.rank0").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
def test_worker_runs_on_the_card_unless_asked(tmp_path):
    """Without ``--device`` the worker's mesh is on the card: with no card
    it raises, exits non-zero and writes nothing; it never goes on to the
    CPU."""
    rcs, outputs = _run_ranks(
        [[0, 1, _free_port(), tmp_path / "x"]], timeout=120)
    assert rcs[0] != 0, outputs[0]
    assert "CUDA is not available" in outputs[0], outputs[0]
    assert not (tmp_path / "x.rank0").exists()


@pytest.mark.parametrize("k", [1, 3])
def test_worker_blobs_match_trico_tpu(k):
    """The worker's archives on one process of k shards: trico_tpu's bytes
    for the same data."""
    import jax

    from trico_tpu.parallel import mesh_codec as jmc

    verts, tris, normals, colors = mp_worker.worker_data(k)
    jmesh = jmc.make_mesh(min(8, len(jax.devices())))
    L = mp_worker.CHUNK_LEN
    want = (jmc.compress_mesh(verts, tris, vertex_normals=normals,
                              vertex_colors=colors, chunk_len=L, mesh=jmesh)
            + jmc.compress_mesh(verts.astype("float64"), chunk_len=L, mesh=jmesh))
    assert mp_worker.worker_blobs(make_mesh(k, device="cpu")) == want
