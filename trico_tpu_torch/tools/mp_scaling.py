"""The fixed-work scaling run of ``compress_mesh`` over 1, 2 and 4 processes.

    python -m trico_tpu_torch.tools.mp_scaling [--device cuda|cpu]
        [--verts N] [--procs 1,2,4] [--shards 8] [--json PATH]

Counterpart of ``scripts/mp_scaling.py``. The same workload, an f32
vertex stream of N vertices (NumPy ``default_rng(7)``: ``sin(linspace(0,
600 pi, 3N)) * 8`` plus a walk of ``normal(0, 1e-3)`` steps), goes through
the whole distributed product, ``compress_mesh`` (each shard's batch, the
size all-gather and scan, the byte gather), over one mesh of ``--shards``
shards split into P processes for each P of ``--procs``. With one process
the mesh spans the process alone (its gathers are host concatenations);
with more, P ranks of this module join one gloo process group over
``tcp://localhost:<free port>`` and each holds ``shards / P`` shards of
``make_mesh(shards, device=...)``. On one card every shard is ``cuda:0``.

The work and the device are the same in every configuration, so the
metric is overhead efficiency, ``efficiency(P) = wall(1) / wall(P)``:
what the distributed path adds (process boundaries, the two gathers
through the host, the host assembly each rank repeats, the card shared
between processes) shows as efficiency below 1. It is not a scaling
figure: one card shared in time cannot show scaling.

The backend is gloo: NCCL refuses two ranks on one card. NCCL across
cards is a run for a machine with several cards.

Each rank runs ``compress_mesh(verts, chunk_len=4096, mesh=mesh)`` once
to warm up, then twice timed (host clock, read after a synchronize; CPU
seconds from ``process_time``), keeps the faster run with its
``StageTimer`` stages, checks that each timed archive equals the warm-up's,
and writes its record, with its kernel launches (``fp_cuda.launches``,
counted from the rank's start), into a temporary directory of the run.
The parent drains every rank at once, kills only the processes it started
when one fails or outlasts the time limit, and exits 1 on any failure.
Once, outside any timed window, the one-process archive is decoded by
``decompress_mesh`` in this process, on a mesh of the same shards, and
must come back bit-exact; its kernel launches are counted apart
(``decode_kernel_launches``).

It prints one JSON line: a row for each P (``n_processes``,
``shards_per_proc``, ``wall_s``, ``cpu_s_total``, ``gather_s`` and
``gather_frac`` of the ``fp_gather`` stage, ``stage_seconds``,
``archive_bytes`` and its SHA-256, ``efficiency_vs_1proc``,
``kernel_launches`` summed over the ranks), ``byte_identical_across_configs``,
``exact``, ``decode_kernel_launches``, ``ok`` and the card's name and power
limit; ``--json`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch.distributed as dist

from ..bench import _sync, card
from ..codec import fp_cuda
from ..parallel import mesh_codec
from ..profiling import StageTimer
from ..shards import torch_device

REPO = Path(__file__).resolve().parents[2]
N_VERTS = 1_200_000
CHUNK_LEN = 4096
TIMEOUT = 900  # seconds one configuration may take


def scaling_verts(n: int) -> np.ndarray:
    """The run's (n, 3) float32 vertices."""
    rng = np.random.default_rng(7)
    return (np.sin(np.linspace(0, 600 * np.pi, 3 * n)) * 8
            + rng.normal(0, 1e-3, 3 * n).cumsum()).astype(np.float32).reshape(n, 3)


def worker(rank: int, nproc: int, port: int, out: Path, *, shards: int,
           n_verts: int, device: str) -> None:
    """One rank: the warm-up and the two timed runs; writes its record to
    ``out / f"rank{rank}.json"`` and, on rank 0, the archive to
    ``out / "archive.trc"``."""
    dev = torch_device(device)
    if nproc > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=nproc, rank=rank,
                                timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        fp_cuda.reset_launches()
        mesh = mesh_codec.make_mesh(shards, device=dev)
        verts = scaling_verts(n_verts)
        blob = mesh_codec.compress_mesh(verts, chunk_len=CHUNK_LEN, mesh=mesh)
        best = None
        for _ in range(2):
            prof = StageTimer()
            _sync(dev)
            t0, c0 = time.perf_counter(), time.process_time()
            again = mesh_codec.compress_mesh(verts, chunk_len=CHUNK_LEN, mesh=mesh,
                                             profile=prof)
            _sync(dev)
            wall, cpu = time.perf_counter() - t0, time.process_time() - c0
            if again != blob:
                raise RuntimeError(f"rank {rank}: a timed archive differs from "
                                   "the warm-up's")
            if best is None or wall < best["wall_s"]:
                best = {"wall_s": wall, "cpu_s": cpu,
                        "stages": {k: s.seconds for k, s in prof.stages.items()}}
        best.update(rank=rank, nproc=nproc, shards_per_proc=len(mesh.shards),
                    archive_bytes=len(blob), raw_bytes=int(verts.nbytes),
                    kernel_launches=dict(fp_cuda.launches))
        if rank == 0:
            (out / "archive.trc").write_bytes(blob)
        (out / f"rank{rank}.json").write_text(json.dumps(best))
    finally:
        if nproc > 1:
            dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankFailure(RuntimeError):
    pass


def run_ranks(argvs, timeout: float = TIMEOUT) -> list[tuple[int, str]]:
    """Start one process per argument list, all at once, and drain every
    one's output together (a rank blocked on a full pipe would hold the
    others in a collective). As soon as one exits non-zero, or the time
    limit passes, kill the processes started here, and only those. Returns
    each one's (exit code, output)."""
    procs = [subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for argv in argvs]
    texts = [b""] * len(procs)

    def drain(i, p):
        texts[i] = p.stdout.read()

    threads = [threading.Thread(target=drain, args=(i, p))
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in threads:
            t.join()
    return [(p.returncode, t.decode(errors="replace")) for p, t in zip(procs, texts)]


def run_config(nproc: int, *, shards: int, n_verts: int, device: str,
               work: Path) -> tuple[dict, bytes]:
    """P = ``nproc`` ranks over ``shards`` shards: (the row, rank 0's
    archive)."""
    out = work / f"p{nproc}"
    out.mkdir()
    port = free_port()
    argvs = [[sys.executable, "-m", "trico_tpu_torch.tools.mp_scaling",
              "--worker", str(r), str(nproc), str(port), str(out),
              "--shards", str(shards), "--verts", str(n_verts), "--device", device]
             for r in range(nproc)]
    for r, (rc, text) in enumerate(run_ranks(argvs)):
        if rc != 0:
            raise RankFailure(f"{nproc} processes: rank {r} exited {rc}:\n"
                               f"{text[-3000:]}")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(nproc)]
    r0 = ranks[0]
    gather_s = r0["stages"].get("fp_gather", 0.0)
    launches = {k: sum(r["kernel_launches"][k] for r in ranks)
                for k in fp_cuda.KERNELS}
    row = {"n_processes": nproc, "shards_per_proc": r0["shards_per_proc"],
           "wall_s": r0["wall_s"], "cpu_s_total": sum(r["cpu_s"] for r in ranks),
           "gather_s": gather_s, "gather_frac": gather_s / r0["wall_s"],
           "stage_seconds": r0["stages"], "archive_bytes": r0["archive_bytes"],
           "archive_bytes_by_rank": [r["archive_bytes"] for r in ranks],
           "kernel_launches": launches}
    blob = (out / "archive.trc").read_bytes()
    row["archive_sha256"] = hashlib.sha256(blob).hexdigest()
    return row, blob


def run(*, procs=(1, 2, 4), shards: int = 8, n_verts: int = N_VERTS,
        device: str = "cuda") -> dict:
    """Every configuration of ``procs``, then the decode check: the result
    object."""
    dev = torch_device(device)
    if procs[0] != 1:
        raise ValueError(f"the first process count is the base and must be 1, "
                         f"not {procs[0]}")
    if any(shards % p for p in procs):
        raise ValueError(f"{shards} shards do not split over {procs} processes")
    rows, blobs = [], []
    with tempfile.TemporaryDirectory(prefix="mp_scaling_") as work:
        for p in procs:
            t0 = time.perf_counter()
            row, blob = run_config(p, shards=shards, n_verts=n_verts,
                                   device=dev.type, work=Path(work))
            row["process_s"] = time.perf_counter() - t0
            rows.append(row)
            blobs.append(blob)
            print(f"mp_scaling: {p} processes, {row['shards_per_proc']} shards "
                  f"each: wall {row['wall_s']:.4f} s, gather {row['gather_s']:.4f} s "
                  f"({row['process_s']:.1f} s with start-up)", file=sys.stderr,
                  flush=True)
    identical = all(b == blobs[0] for b in blobs) and all(
        set(r["archive_bytes_by_rank"]) == {len(blobs[0])} for r in rows)
    # the decode check, outside every timed window
    verts = scaling_verts(n_verts)
    fp_cuda.reset_launches()
    back = mesh_codec.decompress_mesh(blobs[0], mesh_codec.make_mesh(shards, device=dev))
    decode_launches = dict(fp_cuda.launches)
    exact = bool(back["vertices"].dtype == verts.dtype
                 and np.array_equal(back["vertices"].view(np.uint32),
                                    verts.view(np.uint32)))
    wall1 = rows[0]["wall_s"]
    for r in rows:
        r["efficiency_vs_1proc"] = wall1 / r["wall_s"]
    return {"tool": "mp_scaling",
            "workload": f"compress_mesh, {n_verts} f32 vertices, a mesh of "
                        f"{shards} shards of {dev.type}",
            "metric": "fixed work, one device: wall(1 proc) / wall(N procs)",
            "backend": dev.type, "device": card(dev),
            "note": "one device shared in time by every process: this shows "
                    "the distributed path's overhead, not scaling",
            "configs": rows,
            "byte_identical_across_configs": identical, "exact": exact,
            "decode_kernel_launches": decode_launches,
            "ok": identical and exact}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trico_tpu_torch.tools.mp_scaling",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the shards' device (the card by default)")
    ap.add_argument("--verts", type=int, default=N_VERTS)
    ap.add_argument("--procs", default="1,2,4",
                    help="process counts, comma-separated; the first is the "
                         "efficiencies' base")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--json", type=Path, help="also write the result here")
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "NPROC", "PORT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, nproc, port, out = args.worker
        worker(int(rank), int(nproc), int(port), Path(out), shards=args.shards,
               n_verts=args.verts, device=args.device)
        return 0
    try:
        result = run(procs=tuple(int(p) for p in args.procs.split(",")),
                     shards=args.shards, n_verts=args.verts, device=args.device)
    except RankFailure as e:
        print(f"mp_scaling: {e}", file=sys.stderr)
        return 1
    line = json.dumps(result)
    if args.json is not None:
        args.json.write_text(line + "\n")
    print(line, flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
