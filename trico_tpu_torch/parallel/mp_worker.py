"""One rank of the mesh codec across processes.

    python -m trico_tpu_torch.parallel.mp_worker RANK NPROC PORT OUT \
        [--device cpu|cuda] [--shards-per-rank K] [--backend gloo|nccl]

NPROC processes join one process group (``torch.distributed``, gloo unless
``--backend nccl``) over ``tcp://localhost:PORT``, each with K shards of
``--device`` (the card by default; ``--device cpu`` asks for the CPU), so
the mesh has NPROC x K shards. Every rank builds the same mesh data from a
seed (:func:`worker_data`, the data of ``scripts/mp_worker.py``),
compresses it with ``compress_mesh`` (f32 vertices with triangles, normals
and colors; then the vertices as f64), checks that ``decompress_mesh`` and
``ArchiveReader`` give every stream back bit-exact, and writes the archive
bytes to ``OUT.rank<RANK>``. Any failure exits non-zero. The tests and
``chip_smoke.py`` compare the ranks' bytes with one another and with a
one-process archive of the same data (:func:`worker_blobs` on a mesh of
NPROC x K shards).
"""

from __future__ import annotations

import argparse
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..archive import ArchiveReader
from . import mesh_codec

CHUNK_LEN = 64


def worker_data(n_shards: int, chunk_len: int = CHUNK_LEN):
    """(vertices, triangles, vertex normals, vertex colors) for a mesh of
    ``n_shards`` shards: two full chunks a shard and a partial last chunk,
    from seed 2 (scripts/mp_worker.py:60-69)."""
    n_verts = 2 * n_shards * chunk_len + 13
    rng = np.random.default_rng(2)
    verts = (np.sin(np.linspace(0, 6 * np.pi, 3 * n_verts)) * 4
             + rng.normal(0, 1e-3, 3 * n_verts).cumsum()
             ).astype(np.float32).reshape(n_verts, 3)
    tris = rng.integers(0, n_verts, (2 * n_verts, 3)).astype(np.uint32)
    normals = (verts * 0.5 + 1.25).astype(np.float32)
    colors = rng.integers(0, 2**32, n_verts, dtype=np.uint64).astype(np.uint32)
    return verts, tris, normals, colors


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"mp_worker: {what}")


def worker_blobs(mesh: mesh_codec.Mesh, chunk_len: int = CHUNK_LEN) -> bytes:
    """The f32 archive then the f64 archive of :func:`worker_data` on
    ``mesh``, each checked bit-exact through ``decompress_mesh`` and
    ``ArchiveReader``; raises on any difference."""
    verts, tris, normals, colors = worker_data(mesh.size, chunk_len)
    blob = mesh_codec.compress_mesh(verts, tris, vertex_normals=normals,
                                    vertex_colors=colors, chunk_len=chunk_len,
                                    mesh=mesh)
    r = ArchiveReader(blob, device=mesh.shards[0])
    _check(np.array_equal(r.read_vertices().view(np.uint32),
                          verts.view(np.uint32)), "ArchiveReader vertices")
    _check(np.array_equal(r.read_triangles(), tris), "ArchiveReader triangles")
    out = mesh_codec.decompress_mesh(blob, mesh)
    for name, want in (("vertices", verts), ("triangles", tris),
                       ("vertex_normals", normals), ("vertex_colors", colors)):
        got = out[name]
        _check(got.dtype == want.dtype and got.shape == want.shape
               and got.tobytes() == want.tobytes(), f"decompress_mesh {name}")
    verts64 = verts.astype(np.float64)
    blob64 = mesh_codec.compress_mesh(verts64, chunk_len=chunk_len, mesh=mesh)
    v64 = ArchiveReader(blob64, device=mesh.shards[0]).read_vertices_double()
    _check(np.array_equal(v64.view(np.uint64), verts64.view(np.uint64)),
           "ArchiveReader f64 vertices")
    v64 = mesh_codec.decompress_mesh(blob64, mesh)["vertices"]
    _check(np.array_equal(v64.view(np.uint64), verts64.view(np.uint64)),
           "decompress_mesh f64 vertices")
    return blob + blob64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trico_tpu_torch.parallel.mp_worker")
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shards-per-rank", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    dist.init_process_group(args.backend,
                            init_method=f"tcp://localhost:{args.port}",
                            world_size=args.nproc, rank=args.rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = mesh_codec.make_mesh(args.nproc * args.shards_per_rank,
                                    device=args.device)
        _check(mesh.world_size == args.nproc and mesh.rank == args.rank,
               f"process group of {mesh.world_size}, rank {mesh.rank}")
        if args.backend == "nccl":
            # NCCL's collectives run on the card of the rank's first shard
            torch.cuda.set_device(mesh.shards[0])
        blobs = worker_blobs(mesh)
        with open(f"{args.out}.rank{args.rank}", "wb") as f:
            f.write(blobs)
        print(f"[rank {args.rank}/{args.nproc}] ok: {len(blobs)} B of archives, "
              f"{mesh.size} shards ({args.backend}, {mesh.shards})", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
