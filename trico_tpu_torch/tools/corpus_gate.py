"""The corpus size gate: the port's archives against the reference's size
on seven classes of mesh.

    python -m trico_tpu_torch.tools.corpus_gate [--device cuda|cpu]
        [--json PATH] [--recorded CORPUS.json]

Counterpart of ``scripts/corpus_gate.py``. Every mesh of the corpus
(:mod:`.corpus`) is written three ways:

* ``ref``: the reference library's v0 archive (:mod:`.ref_oracle`) where
  its sources are checked out in the repository's ``reference/`` and build
  (``"ref_source": "live"``); otherwise the class's
  ``ref_bytes`` in the recorded table, the repository's ``CORPUS.json``
  unless ``--recorded`` names another (``"ref_source": "recorded"``);
* ``v0``: ``ArchiveWriter(optimize=True)``, the reference-compatible
  archive, written on the host;
* ``v1``: ``ArchiveWriter(chunk_len=4096, optimize=True)`` on ``--device``
  (the card unless ``--device cpu`` is given; without a card the default
  raises).

Both archives are read back by ``ArchiveReader`` on ``--device``, and every
stream written (vertices, triangles, normals, colors, uvs) must come back
bit-exact. The gate: ``v0 <= ref`` and ``v1 <= ref`` in every class; a
class with no reference size, live or recorded, fails. Times are host
clock, read after a synchronize of the device.

It prints one JSON line: the rows by class (the original's fields and
``ref_source``), the failures, ``ok`` and the card's name and power limit.
It writes the same object to ``--json`` where that is given, and never to
the recorded table. Exit 1 on any gate failure or inexact round trip.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from ..archive import ArchiveReader, ArchiveWriter, StreamType
from ..bench import _sync, card
from ..shards import torch_device
from . import ref_oracle
from .corpus import build_corpus

RECORDED = Path(__file__).resolve().parents[2] / "CORPUS.json"
CHUNK_LEN = 4096
# the corpus's mesh keys of the streams an archive holds
KEYS = {StreamType.vertex_float: "vertices", StreamType.vertex_double: "vertices",
        StreamType.triangle_uint32: "triangles",
        StreamType.triangle_uint64: "triangles",
        StreamType.vertex_normal_float: "vertex_normals",
        StreamType.vertex_color: "vertex_colors",
        StreamType.uv_per_vertex_float: "uv_per_vertex"}


def our_archive(mesh: dict, chunk_len: int | None = None, *, device="cuda") -> bytes:
    """The mesh as a v0 archive on the host (``chunk_len`` None) or a v1
    archive of ``chunk_len``-value chunks on ``device``, at
    ``optimize=True``, streams in the reference encoder's order."""
    w = ArchiveWriter(chunk_len=chunk_len, optimize=True, device=device)
    verts = np.ascontiguousarray(mesh["vertices"])
    if verts.dtype == np.float64:
        w.write_vertices_double(verts)
    else:
        w.write_vertices(verts)
    if np.asarray(mesh["triangles"]).dtype == np.uint64:
        w.write_triangles_long(mesh["triangles"])
    else:
        w.write_triangles(mesh["triangles"])
    if "vertex_normals" in mesh:
        w.write_vertex_normals(mesh["vertex_normals"])
    if "vertex_colors" in mesh:
        w.write_vertex_colors(mesh["vertex_colors"])
    if "uv_per_vertex" in mesh:
        w.write_uv_per_vertex(mesh["uv_per_vertex"])
    return w.tobytes()


def inexact_streams(blob: bytes, mesh: dict, *, device="cuda") -> list[str]:
    """The mesh keys whose stream ``ArchiveReader`` does not give back with
    the mesh's dtype, shape and bits, or that the archive lacks or adds."""
    got = {KEYS.get(st, st.name): arr
           for st, arr in ArchiveReader(blob, device=device).streams()}
    bad = []
    for key in sorted(set(got) | set(mesh)):
        a, b = got.get(key), mesh.get(key)
        if a is None or b is None or a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != np.ascontiguousarray(b).tobytes():
            bad.append(key)
    return bad


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def gate_class(name: str, mesh: dict, recorded: dict, device) -> tuple[dict, list[str]]:
    """One class: (its row, its failures)."""
    raw_bytes = sum(np.ascontiguousarray(v).nbytes for v in mesh.values())
    ref, t_ref = _timed(lambda: ref_oracle.ref_archive(mesh), device)
    if ref is not None:
        ref_bytes, source = len(ref), "live"
    else:
        ref_bytes, source, t_ref = recorded.get(name, {}).get("ref_bytes"), "recorded", None
    v0, t_v0 = _timed(lambda: our_archive(mesh, device=device), device)
    v1, t_v1 = _timed(lambda: our_archive(mesh, CHUNK_LEN, device=device), device)
    bad = {k: inexact_streams(blob, mesh, device=device)
           for k, blob in (("v0", v0), ("v1", v1))}
    fails = [f"{name}: {k} round trip not bit-exact in {v}" for k, v in bad.items() if v]
    if ref_bytes is None:
        fails.append(f"{name}: no reference size, live or recorded")
    for k, blob in (("v0", v0), ("v1", v1)):
        if ref_bytes is not None and len(blob) > ref_bytes:
            fails.append(f"{name}: {k} {len(blob)} > ref {ref_bytes}")
    row = {"raw_bytes": int(raw_bytes), "ref_bytes": ref_bytes,
           "ref_source": source if ref_bytes is not None else None,
           "v0_bytes": len(v0), "v1_bytes": len(v1),
           "ref_ratio": round(raw_bytes / ref_bytes, 3) if ref_bytes else None,
           "v0_ratio": round(raw_bytes / len(v0), 3),
           "v1_ratio": round(raw_bytes / len(v1), 3),
           "v0_vs_ref": round(len(v0) / ref_bytes, 4) if ref_bytes else None,
           "v1_vs_ref": round(len(v1) / ref_bytes, 4) if ref_bytes else None,
           "t_ref_s": None if t_ref is None else round(t_ref, 3),
           "t_v0_s": round(t_v0, 3), "t_v1_s": round(t_v1, 3),
           "exact": not any(bad.values())}
    return row, fails


def run(meshes: dict, recorded: dict, device="cuda") -> dict:
    """The gate over ``meshes`` (name -> mesh) against the live reference
    or the ``recorded`` table (name -> row): the result object."""
    dev = torch_device(device)
    rows, fails = {}, []
    for name, mesh in meshes.items():
        rows[name], f = gate_class(name, mesh, recorded, dev)
        fails += f
        r = rows[name]
        print(f"corpus_gate {name:8s} raw={r['raw_bytes']:>10,d} "
              f"ref={r['ref_bytes']} ({r['ref_source']}) v0={r['v0_bytes']:>9,d} "
              f"({r['v0_vs_ref']}) v1={r['v1_bytes']:>9,d} ({r['v1_vs_ref']}) "
              f"{'OK' if not f else 'FAIL'}", file=sys.stderr, flush=True)
    return {"tool": "corpus_gate", "backend": dev.type, "device": card(dev),
            "chunk_len": CHUNK_LEN, "rows": rows, "failures": fails,
            "ok": not fails}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trico_tpu_torch.tools.corpus_gate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the v1 archives are written and read (the card "
                         "by default)")
    ap.add_argument("--json", type=Path, help="also write the result here")
    ap.add_argument("--recorded", type=Path, default=RECORDED,
                    help="the table of reference sizes used where the reference "
                         "library is not built (default: the repository's "
                         "CORPUS.json)")
    args = ap.parse_args(argv)
    if args.json is not None and args.json.resolve() in (RECORDED, args.recorded.resolve()):
        ap.error("--json may not name the recorded table")
    recorded = json.loads(args.recorded.read_text())
    result = run(build_corpus(), recorded, args.device)
    result["recorded"] = str(args.recorded)
    line = json.dumps(result)
    if args.json is not None:
        args.json.write_text(line + "\n")
    print(line, flush=True)
    for f in result["failures"]:
        print(f"GATE FAILURE: {f}", file=sys.stderr)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
