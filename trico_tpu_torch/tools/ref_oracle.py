"""The reference trico C library, compiled from its sources, as the size
gate's live oracle (:mod:`.corpus_gate`).

The port's own copy of the archive half of ``tests/ref_oracle.py``. Where
the reference's sources are checked out inside the repository, in the
directory ``reference/`` at its root (gitignored: the repository does not
carry them), their five C files are built with ``gcc`` into
``build/ref/libtrico_ref_<hash>.so`` (the hash of the sources), under a
temporary name of the building process and then renamed into place, so
that processes building at once never load a half-written file.
:func:`ref_archive` then writes a v0 archive with the reference's own
``trico_write_*`` calls. Where the sources are absent, or do not build,
both return None.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .. import native

# the checkout's own reference/ directory: nothing outside the repository
REFERENCE = Path(__file__).resolve().parents[2] / "reference"
SOURCES = ("trico/trico.c", "trico/floating_point_stream_compression.c",
           "trico/transpose_aos_to_soa.c", "lz4/lz4.c", "trico_io/iostl.c")
# the writers a mesh of the corpus calls: (archive, data, count) -> int
WRITERS = ("vertices", "vertices_double", "triangles", "triangles_long",
           "vertex_normals", "vertex_colors", "uv_per_vertex")


def _compile(ref_dir: Path) -> Path:
    srcs = [ref_dir / s for s in SOURCES]
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.read_bytes())
    out = native._build_dir() / "ref" / f"libtrico_ref_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", f"-I{ref_dir}",
                    *map(str, srcs), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


def get(ref_dir: Path | None = None):
    """The reference library built from ``ref_dir`` (``REFERENCE`` by
    default), with the archive entry points declared; None where the
    sources are absent or do not build."""
    return _load(Path(REFERENCE if ref_dir is None else ref_dir).resolve())


@functools.lru_cache(maxsize=None)
def _load(ref_dir: Path):
    if not all((ref_dir / s).is_file() for s in SOURCES):
        return None
    try:
        lib = ctypes.CDLL(str(_compile(ref_dir)))
    except (OSError, subprocess.CalledProcessError):
        return None
    p = ctypes.c_void_p
    lib.trico_open_archive_for_writing.restype = p
    lib.trico_open_archive_for_writing.argtypes = [ctypes.c_uint64]
    lib.trico_get_buffer_pointer.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.trico_get_buffer_pointer.argtypes = [p]
    lib.trico_get_size.restype = ctypes.c_uint64
    lib.trico_get_size.argtypes = [p]
    lib.trico_close_archive.restype = None
    lib.trico_close_archive.argtypes = [p]
    for name in WRITERS:
        f = getattr(lib, f"trico_write_{name}")
        f.restype = ctypes.c_int
        f.argtypes = [p, p, ctypes.c_uint32]
    return lib


def ref_archive(mesh: dict, ref_dir: Path | None = None) -> bytes | None:
    """A mesh of the corpus as the reference library's v0 archive, streams
    in the reference encoder's order (vertices, triangles, then normals,
    colors and uvs where the mesh has them); None where the library is
    unavailable."""
    lib = get(ref_dir)
    if lib is None:
        return None
    verts = np.ascontiguousarray(mesh["vertices"])
    tris = np.ascontiguousarray(mesh["triangles"])
    # (writer, array, count); the list keeps every array alive until the
    # archive is copied out
    calls = [("vertices_double", verts, len(verts)) if verts.dtype == np.float64
             else ("vertices", verts.astype(np.float32), len(verts)),
             ("triangles_long", tris, len(tris)) if tris.dtype == np.uint64
             else ("triangles", tris.astype(np.uint32), len(tris))]
    calls += [(k, np.ascontiguousarray(mesh[k], dt), len(verts))
              for k, dt in (("vertex_normals", np.float32),
                            ("vertex_colors", np.uint32),
                            ("uv_per_vertex", np.float32)) if k in mesh]
    a = lib.trico_open_archive_for_writing(1 << 20)
    try:
        for name, arr, count in calls:
            if not getattr(lib, f"trico_write_{name}")(
                    a, arr.ctypes.data_as(ctypes.c_void_p), count):
                raise RuntimeError(f"reference trico_write_{name} failed")
        return ctypes.string_at(lib.trico_get_buffer_pointer(a), lib.trico_get_size(a))
    finally:
        lib.trico_close_archive(a)
