"""Command-line encoder and decoder of trico archives through the port.

Counterpart of ``trico_tpu/cli.py``:

    python -m trico_tpu_torch encode -i mesh.stl|mesh.ply [-o out.trc]
        [-stladd normal|uint16] [-plyskip normal|tex_coord|color]
        [--backend auto|native|numpy] [--chunked [CHUNK_LEN]] [--device cuda|cpu]
        [--keep-doubles] [--fast] [--profile]
    python -m trico_tpu_torch decode -i in.trc [-o out.stl|out.ply]
        [--ply-storage ...] [--device cuda|cpu] [--profile]

``encode`` writes a version-1 archive (adaptive exponents, or the small-table
set with ``--fast``; BP or LZ4 integer streams, whichever is smaller) whose
substreams are coded on ``--device``, the card unless ``cpu`` is asked for,
in chunks of 4096 values unless ``--chunked CHUNK_LEN`` gives another
length: the bytes of ``trico_tpu.cli encode --chunked`` on a device host.
With ``--backend`` and no ``--chunked`` it writes a reference-compatible
version-0 archive on the host instead, with the C++ host library
(``native``, or ``auto`` where it is built) or the NumPy codecs (``numpy``):
the bytes of ``trico_tpu.cli encode`` with the same backend. ``decode`` reads
any archive, v0 or v1, and writes STL or PLY as ``trico_tpu``'s decoder does.
``--profile`` prints a per-stage report of time and GB/s to stderr, with
``trico_tpu``'s stage names (:class:`trico_tpu_torch.profiling.StageTimer`).

Where this differs from ``trico_tpu.cli``: there the encoder's default is
the host's version-0 archive and the device is reached with ``--chunked`` or
``--backend jax``; here the default is the device's version-1 archive and
the host's is reached by naming a ``--backend``. ``--backend jax`` has no
meaning here and is not carried over. ``--chunk-len N`` is a deprecated
spelling of ``--chunked N``. The mesh readers and writers are
:mod:`trico_tpu_torch.io`'s.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

from .archive import ArchiveReader, ArchiveWriter, StreamType
from .chunked import DEFAULT_CHUNK_LEN
from .io import ply, stl
from .profiling import StageTimer


def _device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help='torch device for the codecs of a version-1 '
                         'archive: "cuda" (the default; raises without a '
                         'card) or "cpu"')


def _profile_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--profile", action="store_true",
                    help="print per-stage timing/GB/s report to stderr")


def _stager(enabled: bool):
    """Return (timer, stage) where stage(name, nbytes) is a context manager;
    a no-op when profiling is off."""
    if not enabled:
        return None, lambda name, nbytes=0: contextlib.nullcontext()
    prof = StageTimer()
    return prof, prof.stage


def encoder_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trico_tpu_torch encode",
        description="Compress a binary STL or PLY mesh into a trico archive.")
    ap.add_argument("-i", dest="input", required=True, help="input .stl or .ply file")
    ap.add_argument("-o", dest="output", help="output file name (default: input with .trc)")
    ap.add_argument("-stladd", action="append", default=[], choices=["normal", "uint16"],
                    help="also store the given STL attribute")
    ap.add_argument("-plyskip", action="append", default=[],
                    choices=["normal", "tex_coord", "color"],
                    help="skip the given PLY attribute")
    ap.add_argument("--backend", default=None, choices=["auto", "native", "numpy"],
                    help="write a reference-compatible version-0 archive on "
                         "the host with this codec (auto: native, falling "
                         "back to numpy) instead of the version-1 archive; "
                         "--chunked overrides it")
    ap.add_argument("--chunked", nargs="?", const=DEFAULT_CHUNK_LEN, type=int,
                    default=None, metavar="CHUNK_LEN",
                    help="write a version-1 chunk-parallel archive on --device "
                         "(adaptive exponents + BP32 pick-best integers; not "
                         "readable by the reference library): the default "
                         "unless --backend is given. Default chunk: "
                         f"{DEFAULT_CHUNK_LEN}")
    ap.add_argument("--chunk-len", type=int, default=None, metavar="CHUNK_LEN",
                    help="deprecated: the same as --chunked CHUNK_LEN")
    ap.add_argument("--keep-doubles", action="store_true",
                    help="preserve float64 PLY vertex coordinates as a "
                         "vertex_double stream")
    ap.add_argument("--fast", action="store_true",
                    help="throughput profile: skip the adaptive exponent "
                         "search (v0: reference default exponents; v1 "
                         "--chunked: small-table candidate set only, at a "
                         "few %% larger output)")
    _device_arg(ap)
    _profile_arg(ap)
    args = ap.parse_args(argv)
    if args.chunked is not None and args.chunk_len is not None:
        ap.error("--chunk-len is a deprecated spelling of --chunked: give one")
    chunk_len = args.chunked if args.chunked is not None else args.chunk_len
    if chunk_len is not None and chunk_len < 1:
        ap.error("the chunk length must be at least 1")

    inp = Path(args.input)
    out = Path(args.output) if args.output else inp.with_suffix(".trc")
    ext = inp.suffix.lower()
    if ext not in (".stl", ".ply"):
        print("I expect the input file to be of type stl or ply.", file=sys.stderr)
        return 1
    prof, stage = _stager(args.profile)
    opt = "fast" if args.fast else True
    if chunk_len is None and args.backend is not None:
        # the caller named a host codec: a v0 archive, and no device is used
        w = ArchiveWriter(use_native=args.backend in ("auto", "native"),
                          optimize=opt, device="cpu")
    else:
        w = ArchiveWriter(chunk_len=chunk_len or DEFAULT_CHUNK_LEN,
                          optimize=opt, device=args.device)
    if ext == ".stl":
        with stage("read_stl", inp.stat().st_size):
            if args.stladd:
                verts, tris, tri_normals, attrs = stl.read_stl(inp, full=True)
            else:
                (verts, tris), tri_normals, attrs = stl.read_stl(inp), None, None
        if len(verts):
            with stage("encode_vertices", verts.nbytes):
                w.write_vertices(verts)
        if len(tris):
            with stage("encode_triangles", tris.nbytes):
                w.write_triangles(tris)
        if "normal" in args.stladd and tri_normals is not None and len(tris):
            with stage("encode_tri_normals", tri_normals.nbytes):
                w.write_triangle_normals(tri_normals)
        if "uint16" in args.stladd and attrs is not None and len(tris):
            with stage("encode_attrs_u16", attrs.nbytes):
                w.write_attributes_uint16(attrs)
    else:
        with stage("read_ply", inp.stat().st_size):
            mesh = ply.read_ply(inp, keep_doubles=args.keep_doubles)
        if mesh.vertices is not None and len(mesh.vertices):
            with stage("encode_vertices", mesh.vertices.nbytes):
                if mesh.vertices.dtype == np.float64:
                    w.write_vertices_double(mesh.vertices)
                else:
                    w.write_vertices(mesh.vertices)
        if mesh.triangles is not None and len(mesh.triangles):
            with stage("encode_triangles", mesh.triangles.nbytes):
                w.write_triangles(mesh.triangles)
        if "normal" not in args.plyskip and mesh.vertex_normals is not None:
            with stage("encode_normals", mesh.vertex_normals.nbytes):
                w.write_vertex_normals(mesh.vertex_normals)
        if "color" not in args.plyskip and mesh.vertex_colors is not None:
            with stage("encode_colors", mesh.vertex_colors.nbytes):
                w.write_vertex_colors(mesh.vertex_colors)
        if "tex_coord" not in args.plyskip and mesh.texcoords is not None:
            with stage("encode_uvs", mesh.texcoords.nbytes):
                w.write_uv_per_triangle(mesh.texcoords)
    with stage("write_archive"):
        w.save(out)
    if prof:
        print(prof.report(), file=sys.stderr)
    return 0


def decoder_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trico_tpu_torch decode",
        description="Decompress a trico archive back to STL or PLY on a "
                    "torch device.")
    ap.add_argument("-i", dest="input", required=True, help="input .trc file")
    ap.add_argument("-o", dest="output", help="output .stl or .ply (default: by content)")
    ap.add_argument("--ply-storage", default="binary_le",
                    choices=["binary_le", "binary_be", "ascii"],
                    help="PLY output storage mode (default binary_le)")
    _device_arg(ap)
    _profile_arg(ap)
    args = ap.parse_args(argv)

    prof, stage = _stager(args.profile)
    r = ArchiveReader(Path(args.input).read_bytes(), device=args.device)
    verts = tris = tri_normals = vert_normals = colors = uvs = attrs16 = None
    while r.next_stream_type != StreamType.empty:
        st_name = r.next_stream_type.name
        with stage(f"decode_{st_name}"):
            st, arr = r.read_stream()
        if prof:
            prof.stages[f"decode_{st_name}"].nbytes += arr.nbytes
        if st in (StreamType.vertex_float, StreamType.vertex_double):
            verts = arr
        elif st == StreamType.triangle_uint32:
            tris = arr
        elif st == StreamType.triangle_normal_float:
            tri_normals = arr
        elif st == StreamType.vertex_normal_float:
            vert_normals = arr
        elif st == StreamType.vertex_color:
            colors = arr
        elif st == StreamType.uv_per_triangle_float:
            uvs = arr.reshape(-1, 6)
        elif st == StreamType.attribute_uint16:
            attrs16 = arr
        # other stream kinds are skipped, like the reference decoder
    if verts is None:
        print("Archive contains no vertices.", file=sys.stderr)
        return 1
    if args.output:
        out = Path(args.output)
        want_ply = out.suffix.lower() == ".ply"
    else:
        want_ply = (colors is not None or uvs is not None
                    or vert_normals is not None or verts.dtype == np.float64)
        out = Path(args.input).with_suffix(".ply" if want_ply else ".stl")
    with stage("write_mesh"):
        if want_ply:
            ply.write_ply(out, verts, vert_normals, colors, tris, uvs,
                          storage=args.ply_storage)
        else:
            if tris is None:
                tris = np.zeros((0, 3), np.uint32)
            if tri_normals is None and len(tris):
                tri_normals = stl.compute_triangle_normals(verts, tris)
            stl.write_stl(out, verts, tris, tri_normals, attrs16)
    if prof:
        print(prof.report(), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    """``python -m trico_tpu_torch {encode|decode} ...``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m trico_tpu_torch {encode|decode} [options]\n"
              "       encode -i mesh.{stl,ply} [-o out.trc] [--chunked [N] | "
              "--backend auto|native|numpy] [--device cuda|cpu] [--profile]\n"
              "       decode -i in.trc [-o out.{stl,ply}] [--device cuda|cpu] "
              "[--profile]",
              file=sys.stderr if argv else sys.stdout)
        return 1 if argv else 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "encode":
        return encoder_main(rest)
    if cmd == "decode":
        return decoder_main(rest)
    print(f"unknown command {cmd!r} (want encode or decode)", file=sys.stderr)
    return 1
