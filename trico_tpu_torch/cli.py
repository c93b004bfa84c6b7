"""Command-line encoder and decoder of v1 archives through the port.

Counterpart of ``trico_tpu/cli.py``'s ``--chunked`` encode and its decode:

    python -m trico_tpu_torch encode -i mesh.stl|mesh.ply [-o out.trc] [--device cuda|cpu]
    python -m trico_tpu_torch decode -i in.trc [-o out.stl|out.ply] [--device cuda|cpu]

``encode`` writes a version-1 archive (chunks of ``--chunk-len`` values,
default 4096; adaptive exponents, or the small-table set with ``--fast``;
BP or LZ4 integer streams, whichever is smaller) whose substreams are coded
on ``--device`` (the card unless ``cpu`` is asked for); the bytes equal
``trico_tpu.cli encode --chunked`` on a device host. ``decode`` reads any
archive, v0 or v1, and writes STL or PLY as ``trico_tpu``'s decoder does.
The mesh readers and writers are
:mod:`trico_tpu_torch.io`'s. ``trico_tpu``'s ``--backend`` and ``--profile``
options are not carried over.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .archive import ArchiveReader, ArchiveWriter, StreamType
from .chunked import DEFAULT_CHUNK_LEN
from .io import ply, stl


def _device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help='torch device for the codecs: "cuda" (the default; '
                         'raises without a card) or "cpu"')


def encoder_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trico_tpu_torch encode",
        description="Compress a binary STL or PLY mesh into a version-1 "
                    "trico archive on a torch device.")
    ap.add_argument("-i", dest="input", required=True, help="input .stl or .ply file")
    ap.add_argument("-o", dest="output", help="output file name (default: input with .trc)")
    ap.add_argument("-stladd", action="append", default=[], choices=["normal", "uint16"],
                    help="also store the given STL attribute")
    ap.add_argument("-plyskip", action="append", default=[],
                    choices=["normal", "tex_coord", "color"],
                    help="skip the given PLY attribute")
    ap.add_argument("--chunk-len", type=int, default=DEFAULT_CHUNK_LEN,
                    help=f"values per FP chunk (default {DEFAULT_CHUNK_LEN})")
    ap.add_argument("--keep-doubles", action="store_true",
                    help="preserve float64 PLY vertex coordinates as a "
                         "vertex_double stream")
    ap.add_argument("--fast", action="store_true",
                    help="throughput profile: the small-table candidate set "
                         "only, at a few %% larger output")
    _device_arg(ap)
    args = ap.parse_args(argv)

    inp = Path(args.input)
    out = Path(args.output) if args.output else inp.with_suffix(".trc")
    ext = inp.suffix.lower()
    if ext not in (".stl", ".ply"):
        print("I expect the input file to be of type stl or ply.", file=sys.stderr)
        return 1
    w = ArchiveWriter(chunk_len=args.chunk_len,
                      optimize="fast" if args.fast else True, device=args.device)
    if ext == ".stl":
        if args.stladd:
            verts, tris, tri_normals, attrs = stl.read_stl(inp, full=True)
        else:
            (verts, tris), tri_normals, attrs = stl.read_stl(inp), None, None
        if len(verts):
            w.write_vertices(verts)
        if len(tris):
            w.write_triangles(tris)
        if "normal" in args.stladd and tri_normals is not None and len(tris):
            w.write_triangle_normals(tri_normals)
        if "uint16" in args.stladd and attrs is not None and len(tris):
            w.write_attributes_uint16(attrs)
    else:
        mesh = ply.read_ply(inp, keep_doubles=args.keep_doubles)
        if mesh.vertices is not None and len(mesh.vertices):
            if mesh.vertices.dtype == np.float64:
                w.write_vertices_double(mesh.vertices)
            else:
                w.write_vertices(mesh.vertices)
        if mesh.triangles is not None and len(mesh.triangles):
            w.write_triangles(mesh.triangles)
        if "normal" not in args.plyskip and mesh.vertex_normals is not None:
            w.write_vertex_normals(mesh.vertex_normals)
        if "color" not in args.plyskip and mesh.vertex_colors is not None:
            w.write_vertex_colors(mesh.vertex_colors)
        if "tex_coord" not in args.plyskip and mesh.texcoords is not None:
            w.write_uv_per_triangle(mesh.texcoords)
    w.save(out)
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
    args = ap.parse_args(argv)

    r = ArchiveReader(Path(args.input).read_bytes(), device=args.device)
    verts = tris = tri_normals = vert_normals = colors = uvs = attrs16 = None
    for st, arr in r.streams():
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
    if want_ply:
        ply.write_ply(out, verts, vert_normals, colors, tris, uvs,
                      storage=args.ply_storage)
    else:
        if tris is None:
            tris = np.zeros((0, 3), np.uint32)
        if tri_normals is None and len(tris):
            tri_normals = stl.compute_triangle_normals(verts, tris)
        stl.write_stl(out, verts, tris, tri_normals, attrs16)
    return 0


def main(argv=None) -> int:
    """``python -m trico_tpu_torch {encode|decode} ...``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m trico_tpu_torch {encode|decode} [options]\n"
              "       encode -i mesh.{stl,ply} [-o out.trc] [--device cuda|cpu]\n"
              "       decode -i in.trc [-o out.{stl,ply}] [--device cuda|cpu]",
              file=sys.stderr if argv else sys.stdout)
        return 1 if argv else 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "encode":
        return encoder_main(rest)
    if cmd == "decode":
        return decoder_main(rest)
    print(f"unknown command {cmd!r} (want encode or decode)", file=sys.stderr)
    return 1
