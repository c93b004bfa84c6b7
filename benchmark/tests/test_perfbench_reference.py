"""The NumPy reference decodes what trico_tpu_torch writes, on CPU shards at
tiny sizes, for every stream kind of the cells (f32 planes in the v2
layout with their reference-layout tails, LZ4 byte planes from the host
and from the device match search, fill planes, BP32 streams) and the
64-bit kinds beside them; and it refuses a broken archive."""

import numpy as np
import pytest

from benchmark import meshgen
from benchmark.reference import archive, decode_archive, decode_archives
from benchmark.reference.compare import words_wrong


def _mesh(side, seed=3):
    verts, tris = meshgen.scan_surface(side, meshgen.rng(seed, 0))
    colors = meshgen.vertex_colors(verts, 2, meshgen.rng(seed, 1))
    return verts, tris, colors


def _write(**streams):
    from trico_tpu_torch.parallel import compress_mesh, make_mesh
    return compress_mesh(**streams, mesh=make_mesh(2, device="cpu"))


def _kinds(blob):
    return sorted({(st, c.kind, c.layout) for st, _, subs in archive.streams(blob) for c in subs})


CASES = {
    # the triangles' planes reach an LZ4 block (1 MiB), so the device match
    # search writes them; the colours take BP
    "lucy_like": lambda: dict(zip(("vertices", "triangles", "vertex_colors"), _mesh(420))),
    # vertices alone, a tail chunk in every plane
    "points": lambda: {"vertices": _mesh(37)[0]},
    # noisy bytes that LZ4 keeps, and a constant alpha plane (fill)
    "lz4_colors": lambda: {"vertices": _mesh(40)[0],
                           "vertex_colors": (np.random.default_rng(1).integers(
                               0, 4, 1600).astype(np.uint32) * 0x01010101) | 0xFF000000},
    "wide": lambda: {"vertices": _mesh(33)[0].astype(np.float64),
                     "triangles": _mesh(33)[1].astype(np.uint64) << np.uint64(33),
                     "vertex_normals": _mesh(33)[0],
                     "attributes_uint64": np.arange(1500, dtype=np.uint64) * 977},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_decodes_what_the_port_writes(case):
    from trico_tpu_torch.parallel import decompress_mesh, make_mesh
    streams = CASES[case]()
    blob = _write(**streams)
    got = decode_archive(blob)
    assert words_wrong(got, streams) == 0
    port = decompress_mesh(blob, make_mesh(1, device="cpu"))
    port = {("attributes_uint64" if k == "attribute_uint64" else k): v for k, v in port.items()}
    assert words_wrong(got, port) == 0


def test_the_cells_stream_kinds_are_all_covered():
    kinds = set()
    for case in ("lucy_like", "points", "lz4_colors"):
        kinds |= set(_kinds(_write(**CASES[case]())))
    assert {(1, "fp", "tpu"), (3, "lz4", "ref"), (3, "fill", "ref"), (13, "bp", "ref"),
            (13, "lz4", "ref"), (13, "fill", "ref")} <= kinds


def test_archives_decode_together_as_alone():
    a = _write(**CASES["points"]())
    b = _write(**CASES["lz4_colors"]())
    both = decode_archives([a, b])
    assert words_wrong(both[0], decode_archive(a)) == 0
    assert words_wrong(both[1], decode_archive(b)) == 0


@pytest.mark.parametrize("where", ["header", "size", "payload", "truncated"])
def test_a_broken_archive_does_not_decode_to_its_input(where):
    streams = CASES["lz4_colors"]()
    blob = bytearray(_write(**streams))
    if where == "header":
        blob[4] = 0
    elif where == "size":
        blob[9 + 4 + 1 + 1] ^= 0x10  # the first container's chunk length
    elif where == "payload":
        blob[len(blob) // 2] ^= 0x5A
    else:
        blob = blob[:-3]
    (got,) = decode_archives([bytes(blob)])
    assert isinstance(got, ValueError) or words_wrong(got, streams) > 0
