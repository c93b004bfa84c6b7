"""The port's mesh readers and writers (trico_tpu_torch/io/stl.py, ply.py)
held against trico_tpu.io's on the Stanford bunny and on meshes generated
from a seed with numpy: the same files, byte for byte, from the writers, and
the same arrays from the readers, on files of either package's writer and on
hand-written PLY variants. Tolerance: exact. No case needs the C++ toolchain
or a card."""

import dataclasses

import numpy as np
import pytest

from trico_tpu.io import ply as j_ply
from trico_tpu.io import stl as j_stl
from trico_tpu_torch.io import ply, stl


def _mesh(n, m, seed):
    r = np.random.default_rng(seed)
    t = np.linspace(0, 20, n)
    v = np.stack([np.sin(t), np.cos(t), t / 7 + r.normal(0, 1e-3, n)],
                 axis=1).astype(np.float32)
    nrm = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    col = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    tri = r.integers(0, n, (m, 3)).astype(np.uint32)
    uv = r.random((m, 6)).astype(np.float32)
    return v, nrm, col, tri, uv


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("full", [False, True])
def test_read_stl_bunny(bunny_path, full):
    _same_arrays(stl.read_stl(bunny_path, full=full),
                 j_stl.read_stl(bunny_path, full=full))


@pytest.mark.parametrize("seed,n,m", [(0, 50, 80), (1, 3, 1), (2, 400, 0), (3, 1000, 3000)])
@pytest.mark.parametrize("extras", [False, True])
def test_write_and_read_stl(tmp_path, seed, n, m, extras):
    v, _, _, tri, _ = _mesh(n, m, seed)
    nrm = stl.compute_triangle_normals(v, tri) if extras else None
    np.testing.assert_array_equal(
        stl.compute_triangle_normals(v, tri).view(np.uint32),
        j_stl.compute_triangle_normals(v, tri).view(np.uint32))
    attrs = (np.arange(m) * 7 % 65536).astype(np.uint16) if extras else None
    ours, theirs = tmp_path / "ours.stl", tmp_path / "theirs.stl"
    stl.write_stl(ours, v, tri, nrm, attrs)
    j_stl.write_stl(theirs, v, tri, nrm, attrs)
    assert ours.read_bytes() == theirs.read_bytes()
    for full in (False, True):
        _same_arrays(stl.read_stl(theirs, full=full), j_stl.read_stl(ours, full=full))


def test_dedup_vertices():
    r = np.random.default_rng(4)
    soup = r.integers(-3, 3, (600, 3)).astype(np.float32)
    soup[::7] = [0.0, -0.0, 0.0]  # signed zeros are one vertex
    _same_arrays(stl.dedup_vertices(soup), j_stl.dedup_vertices(soup))


@pytest.mark.parametrize("raw", [b"", b"x" * 83, b"solid ascii" + b" " * 100,
                                 b"\0" * 80 + (5).to_bytes(4, "little") + b"\0" * 60])
def test_read_stl_rejects_alike(tmp_path, raw):
    p = tmp_path / "bad.stl"
    p.write_bytes(raw)
    errors = []
    for mod in (stl, j_stl):
        with pytest.raises(Exception) as err:
            mod.read_stl(p)
        errors.append((err.type, str(err.value)))
    assert errors[0] == errors[1]


def _fields(mesh):
    return [getattr(mesh, f.name) for f in dataclasses.fields(mesh)]


@pytest.mark.parametrize("storage", ["binary_le", "binary_be", "ascii"])
@pytest.mark.parametrize("parts", ["all", "vertices", "no_uv", "colors"])
def test_write_and_read_ply(tmp_path, storage, parts):
    v, nrm, col, tri, uv = _mesh(120, 200, seed=len(parts))
    args = {"all": (v, nrm, col, tri, uv), "vertices": (v,),
            "no_uv": (v, nrm, col, tri), "colors": (v, None, col)}[parts]
    ours, theirs = tmp_path / "ours.ply", tmp_path / "theirs.ply"
    ply.write_ply(ours, *args, storage=storage)
    j_ply.write_ply(theirs, *args, storage=storage)
    assert ours.read_bytes() == theirs.read_bytes()
    _same_arrays(_fields(ply.read_ply(theirs)), _fields(j_ply.read_ply(ours)))
    got = ply.read_ply(ours)
    np.testing.assert_array_equal(got.vertices, v)
    if len(args) > 3:
        np.testing.assert_array_equal(got.triangles, tri)


def test_write_ply_bunny(tmp_path, bunny_path):
    v, tri = stl.read_stl(bunny_path)
    ours, theirs = tmp_path / "ours.ply", tmp_path / "theirs.ply"
    ply.write_ply(ours, v, triangles=tri)
    j_ply.write_ply(theirs, v, triangles=tri)
    assert ours.read_bytes() == theirs.read_bytes()
    _same_arrays(_fields(ply.read_ply(ours)), _fields(j_ply.read_ply(ours)))
    with pytest.raises(ValueError, match="storage"):
        ply.write_ply(ours, v, storage="text")


_HDR = (b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
        b"property float x\nproperty float y\nproperty float z\n")


def _handwritten():
    v5 = np.arange(15, dtype=np.float32).reshape(5, 3)
    ragged = bytearray(v5.tobytes())
    ragged += bytes([3]) + np.array([0, 1, 2], "<i4").tobytes()
    ragged += bytes([4]) + np.array([0, 2, 3, 4], "<i4").tobytes()
    d2 = np.array([[1.000000001, 2, 3], [4, 5, 6]], np.float64)
    return {
        "ascii_colors": b"""ply
format ascii 1.0
comment made by hand
element vertex 3
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element face 1
property list uchar int vertex_indices
end_header
0 0 0 255 0 0
1 0 0 0 255 0
0 1 0 0 0 255
3 0 1 2
""",
        "big_endian": (b"ply\nformat binary_big_endian 1.0\nelement vertex 2\n"
                       b"property float x\nproperty float y\nproperty float z\n"
                       b"end_header\n"
                       + np.array([[1, 2, 3], [4, 5, 6]], ">f4").tobytes()),
        "ragged_faces": (_HDR + b"element face 2\nproperty list uchar int "
                         b"vertex_indices\nend_header\n" + bytes(ragged)),
        "doubles": (b"ply\nformat binary_little_endian 1.0\nelement vertex 2\n"
                    b"property double x\nproperty double y\nproperty double z\n"
                    b"end_header\n" + d2.tobytes()),
        "diffuse_alias": (b"ply\nformat ascii 1.0\nelement vertex 2\n"
                          b"property float x\nproperty float y\nproperty float z\n"
                          b"property uchar diffuse_red\nproperty uchar diffuse_green\n"
                          b"property uchar diffuse_blue\nproperty uchar alpha\n"
                          b"end_header\n0 0 0 1 2 3 4\n1 1 1 5 6 7 8\n"),
        "texcoord_faces": (b"ply\nformat ascii 1.0\nelement vertex 3\n"
                           b"property float x\nproperty float y\nproperty float z\n"
                           b"element face 1\nproperty list uchar int vertex_index\n"
                           b"property list uchar float texcoord\nend_header\n"
                           b"0 0 0\n1 0 0\n0 1 0\n3 0 1 2 4 0.5 0.25 1 0\n"),
    }


@pytest.mark.parametrize("name", list(_handwritten()))
@pytest.mark.parametrize("keep_doubles", [False, True])
def test_read_handwritten_ply(tmp_path, name, keep_doubles):
    p = tmp_path / "m.ply"
    p.write_bytes(_handwritten()[name])
    _same_arrays(_fields(ply.read_ply(p, keep_doubles=keep_doubles)),
                 _fields(j_ply.read_ply(p, keep_doubles=keep_doubles)))


@pytest.mark.parametrize("raw", [b"", b"plx\n", b"ply\nformat ascii 1.0\n",
                                 _HDR + b"end_header\n" + b"\0" * 10])
def test_read_ply_rejects_alike(tmp_path, raw):
    p = tmp_path / "bad.ply"
    p.write_bytes(raw)
    errors = []
    for mod in (ply, j_ply):
        with pytest.raises(Exception) as err:
            mod.read_ply(p)
        errors.append((err.type, str(err.value)))
    assert errors[0] == errors[1]
