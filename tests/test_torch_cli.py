"""``python -m trico_tpu_torch encode|decode`` held against trico_tpu's CLI:
the version-1 encode (the port's default, ``--chunked`` there) run in process
as a device host runs it (trico_tpu.chunked._tpu_available patched to True
inside each test) and the version-0 encode with either host backend
(``--backend`` here, the default there). The same archive bytes from the
bunny STL and from a PLY with colors, uvs and normals, geometry that comes
back equal to the input, and ``--profile`` reports with trico_tpu's stage
names."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

import trico_tpu.chunked as jc
from trico_tpu import cli as jcli
from trico_tpu.archive import ArchiveReader, StreamType
from trico_tpu.io import ply, stl
from trico_tpu_torch import cli

from torch_cases import align_native  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.usefixtures("align_native")


@pytest.fixture
def device_host(monkeypatch):
    monkeypatch.setattr(jc, "_tpu_available", lambda: True)


@pytest.fixture
def mesh_ply(tmp_path):
    """A PLY whose vertices, normals, colors (alpha 0xFF) and per-triangle
    uvs are smooth enough for every codec path to matter."""
    r = np.random.default_rng(0)
    n, m = 6000, 9000
    t = np.linspace(0, 30, n)
    v = np.stack([np.sin(t), np.cos(t), t / 10], axis=1).astype(np.float32)
    nrm = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    q = (np.arange(n) // 16 % 256).astype(np.uint32)
    col = 0xFF000000 | (q << 16) | (q << 8) | (255 - q)
    tri = np.sort(r.integers(0, n, (m, 3)), axis=0).astype(np.uint32)
    uv = np.repeat(np.linspace(0, 1, m, dtype=np.float32)[:, None], 6, axis=1)
    src = tmp_path / "m.ply"
    ply.write_ply(src, v, nrm, col, tri, uv)
    return src, (v, nrm, col, tri, uv)


@pytest.mark.parametrize("extra", [[], ["--fast"]])
def test_stl_encode_matches_jax(tmp_path, bunny_path, device_host, extra):
    ours, theirs = tmp_path / "ours.trc", tmp_path / "theirs.trc"
    assert cli.main(["encode", "-i", str(bunny_path), "-o", str(ours),
                     "--chunked", "--device", "cpu", *extra]) == 0
    assert jcli.main(["encode", "-i", str(bunny_path), "-o", str(theirs),
                      "--chunked", *extra]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    # the version-1 archive is the default, --chunked or not
    assert cli.main(["encode", "-i", str(bunny_path), "-o", str(tmp_path / "d.trc"),
                     "--device", "cpu", *extra]) == 0
    assert (tmp_path / "d.trc").read_bytes() == ours.read_bytes()
    # the option the port had before --chunked means the same
    assert cli.main(["encode", "-i", str(bunny_path), "-o", str(tmp_path / "c.trc"),
                     "--chunk-len", "4096", "--device", "cpu", *extra]) == 0
    assert (tmp_path / "c.trc").read_bytes() == ours.read_bytes()
    back = tmp_path / "back.stl"
    assert cli.main(["decode", "-i", str(ours), "-o", str(back),
                     "--device", "cpu"]) == 0
    v0, t0 = stl.read_stl(bunny_path)
    v1, t1 = stl.read_stl(back)
    np.testing.assert_array_equal(v1.view(np.uint32), v0.view(np.uint32))
    np.testing.assert_array_equal(t1, t0)


def test_stladd_matches_jax(tmp_path, bunny_path, device_host):
    ours, theirs = tmp_path / "ours.trc", tmp_path / "theirs.trc"
    flags = ["-stladd", "normal", "-stladd", "uint16"]
    cli.encoder_main(["-i", str(bunny_path), "-o", str(ours), "--chunked",
                      "--device", "cpu", *flags])
    jcli.encoder_main(["-i", str(bunny_path), "-o", str(theirs), "--chunked",
                       *flags])
    assert ours.read_bytes() == theirs.read_bytes()
    kinds = [st.name for st, _ in ArchiveReader(ours.read_bytes()).streams()]
    assert kinds == ["vertex_float", "triangle_uint32", "triangle_normal_float",
                     "attribute_uint16"]


def test_ply_encode_matches_jax(tmp_path, mesh_ply, device_host):
    src, (v, nrm, col, tri, uv) = mesh_ply
    ours, theirs = tmp_path / "ours.trc", tmp_path / "theirs.trc"
    assert cli.encoder_main(["-i", str(src), "-o", str(ours), "--chunked",
                             "--device", "cpu"]) == 0
    assert jcli.encoder_main(["-i", str(src), "-o", str(theirs), "--chunked"]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    # the default output name, then the decode picks PLY by content
    assert cli.encoder_main(["-i", str(src), "--chunked", "--device", "cpu"]) == 0
    assert (tmp_path / "m.trc").read_bytes() == ours.read_bytes()
    assert cli.decoder_main(["-i", str(tmp_path / "m.trc"), "--device", "cpu"]) == 0
    m = ply.read_ply(tmp_path / "m.ply")
    for got, want in ((m.vertices, v), (m.vertex_normals, nrm),
                      (m.vertex_colors, col), (m.triangles, tri),
                      (m.texcoords, uv)):
        np.testing.assert_array_equal(got, want)


def test_plyskip(tmp_path, mesh_ply):
    src, (v, _, _, tri, _) = mesh_ply
    trc = tmp_path / "skip.trc"
    assert cli.encoder_main(["-i", str(src), "-o", str(trc), "--chunked",
                             "--device", "cpu", "-plyskip", "normal", "-plyskip", "color",
                             "-plyskip", "tex_coord"]) == 0
    r = ArchiveReader(trc.read_bytes())
    assert r.next_stream_type == StreamType.vertex_float
    streams = list(r.streams())
    assert [st.name for st, _ in streams] == ["vertex_float", "triangle_uint32"]
    np.testing.assert_array_equal(streams[0][1], v)
    np.testing.assert_array_equal(streams[1][1], tri)


def test_decode_reads_v0_archives(tmp_path, bunny_path):
    trc, back = tmp_path / "v0.trc", tmp_path / "back.stl"
    assert jcli.encoder_main(["-i", str(bunny_path), "-o", str(trc)]) == 0
    assert cli.decoder_main(["-i", str(trc), "-o", str(back), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(stl.read_stl(back)[0], stl.read_stl(bunny_path)[0])


def test_usage_and_errors(tmp_path, capsys, bunny_path, monkeypatch):
    assert cli.main([]) == 0
    assert cli.main(["frobnicate"]) == 1
    bad = tmp_path / "m.obj"
    bad.write_bytes(b"")
    assert cli.encoder_main(["-i", str(bad), "--device", "cpu"]) == 1
    # --device defaults to the card, and there is no carrying on without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in ([], ["--chunked"], ["--chunked", "--backend", "numpy"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.encoder_main(["-i", str(bunny_path), "-o", str(tmp_path / "x.trc"),
                              *flags])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.decoder_main(["-i", str(bad)])
    # a version-0 archive is what --backend asks for: written on the host,
    # it needs no device
    assert cli.encoder_main(["-i", str(bunny_path), "-o", str(tmp_path / "x.trc"),
                             "--backend", "auto"]) == 0
    assert ArchiveReader((tmp_path / "x.trc").read_bytes()).version == 0
    for flags in (["--backend", "jax"], ["--chunked", "0"], ["--chunk-len", "-4"],
                  ["--chunked", "1024", "--chunk-len", "1024"]):
        with pytest.raises(SystemExit):
            cli.encoder_main(["-i", str(bunny_path), "--device", "cpu", *flags])


def test_module_entry_point_runs(tmp_path, bunny_path):
    out = tmp_path / "x.trc"
    res = subprocess.run([sys.executable, "-m", "trico_tpu_torch", "encode",
                          "-i", str(bunny_path), "-o", str(out), "--chunked",
                          "--device", "cpu", "--profile"],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "encode_vertices" in res.stderr and "GB/s" in res.stderr
    assert ArchiveReader(out.read_bytes()).version == 1


@pytest.mark.parametrize("backend", ["native", "numpy", "auto"])
@pytest.mark.parametrize("extra", [[], ["--fast"]])
def test_v0_stl_encode_matches_jax(tmp_path, bunny_path, backend, extra):
    """With --backend: a reference-compatible version-0 archive, the bytes
    of trico_tpu's CLI with the same host backend, read back by both."""
    ours, theirs = tmp_path / "ours.trc", tmp_path / "theirs.trc"
    flags = ["--backend", backend, "-stladd", "normal", "-stladd", "uint16", *extra]
    assert cli.main(["encode", "-i", str(bunny_path), "-o", str(ours), *flags]) == 0
    assert jcli.main(["encode", "-i", str(bunny_path), "-o", str(theirs), *flags]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert ArchiveReader(ours.read_bytes()).version == 0
    back = tmp_path / "back.stl"
    assert cli.main(["decode", "-i", str(ours), "-o", str(back),
                     "--device", "cpu"]) == 0
    for a, b in zip(stl.read_stl(bunny_path, full=True), stl.read_stl(back, full=True)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_v0_ply_encode_matches_jax(tmp_path, mesh_ply, backend):
    src, (v, nrm, col, tri, uv) = mesh_ply
    ours, theirs = tmp_path / "ours.trc", tmp_path / "theirs.trc"
    assert cli.encoder_main(["-i", str(src), "-o", str(ours),
                             "--backend", backend]) == 0
    assert jcli.encoder_main(["-i", str(src), "-o", str(theirs),
                              "--backend", backend]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    got = [arr for _, arr in ArchiveReader(ours.read_bytes()).streams()]
    for g, want in zip(got, (v, tri, nrm, col, uv.reshape(-1, 2))):
        np.testing.assert_array_equal(g.reshape(want.shape), want)


def test_chunked_takes_a_chunk_length(tmp_path, bunny_path, device_host):
    ours, theirs = tmp_path / "ours.trc", tmp_path / "theirs.trc"
    assert cli.encoder_main(["-i", str(bunny_path), "-o", str(ours),
                             "--chunked", "1024", "--device", "cpu"]) == 0
    assert jcli.encoder_main(["-i", str(bunny_path), "-o", str(theirs),
                              "--chunked", "1024"]) == 0
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("chunked", [False, True])
def test_profile_reports_the_stage_names(tmp_path, capsys, bunny_path, chunked,
                                         device_host):
    """--profile prints one row a stage to stderr, named as trico_tpu's."""
    trc, back = tmp_path / "b.trc", tmp_path / "b.stl"
    flags = ["--chunked", "--device", "cpu"] if chunked else ["--backend", "auto"]
    capsys.readouterr()
    assert cli.encoder_main(["-i", str(bunny_path), "-o", str(trc), "--profile",
                             "-stladd", "normal", *flags]) == 0
    ours = capsys.readouterr().err
    assert jcli.encoder_main(["-i", str(bunny_path), "-o", str(tmp_path / "j.trc"),
                              "--profile", "-stladd", "normal",
                              *(["--chunked"] if chunked else [])]) == 0
    theirs = capsys.readouterr().err
    names = ["read_stl", "encode_vertices", "encode_triangles",
             "encode_tri_normals", "write_archive"]
    assert [ln.split()[0] for ln in ours.splitlines()] == names
    assert [ln.split()[0] for ln in theirs.splitlines()] == names
    assert cli.decoder_main(["-i", str(trc), "-o", str(back), "--device", "cpu",
                             "--profile"]) == 0
    ours = capsys.readouterr().err
    assert jcli.decoder_main(["-i", str(trc), "-o", str(tmp_path / "j.stl"),
                              "--profile"]) == 0
    theirs = capsys.readouterr().err
    names = ["decode_vertex_float", "decode_triangle_uint32",
             "decode_triangle_normal_float", "write_mesh"]
    assert [ln.split()[0] for ln in ours.splitlines()] == names
    assert [ln.split()[0] for ln in theirs.splitlines()] == names
    assert "GB/s" in ours
    # without --profile nothing is printed
    assert cli.decoder_main(["-i", str(trc), "-o", str(back), "--device", "cpu"]) == 0
    assert capsys.readouterr().err == ""


def test_ply_profile_stage_names(tmp_path, capsys, mesh_ply):
    src, _ = mesh_ply
    capsys.readouterr()
    assert cli.encoder_main(["-i", str(src), "-o", str(tmp_path / "m.trc"),
                             "--backend", "auto", "--profile"]) == 0
    names = [ln.split()[0] for ln in capsys.readouterr().err.splitlines()]
    assert names == ["read_ply", "encode_vertices", "encode_triangles",
                     "encode_normals", "encode_colors", "encode_uvs",
                     "write_archive"]


def test_package_exports_match_trico_tpu():
    import trico_tpu
    import trico_tpu_torch

    for name in trico_tpu.__all__:
        assert name in trico_tpu_torch.__all__ and hasattr(trico_tpu_torch, name), name
