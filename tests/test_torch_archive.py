"""trico_tpu_torch.ArchiveWriter held against trico_tpu's writer as a device
host runs it (trico_tpu.chunked._tpu_available patched to True inside each
test): the same v1 archive bytes for every stream kind, both chunk layouts
and both chunked profiles, read back bit-exact by the port's reader.
test_torch_archive_read.py crosses the packages' readers and writers."""

import numpy as np
import pytest
import torch

import trico_tpu.archive as ja
import trico_tpu.chunked as jc
import trico_tpu_torch as tt
from conftest import mesh_like_floats
from trico_tpu.io.stl import read_stl

from torch_cases import align_native, require_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("align_native")


@pytest.fixture
def device_host(monkeypatch):
    """trico_tpu's dispatch as on a host whose JAX backend is a device."""
    monkeypatch.setattr(jc, "_tpu_available", lambda: True)


def _vec(n, width, seed, dtype):
    return np.stack([mesh_like_floats(n, seed + k, dtype) for k in range(width)],
                    axis=1)


def synthetic(n=5000, m=5000, seed=0):
    """One stream of every kind, as (writer method, array) pairs."""
    r = np.random.default_rng(seed)
    tri = np.sort(r.integers(0, n, (m, 3)), axis=0).astype(np.uint32)
    q = (np.arange(n) // 40 % 256).astype(np.uint32)
    colors = 0xFF000000 | (q << 16) | (q << 8) | q
    streams = []
    for suffix, dt in (("", np.float32), ("_double", np.float64)):
        streams += [
            (f"write_vertices{suffix}", _vec(n, 3, seed, dt)),
            (f"write_vertex_normals{suffix}", _vec(n, 3, seed + 3, dt) / 10),
            (f"write_triangle_normals{suffix}", _vec(m, 3, seed + 6, dt)),
            (f"write_uv_per_vertex{suffix}", _vec(n, 2, seed + 9, dt)),
            (f"write_uv_per_triangle{suffix}", _vec(m, 6, seed + 11, dt)),
            (f"write_attributes_{'double' if suffix else 'float'}",
             mesh_like_floats(n, seed + 17, dt)),
        ]
    streams += [
        ("write_triangles", tri),
        ("write_triangles_long", tri.astype(np.uint64) * 5),
        ("write_vertex_colors", colors),
        ("write_triangle_colors", r.integers(0, 3, m).astype(np.uint32)),
        ("write_attributes_uint8", (q % 7).astype(np.uint8)),
        ("write_attributes_uint16", (np.arange(n) // 3).astype(np.uint16)),
        ("write_attributes_uint32", r.integers(0, 1 << 32, n, dtype=np.uint64)
         .astype(np.uint32)),
        ("write_attributes_uint64", np.arange(n, dtype=np.uint64) << np.uint64(33)),
    ]
    return streams


def _write(writer, streams) -> bytes:
    for method, arr in streams:
        getattr(writer, method)(arr)
    return writer.tobytes()


def _check_read(reader, streams) -> None:
    got = list(reader.streams())
    assert len(got) == len(streams)
    for (method, want), (_, arr) in zip(streams, got):
        assert arr.dtype == want.dtype, method
        np.testing.assert_array_equal(arr.reshape(want.shape), want, err_msg=method)


@pytest.mark.parametrize("case", ["bunny", "synthetic"])
@pytest.mark.parametrize("layout", ["tpu", "ref"])
@pytest.mark.parametrize("opt", [True, "fast"])
def test_archive_matches_jax(case, layout, opt, device_host, request):
    if layout == "ref":
        require_native()  # the reference layout's pack and parse are C++
    if case == "bunny":
        verts, tris = read_stl(request.getfixturevalue("bunny_path"))
        streams = [("write_vertices", verts), ("write_triangles", tris)]
    else:
        streams = synthetic()
    got = _write(tt.ArchiveWriter(chunk_len=4096, layout=layout, optimize=opt,
                                  device="cpu"), streams)
    want = _write(ja.ArchiveWriter(chunk_len=4096, layout=layout, optimize=opt),
                  streams)
    assert got == want
    _check_read(tt.ArchiveReader(got, device="cpu"), streams)


def test_default_layout_is_the_device_hosts(bunny_vertices, device_host):
    """layout=None writes what trico_tpu writes where a device is up: v2."""
    streams = [("write_vertices", bunny_vertices)]
    got = _write(tt.ArchiveWriter(chunk_len=4096, device="cpu"), streams)
    assert got == _write(ja.ArchiveWriter(chunk_len=4096), streams)
    assert got == _write(tt.ArchiveWriter(chunk_len=4096, layout="tpu",
                                          device="cpu"), streams)


def test_typed_reads_and_skips():
    streams = synthetic(seed=5)[:4]
    data = _write(tt.ArchiveWriter(chunk_len=4096, device="cpu"), streams)
    r = tt.ArchiveReader(data, device="cpu")
    assert r.num_vertices() == len(streams[0][1])
    np.testing.assert_array_equal(r.read_vertices(), streams[0][1])
    with pytest.raises(ValueError, match="expected"):
        r.read_triangles()
    assert r.skip_next_stream()
    np.testing.assert_array_equal(r.read_triangle_normals(), streams[2][1])


def test_corrupt_bp_stream_raises():
    r = np.random.default_rng(0)
    n = 90000  # 5 full BP chunks of 16384 values and a tail
    tri = (np.repeat(np.cumsum(r.integers(0, 200, n // 8 + 1)), 8)[:n]
           + r.integers(0, 64, n)).astype(np.uint32).reshape(-1, 3)
    data = bytearray(_write(tt.ArchiveWriter(chunk_len=4096, device="cpu"),
                            [("write_triangles", tri)]))
    hdr = 8 + 5 + 4  # archive header, stream tag and count, substream size
    assert jc.parse_container_header(bytes(data[hdr:])).kind == "bp"
    first_width = hdr + 14 + 4 * 6  # container prefix, 6 chunk sizes
    data[first_width] = 40
    with pytest.raises(ValueError, match="corrupt BP32 chunk"):
        tt.ArchiveReader(bytes(data), device="cpu").read_triangles()


def test_devices_are_checked():
    with pytest.raises(ValueError):
        tt.ArchiveWriter(chunk_len=4096, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.ArchiveWriter(chunk_len=4096, device="cuda")
        data = tt.ArchiveWriter(device="cpu").tobytes()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.ArchiveReader(data, device="cuda")
