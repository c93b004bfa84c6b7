"""trico_tpu_torch's archive reader against trico_tpu's writers and the other
way round, on JAX's CPU backend with trico_tpu.chunked._tpu_available
patched to True inside each test where a device host is meant: v0 and v1
archives of either package read bit-exact; the corpus mesh classes and a
color stream long enough for the device LZ4 search give the same bytes."""

import numpy as np
import pytest

import corpus
import trico_tpu.archive as ja
import trico_tpu.chunked as jc
import trico_tpu_torch as tt
from trico_tpu_torch.codec import lz4_torch

from test_torch_archive import _check_read, _write, synthetic
from torch_cases import align_native, recording, require_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("align_native")


@pytest.fixture
def device_host(monkeypatch):
    """trico_tpu's dispatch as on a host whose JAX backend is a device."""
    monkeypatch.setattr(jc, "_tpu_available", lambda: True)


def test_large_color_stream_runs_the_device_search(device_host):
    """2^20 + 4096 colors: three byte planes past one 1 MiB block each
    search on the device (the alpha plane is a fill container)."""
    require_native()  # the emitter behind the device search is C++
    r = np.random.default_rng(3)
    n = (1 << 20) + 4096
    q = np.repeat(r.integers(0, 256, n // 64 + 1), 64)[:n].astype(np.uint32)
    colors = 0xFF000000 | (q << 16) | ((q // 2) << 8) | (q // 4)
    streams = [("write_vertex_colors", colors)]
    with recording(lz4_torch, "find_matches") as calls:
        got = _write(tt.ArchiveWriter(chunk_len=4096, device="cpu"), streams)
    assert [tuple(c[0].shape) for c in calls] == [(1, 1 << 20)] * 3
    assert got == _write(ja.ArchiveWriter(chunk_len=4096), streams)
    _check_read(tt.ArchiveReader(got, device="cpu"), streams)


@pytest.mark.parametrize("name", sorted(corpus.generators()))
def test_corpus_classes_match_jax(name, device_host):
    mesh = corpus.generators()[name]()
    streams = [("write_vertices_double" if mesh["vertices"].dtype == np.float64
                else "write_vertices", mesh["vertices"])]
    tri = mesh["triangles"]
    streams.append(("write_triangles_long" if tri.dtype == np.uint64
                    else "write_triangles", tri))
    for key, method in (("vertex_normals", "write_vertex_normals"),
                        ("vertex_colors", "write_vertex_colors"),
                        ("uv_per_vertex", "write_uv_per_vertex")):
        if key in mesh:
            streams.append((method, mesh[key]))
    got = _write(tt.ArchiveWriter(chunk_len=4096, device="cpu"), streams)
    assert got == _write(ja.ArchiveWriter(chunk_len=4096), streams)
    _check_read(tt.ArchiveReader(got, device="cpu"), streams)


@pytest.mark.parametrize("kind", ["v0", "v0_python", "v1_tpu", "v1_ref",
                                  "v1_ref_cpu_host"])
def test_port_reads_jax_archives(kind, monkeypatch):
    """v0 archives (native and pure-Python writers), v1 archives of a device
    host in both layouts, and the reference-layout v1 archives a CPU-only
    host writes (with LZ4 planes from the host matcher)."""
    if "ref" in kind:
        require_native()  # f32 reference-layout chunks parse in C++
    streams = synthetic(seed=1)
    if kind.startswith("v0"):
        w = ja.ArchiveWriter(use_native=kind == "v0")
    else:
        monkeypatch.setattr(jc, "_tpu_available",
                            lambda: kind != "v1_ref_cpu_host")
        w = ja.ArchiveWriter(chunk_len=4096,
                             layout="tpu" if kind == "v1_tpu" else None)
    data = _write(w, streams)
    monkeypatch.undo()
    r = tt.ArchiveReader(data, device="cpu")
    assert r.version == (0 if kind.startswith("v0") else 1)
    _check_read(r, streams)


@pytest.mark.parametrize("layout", ["tpu", "ref"])
def test_jax_reads_port_archives(layout, device_host):
    if layout == "ref":
        require_native()  # the reference layout's pack is C++
    streams = synthetic(seed=2)
    data = _write(tt.ArchiveWriter(chunk_len=4096, layout=layout, device="cpu"),
                  streams)
    _check_read(ja.ArchiveReader(data), streams)


def test_v0_archives_stay_on_the_host():
    streams = synthetic(seed=4)
    got = _write(tt.ArchiveWriter(device="cpu"), streams)
    assert got == _write(ja.ArchiveWriter(), streams)
    assert tt.ArchiveReader(got, device="cpu").version == 0
