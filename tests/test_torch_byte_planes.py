"""The byte planes of integer streams through the C++ host library
(``native.split_bytes`` / ``native.join_bytes``, behind
``codec.transpose``) held against the NumPy route byte for byte: every
integer width, lengths around a 64-element job edge and past the 2 MiB
threading threshold, non-contiguous and big-endian input; the fill flags
the split reports; a mesh archive written and read through either route;
and the tally's ``byte_planes.*`` entries. Tolerance: exact. Skips without
g++, as test_torch_native.py does."""

import types

import numpy as np
import pytest

from torch_cases import require_native
from trico_tpu_torch import chunked, native, profiling
from trico_tpu_torch.codec import transpose
from trico_tpu_torch.parallel import mesh_codec as mc

THREADED = 2 << 20  # bytes: a stream of this size and more runs on the pool
DTYPES = [np.uint8, np.uint16, np.int32, np.uint32, np.uint64]


@pytest.fixture(autouse=True)
def _needs_the_library():
    require_native()


def _numpy_route(monkeypatch):
    """Send ``transpose``'s byte planes through NumPy, and nothing else."""
    monkeypatch.setattr(transpose, "native", types.SimpleNamespace(available=lambda: False))


def _stream(dt, n: int, layout: str, seed: int = 0) -> np.ndarray:
    info = np.iinfo(dt)
    r = np.random.default_rng(seed + n)
    whole = r.integers(info.min, info.max, 2 * n, dtype=np.int64, endpoint=True) \
        if info.bits < 64 else r.integers(0, 1 << 64, 2 * n, dtype=np.uint64)
    whole = whole.astype(dt)
    if layout == "strided":
        return whole[::2]
    arr = whole[:n].copy()
    return arr.astype(arr.dtype.newbyteorder(">")) if layout == "big_endian" else arr


def _numpy_fills(planes) -> list:
    return [len(p) > 0 and not np.any(p != p[0]) for p in planes]


def _lengths(dt) -> list:
    return [0, 1, 63, 64, 65, THREADED // np.dtype(dt).itemsize + 1]


@pytest.mark.parametrize("layout", ["contiguous", "strided", "big_endian"])
@pytest.mark.parametrize("dt,n", [(dt, n) for dt in DTYPES for n in _lengths(dt)],
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_the_native_split_and_join_equal_numpy(dt, n, layout):
    arr = _stream(dt, n, layout)
    w = np.dtype(dt).itemsize
    want = transpose._byte_planes_numpy(arr)
    planes, fills = native.split_bytes(arr)
    assert planes.dtype == np.uint8 and planes.shape == (w, n) == want.shape
    np.testing.assert_array_equal(planes, want)
    assert list(fills) == _numpy_fills(want)
    # the join takes the rows of one buffer or separate buffers alike
    for given in (planes, [p.copy() for p in planes]):
        back = native.join_bytes(given, arr.dtype)
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr.reshape(-1))
        np.testing.assert_array_equal(back, transpose._from_byte_planes_numpy(list(want), arr.dtype))


@pytest.mark.parametrize("n", [65, THREADED // 4 + 1])
@pytest.mark.parametrize("case", ["constant", "last_byte_differs", "middle_byte_differs"])
@pytest.mark.parametrize("dt", DTYPES)
def test_the_fill_flags_equal_the_numpy_check(dt, case, n):
    w = np.dtype(dt).itemsize
    for k in range(w):  # the plane whose one byte differs
        arr = np.full(n, np.array(0xA5C3_E1F7_1234_5678, np.uint64).astype(dt), dt)
        if case != "constant":
            at = n - 1 if case == "last_byte_differs" else n // 2 + 7
            arr.view(np.uint8).reshape(n, w)[at, k] ^= 0x40
        planes, fills = native.split_bytes(arr)
        want = _numpy_fills(transpose._byte_planes_numpy(arr))
        assert list(fills) == want
        assert want == [case == "constant" or j != k for j in range(w)]


@pytest.mark.parametrize("dt", DTYPES)
def test_the_fill_flags_of_an_empty_stream_are_false(dt):
    planes, fills = native.split_bytes(np.zeros(0, dt))
    assert planes.shape == (np.dtype(dt).itemsize, 0) and not fills.any()


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_a_join_of_planes_of_different_lengths_raises(route, monkeypatch):
    if route == "numpy":
        _numpy_route(monkeypatch)
    planes = [np.zeros(10, np.uint8), np.zeros(10, np.uint8), np.zeros(9, np.uint8),
              np.zeros(10, np.uint8)]
    with pytest.raises(ValueError):
        transpose.from_byte_planes(planes, np.uint32)


def _mesh_streams(side: int = 41, seed: int = 3) -> dict:
    """A grid surface with its triangles and RGBA colours (opaque alpha: a
    fill plane)."""
    rng = np.random.default_rng(seed)
    v = np.arange(side * side)
    verts = np.stack([(v % side) * 0.01, (v // side) * 0.01,
                      np.sin(v * 0.05) + rng.normal(0, 1e-3, side * side)],
                     axis=1).astype(np.float32)
    i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1), indexing="ij")
    a = (i * side + j).ravel()
    tris = np.stack([np.stack([a, a + 1, a + side], 1),
                     np.stack([a + 1, a + side + 1, a + side], 1)], 1).reshape(-1, 3)
    rgb = rng.integers(0, 1 << 24, side * side, dtype=np.uint32)
    return {"vertices": verts, "triangles": tris.astype(np.uint32),
            "vertex_colors": rgb | np.uint32(0xFF000000)}


def _tally_since(before: dict, prefix: str) -> dict:
    now = profiling.tally()
    return {k: (c - before.get(k, (0, 0))[0], b - before.get(k, (0, 0))[1])
            for k, (c, b) in now.items()
            if k.startswith(prefix) and (c, b) != before.get(k, (0, 0))}


def test_a_mesh_archive_is_the_same_through_either_route(monkeypatch):
    monkeypatch.setattr(chunked, "DEFAULT_LZ4_BLOCK", 4096)
    streams = _mesh_streams()
    mesh = mc.make_mesh(1, device="cpu")

    def write_and_read(blobs):
        blob = mc.compress_mesh(**streams, chunk_len=256, mesh=mesh)
        stats: dict = {}
        back = [mc.decompress_mesh(b, mesh, route_stats=stats) for b in (blob, *blobs)]
        assert stats["host_lz4"] >= len(back)  # the colours are LZ4 planes
        for out in back:
            for name, arr in streams.items():
                assert np.array_equal(out[name].view(np.uint32), arr.view(np.uint32)), name
        return blob

    before = profiling.tally()
    ours = write_and_read([])
    assert set(_tally_since(before, "byte_planes.")) == {"byte_planes.split.native",
                                                         "byte_planes.join.native"}
    _numpy_route(monkeypatch)
    before = profiling.tally()
    assert write_and_read([ours]) == ours
    assert set(_tally_since(before, "byte_planes.")) == {"byte_planes.split.numpy",
                                                         "byte_planes.join.numpy"}


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_the_tally_counts_each_routes_calls_and_bytes(route, monkeypatch):
    if route == "numpy":
        _numpy_route(monkeypatch)
    streams = [np.arange(1000, dtype=np.uint32), np.arange(77, dtype=np.uint16),
               np.zeros(0, np.uint64)]
    before = profiling.tally()
    joined = [transpose.from_byte_planes(transpose.byte_planes(a), a.dtype) for a in streams]
    transpose.split_byte_planes(streams[0])
    nbytes = sum(a.nbytes for a in streams)
    assert _tally_since(before, "byte_planes.") == {
        f"byte_planes.split.{route}": (4, nbytes + streams[0].nbytes),
        f"byte_planes.join.{route}": (3, nbytes)}
    for a, b in zip(streams, joined):
        np.testing.assert_array_equal(a, b)
