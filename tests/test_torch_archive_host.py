"""v0 and v1 archives of every stream kind, one stream each, written by one
package and read by the other, both ways: trico_tpu_torch.archive (its own
StreamType, _backends, ArchiveWriter and ArchiveReader) against
trico_tpu.archive. The bytes must be equal and every stream must read back
bit-exact. Each case runs with the NumPy fallbacks (both C++ libraries
switched off: no toolchain needed) and with the C++ host libraries (skipped
where g++ is missing). v1 archives are written as on a device host
(trico_tpu.chunked._tpu_available patched to True), in the "tpu" layout."""

import numpy as np
import pytest

import trico_tpu.archive as ja
import trico_tpu.chunked as jc
import trico_tpu_torch.archive as ta
from conftest import mesh_like_floats

from torch_cases import no_native, require_native


@pytest.fixture(params=[False, True], ids=["numpy", "native"])
def host(request, monkeypatch):
    if request.param:
        require_native()
    else:
        no_native(monkeypatch)
    monkeypatch.setattr(jc, "_tpu_available", lambda: True)
    return request.param


def _streams(n=600):
    r = np.random.default_rng(7)

    def vec(width, dt, seed):
        return np.stack([mesh_like_floats(n, seed + k, dt) for k in range(width)], axis=1)

    tri = np.sort(r.integers(0, n, (n, 3)), axis=0).astype(np.uint32)
    q = (np.arange(n) // 9 % 256).astype(np.uint32)
    out = {}
    for sfx, dt in (("", np.float32), ("_double", np.float64)):
        out[f"vertices{sfx}"] = vec(3, dt, 0)
        out[f"vertex_normals{sfx}"] = vec(3, dt, 3)
        out[f"triangle_normals{sfx}"] = vec(3, dt, 6)
        out[f"uv_per_vertex{sfx}"] = vec(2, dt, 9)
        out[f"uv_per_triangle{sfx}"] = vec(6, dt, 11)
    out.update({
        "attributes_float": mesh_like_floats(n, 17),
        "attributes_double": mesh_like_floats(n, 18, np.float64),
        "triangles": tri, "triangles_long": tri.astype(np.uint64) * 3,
        "vertex_colors": 0xFF000000 | (q << 8) | q,
        "triangle_colors": r.integers(0, 3, n).astype(np.uint32),
        "attributes_uint8": (q % 5).astype(np.uint8),
        "attributes_uint16": (np.arange(n) // 2).astype(np.uint16),
        "attributes_uint32": r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        "attributes_uint64": np.arange(n, dtype=np.uint64) << np.uint64(35),
    })
    return out


KINDS = list(_streams(8))


def test_stream_types_and_tables():
    assert [(s.name, int(s)) for s in ta.StreamType] == \
        [(s.name, int(s)) for s in ja.StreamType]
    for table in ("_FP_STREAMS", "_LZ4_STREAMS"):
        got = {k.name: v for k, v in getattr(ta, table).items()}
        assert got == {k.name: v for k, v in getattr(ja, table).items()}
    for k in ("MAGIC", "VERSION", "F32_EXP", "F64_EXP", "F32_EXP_CANDIDATES",
              "F32_EXP_CANDIDATES_MAX", "F64_EXP_CANDIDATES", "F64_EXP_CANDIDATES_MAX"):
        assert getattr(ta, k) == getattr(ja, k), k
    assert len(KINDS) == len(ta._FP_STREAMS) + len(ta._LZ4_STREAMS) == 20


@pytest.mark.parametrize("use_native", [True, False])
def test_backends_agree(host, use_native):
    """The four host codecs that _backends picks give the same bytes."""
    ours, theirs = ta._backends(use_native), ja._backends(use_native)
    vals = mesh_like_floats(300, 1).view(np.uint32)
    payload = bytes(ours[0](vals, 4, 10))
    assert payload == bytes(theirs[0](vals, 4, 10))
    np.testing.assert_array_equal(ours[1](payload, 32), theirs[1](payload, 32))
    plane = (np.arange(900) // 7 % 5).astype(np.uint8)
    block = bytes(ours[2](plane))
    assert block == bytes(theirs[2](plane))
    np.testing.assert_array_equal(ours[3](block, 900), theirs[3](block, 900))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("version", [0, 1])
def test_archives_cross_the_packages(host, kind, version):
    arr = _streams()[kind]
    kw = {"chunk_len": 256} if version else {}
    ours = ta.ArchiveWriter(device="cpu", **kw)
    theirs = ja.ArchiveWriter(**kw)
    for w in (ours, theirs):
        getattr(w, f"write_{kind}")(arr)
    data = ours.tobytes()
    assert data == theirs.tobytes()
    for reader in (ta.ArchiveReader(theirs.tobytes(), device="cpu"),
                   ja.ArchiveReader(data)):
        assert reader.version == version
        assert reader.next_stream_type.name == ta.ArchiveReader(
            data, device="cpu").next_stream_type.name
        back = getattr(reader, f"read_{kind}")()
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back.reshape(arr.shape).view(np.uint8),
                                      arr.view(np.uint8))
        assert reader.next_stream_type == 0


@pytest.mark.parametrize("opt", ["fast", "max", False])
def test_v0_profiles_match(host, opt):
    streams = _streams(300)
    ours, theirs = ta.ArchiveWriter(optimize=opt, device="cpu"), ja.ArchiveWriter(optimize=opt)
    for w in (ours, theirs):
        w.write_vertices(streams["vertices"])
        w.write_vertices_double(streams["vertices_double"])
        w.write_triangles(streams["triangles"])
    assert ours.tobytes() == theirs.tobytes()


def test_v0_pure_python_writer_matches(host):
    streams = _streams(200)
    ours = ta.ArchiveWriter(use_native=False, device="cpu")
    theirs = ja.ArchiveWriter(use_native=False)
    for w in (ours, theirs):
        w.write_vertices(streams["vertices"])
        w.write_attributes_uint16(streams["attributes_uint16"])
    assert ours.tobytes() == theirs.tobytes()
    r = ta.ArchiveReader(ours.tobytes(), use_native=False, device="cpu")
    np.testing.assert_array_equal(r.read_vertices(), streams["vertices"])


@pytest.mark.parametrize("case", ["empty", "magic", "version", "count", "sub",
                                  "wrong_kind"])
def test_damaged_archives_raise_alike(host, case):
    w = ta.ArchiveWriter(device="cpu")
    w.write_vertices(_streams(50)["vertices"])
    good = w.tobytes()
    data = {"empty": b"", "magic": b"Trcx" + good[4:],
            "version": good[:4] + (7).to_bytes(4, "little") + good[8:],
            "count": good[:10], "sub": good[:-3], "wrong_kind": good}[case]
    errors = []
    for make in (lambda d: ta.ArchiveReader(d, device="cpu"), ja.ArchiveReader):
        with pytest.raises(ValueError) as err:
            r = make(data)
            if case == "wrong_kind":
                r.read_triangles()
            else:
                r.read_vertices()
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_peeks_skips_and_iteration(host):
    streams = _streams(120)
    w = ta.ArchiveWriter(device="cpu")
    order = ["vertices", "triangles", "uv_per_vertex", "vertex_normals",
             "vertex_colors", "attributes_uint8"]
    for k in order:
        getattr(w, f"write_{k}")(streams[k])
    data = w.tobytes()
    ours, theirs = ta.ArchiveReader(data, device="cpu"), ja.ArchiveReader(data)
    peeks = ("num_vertices", "num_triangles", "num_uvs", "num_normals",
             "num_colors", "num_attributes")
    for step in range(len(order)):
        counts = [getattr(ours, p)() for p in peeks]
        assert counts == [getattr(theirs, p)() for p in peeks]
        assert sorted(counts)[-2:] == [0, len(streams[order[step]])]
        assert ours.skip_next_stream() and theirs.skip_next_stream()
    assert ours.next_stream_type == theirs.next_stream_type == 0
    got = [(st.name, a.shape) for st, a in ta.ArchiveReader(data, device="cpu").streams()]
    assert got == [(st.name, a.shape) for st, a in ja.ArchiveReader(data).streams()]
    assert len(got) == len(order)
