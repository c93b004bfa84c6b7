"""trico_tpu_torch.parallel.mesh_codec against trico_tpu.parallel.mesh_codec.

The same arrays go to both packages: to trico_tpu on JAX's 8 CPU devices (as
tests/test_parallel.py runs it) and to the port on meshes of CPU shards
(``make_mesh(n, device="cpu")``, the plain versions of the kernels). Tolerance:
byte equality of every archive, container and payload, and ``np.array_equal``
on the raw bits of every decoded stream. One counterpart per test of
tests/test_parallel.py, and the sharded decodes of tests/test_fp64_jax.py:153
and tests/test_bp.py:142-164.
"""

import struct

import jax
import numpy as np
import pytest
import torch

import trico_tpu.chunked as jchunked
import trico_tpu_torch as tt
from conftest import mesh_like_floats
from torch_cases import no_native, tpu_native_available
from trico_tpu.parallel import mesh_codec as jmc
from trico_tpu_torch import chunked, profiling, shards
from trico_tpu_torch.codec import fp_ref, fp_torch
from trico_tpu_torch.parallel import mesh_codec as mc


@pytest.fixture(scope="module", autouse=True)
def aligned():
    """The LZ4 bytes of the host codecs depend on whether a package's C++
    library is built; where only one of the two built, both run on their
    NumPy fallbacks for the whole module (its reference archives too)."""
    with pytest.MonkeyPatch.context() as mp:
        if tpu_native_available() != tt.native.available():
            no_native(mp)
        yield


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 CPU devices")
    return jmc.make_mesh(8)


def cpu_mesh(n):
    return mc.make_mesh(n, device="cpu")


def verts_of(n, seeds, dtype=np.float32):
    return np.stack([mesh_like_floats(n, seed=s, dtype=dtype) for s in seeds],
                    axis=1)


# ---------------------------------------------------------------------------
# encode_planes and roundtrip_step (tests/test_parallel.py:18-73)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planes_ref(jmesh):
    L = 128
    planes = np.stack([mesh_like_floats(40 * L + 19, seed=s).view(np.uint32)
                       for s in (0, 1, 2)])
    return L, planes, jmc.encode_planes(planes, chunk_len=L, mesh=jmesh)


def test_encode_planes_matches_trico_tpu_and_the_oracle(planes_ref):
    L, planes, (jp, js, jo, jt) = planes_ref
    payloads, sizes, offsets, tails = mc.encode_planes(planes, chunk_len=L,
                                                       mesh=cpu_mesh(8))
    assert payloads.shape == jp.shape == (3, 40, fp_torch.f32_max_chunk_bytes(L))
    np.testing.assert_array_equal(payloads, jp)
    np.testing.assert_array_equal(sizes, js)
    np.testing.assert_array_equal(offsets, jo)
    for a, b in zip(tails, jt):
        np.testing.assert_array_equal(a, b)
    for p in range(3):
        for c in range(40):
            # v2 payloads are a byte permutation of the reference layout
            want = fp_ref.compress(planes[p, c * L : (c + 1) * L], 4, 10)
            got = fp_torch.relayout_f32_v2_to_v1(payloads[p, c, : sizes[p, c]])
            assert got.tobytes() == want
    flat = sizes.reshape(-1)
    np.testing.assert_array_equal(offsets.reshape(-1),
                                  np.concatenate([[0], np.cumsum(flat)[:-1]]))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8, 41])
def test_encode_planes_shard_count_invariance(planes_ref, n_shards):
    """Shards may be uneven (3, and 41 shards for 40 chunks: one empty) and
    the payloads do not change."""
    L, planes, (jp, js, jo, _) = planes_ref
    payloads, sizes, offsets, _ = mc.encode_planes(planes, chunk_len=L,
                                                   mesh=cpu_mesh(n_shards))
    np.testing.assert_array_equal(payloads, jp)
    np.testing.assert_array_equal(sizes, js)
    np.testing.assert_array_equal(offsets, jo)


def test_roundtrip_step_matches_trico_tpu(jmesh):
    import jax.numpy as jnp

    L = 64
    vals = np.stack([mesh_like_floats(16 * L, seed=s).view(np.uint32).reshape(16, L)
                     for s in (0, 1, 2)])
    j_exact, j_total, j_offsets = jax.jit(
        lambda v: jmc.roundtrip_step(v, L, jmesh))(jnp.asarray(vals))
    for values in (vals, tt._u32.from_numpy(vals)):
        exact, total, offsets = mc.roundtrip_step(values, L, cpu_mesh(8))
        assert torch.is_tensor(exact) and bool(exact) and bool(j_exact)
        assert int(total) == int(j_total) > 0
        np.testing.assert_array_equal(offsets.numpy(), np.asarray(j_offsets))


def test_point_cloud_container_sharded(jmesh):
    """The point-cloud configuration at 100,000 points: sharded encode,
    the ordered gather into one container per plane, a bit-exact decode."""
    n, L = 100_000, 4096
    pts = np.stack([mesh_like_floats(n, seed=s) for s in (1, 2, 3)], axis=1)
    planes = np.ascontiguousarray(pts.T).view(np.uint32).reshape(3, n)
    payloads, sizes, _, tails = mc.encode_planes(planes, chunk_len=L,
                                                 mesh=cpu_mesh(8))
    jp, js, _, _ = jmc.encode_planes(planes, chunk_len=L, mesh=jmesh)
    np.testing.assert_array_equal(payloads, jp)
    np.testing.assert_array_equal(sizes, js)
    for p in range(3):
        parts = [payloads[p, c, : sizes[p, c]].tobytes()
                 for c in range(payloads.shape[1])]
        parts.append(chunked._host_fp_encode(tails[p], 4, 10))
        blob = (struct.pack("<BBIII", 1, 4, L, n, len(parts))
                + struct.pack(f"<{len(parts)}I", *map(len, parts)) + b"".join(parts))
        out, bits = chunked.decode_chunked(blob, device="cpu")
        assert bits == 32
        np.testing.assert_array_equal(out, planes[p])
        np.testing.assert_array_equal(mc.decode_plane_sharded(blob, cpu_mesh(2)),
                                      planes[p])


# ---------------------------------------------------------------------------
# compress_mesh (tests/test_parallel.py:106-141, 200-283)
# ---------------------------------------------------------------------------


def writer_bytes(verts, tris, L, optimize):
    """What ``compress_mesh`` must write, from the port's single-device
    writer; at optimize=False the f32 chunks keep the v0 default (4,10)
    (trico_tpu/parallel/mesh_codec.py:237), which the writer maps to (4,6),
    so that stream is framed from ``encode_chunked`` at (4,10)."""
    if verts.dtype == np.float32 and optimize is False:
        planes = np.ascontiguousarray(verts.view(np.uint32).T)
        out = [struct.pack("<II", 0x6F637254, 1),
               struct.pack("<BI", int(tt.StreamType.vertex_float), len(verts))]
        for plane in planes:
            c = chunked.encode_chunked(plane, L, 4, 10, device="cpu")
            out += [struct.pack("<I", len(c)), c]
        w = tt.ArchiveWriter(chunk_len=L, layout="tpu", device="cpu")
        w.write_triangles(tris)
        return b"".join(out) + w.tobytes()[8:]
    w = tt.ArchiveWriter(chunk_len=L, layout="tpu", optimize=optimize, device="cpu")
    (w.write_vertices if verts.dtype == np.float32 else w.write_vertices_double)(verts)
    w.write_triangles(tris)
    return w.tobytes()


@pytest.fixture(scope="module")
def archive_case(jmesh):
    """Vertices of 3000 points (chunks of 256: 11 full and a partial last
    one), quantised like CAD data, where the full search wins chunks, and
    5000 triangles; trico_tpu's archives of them by dtype and profile."""
    n, L = 3000, 256
    verts = (np.round(verts_of(n, (4, 5, 6)) * 64) / 64).astype(np.float32)
    tris = np.random.default_rng(0).integers(0, n, (5000, 3)).astype(np.uint32)
    ref = {}
    for dt in (np.float32, np.float64):
        for opt in (True, "fast", False):
            ref[dt, opt] = jmc.compress_mesh(verts.astype(dt), tris, chunk_len=L,
                                             mesh=jmesh, optimize=opt)
    return L, verts, tris, ref


@pytest.mark.parametrize("optimize", [True, "fast", False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compress_mesh_matches_trico_tpu_and_the_writer(archive_case, dtype,
                                                        optimize):
    L, verts, tris, ref = archive_case
    v = verts.astype(dtype)
    blob = mc.compress_mesh(v, tris, chunk_len=L, mesh=cpu_mesh(8),
                            optimize=optimize)
    assert blob == ref[dtype, optimize]
    assert blob == writer_bytes(v, tris, L, optimize)
    r = tt.ArchiveReader(blob, device="cpu")
    np.testing.assert_array_equal(
        (r.read_vertices() if dtype == np.float32 else r.read_vertices_double()), v)
    np.testing.assert_array_equal(r.read_triangles(), tris)
    out = mc.decompress_mesh(blob, cpu_mesh(3))
    assert out["vertices"].dtype == dtype
    np.testing.assert_array_equal(out["vertices"].view(np.uint8), v.view(np.uint8))
    np.testing.assert_array_equal(out["triangles"], tris)


@pytest.mark.parametrize("n_shards", [1, 2, 5, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compress_mesh_shard_count_invariance(archive_case, dtype, n_shards):
    L, verts, tris, ref = archive_case
    blob = mc.compress_mesh(verts.astype(dtype), tris, chunk_len=L,
                            mesh=cpu_mesh(n_shards))
    assert blob == ref[dtype, True]


def test_full_search_wins_on_quantised_data(archive_case):
    """The profiles take different paths: the full search is smaller than
    "fast" on quantised data, which is smaller than fixed exponents."""
    _, _, _, ref = archive_case
    for dt in (np.float32, np.float64):
        assert len(ref[dt, True]) < len(ref[dt, "fast"])
    assert len(ref[np.float32, True]) < len(ref[np.float32, False])


def full_streams(n=1500, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        vertices=verts_of(n, (1, 2, 3)),
        triangles=rng.integers(0, n, (2200, 3)).astype(np.uint32),
        vertex_normals=verts_of(n, (4, 5, 6)),
        vertex_colors=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        uv_per_vertex=verts_of(n, (7, 8)))


def test_full_streams_roundtrip_and_route_stats(jmesh):
    """Vertices, triangles, normals, colors and uvs: one archive, the bytes
    of trico_tpu's, read back bit-exact by decompress_mesh and by the port's
    ArchiveReader, with trico_tpu's route counts."""
    s = full_streams()
    kw = dict(vertex_normals=s["vertex_normals"], vertex_colors=s["vertex_colors"],
              uv_per_vertex=s["uv_per_vertex"], chunk_len=128)
    blob = mc.compress_mesh(s["vertices"], s["triangles"], mesh=cpu_mesh(8), **kw)
    assert blob == jmc.compress_mesh(s["vertices"], s["triangles"], mesh=jmesh, **kw)
    stats, jstats = {}, {}
    out = mc.decompress_mesh(blob, cpu_mesh(4), route_stats=stats)
    jmc.decompress_mesh(blob, jmesh, route_stats=jstats)
    assert stats == jstats == {"sharded_fp": 8, "sharded_bp": 1, "host_lz4": 1,
                               "host_other": 0}
    assert set(out) == set(s)
    for name, want in s.items():
        assert out[name].dtype == want.dtype
        np.testing.assert_array_equal(out[name], want)
    r = tt.ArchiveReader(blob, device="cpu")
    np.testing.assert_array_equal(r.read_vertices(), s["vertices"])
    np.testing.assert_array_equal(r.read_triangles(), s["triangles"])
    np.testing.assert_array_equal(r.read_vertex_normals(), s["vertex_normals"])
    np.testing.assert_array_equal(r.read_vertex_colors(), s["vertex_colors"])
    np.testing.assert_array_equal(r.read_uv_per_vertex(), s["uv_per_vertex"])


def test_every_stream_kind_of_compress_mesh(jmesh):
    """Every stream kind compress_mesh takes, with the uv-per-triangle count
    quirk and u64 triangles: trico_tpu's bytes, and decompress_mesh gives
    trico_tpu's arrays and route counts."""
    n = 700
    rng = np.random.default_rng(9)
    tris = rng.integers(0, n, (900, 3)).astype(np.uint64) << np.uint64(33)
    kw = dict(triangle_normals=verts_of(900, (1, 2, 3)),
              attributes_uint16=(np.arange(n) * 7).astype(np.uint16),
              vertex_normals=verts_of(n, (4, 5, 6)),
              vertex_colors=(np.arange(n, dtype=np.uint32) // 3) | np.uint32(0xFF000000),
              uv_per_triangle=verts_of(3 * 900, (7, 8)),
              uv_per_vertex=verts_of(n, (9, 10)),
              attributes_uint8=(np.arange(n) % 5).astype(np.uint8),
              attributes_uint32=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
              attributes_uint64=np.arange(n, dtype=np.uint64) << np.uint64(40),
              chunk_len=64)
    verts = verts_of(n, (11, 12, 13), np.float64)
    blob = mc.compress_mesh(verts, tris, mesh=cpu_mesh(8), **kw)
    assert blob == jmc.compress_mesh(verts, tris, mesh=jmesh, **kw)
    stats, jstats = {}, {}
    out = mc.decompress_mesh(blob, cpu_mesh(2), route_stats=stats)
    jout = jmc.decompress_mesh(blob, jmesh, route_stats=jstats)
    assert stats == jstats
    assert stats["sharded_fp"] == 13 and sum(stats.values()) == 13 + 6
    assert sorted(out) == sorted(jout)
    for name in jout:
        assert out[name].dtype == jout[name].dtype, name
        np.testing.assert_array_equal(out[name], jout[name])
    np.testing.assert_array_equal(out["vertices"], verts)
    np.testing.assert_array_equal(out["triangles"], tris)
    np.testing.assert_array_equal(out["uv_per_triangle"], kw["uv_per_triangle"])


@pytest.mark.parametrize("kind", ["attributes_uint8", "attributes_uint16",
                                  "vertex_colors"])
def test_compress_mesh_constant_integer_stream(jmesh, kind):
    """A constant integer stream becomes fill containers (encode_int_best),
    uint8 attributes too, as in trico_tpu."""
    dtype, name = {"attributes_uint8": (np.uint8, "attribute_uint8"),
                   "attributes_uint16": (np.uint16, "attribute_uint16"),
                   "vertex_colors": (np.uint32, "vertex_colors")}[kind]
    verts = verts_of(300, (1, 2, 3))
    kw = {kind: np.full(300, 7, dtype), "chunk_len": 64}
    blob = mc.compress_mesh(verts, mesh=cpu_mesh(2), **kw)
    assert blob == jmc.compress_mesh(verts, mesh=jmesh, **kw)
    np.testing.assert_array_equal(
        mc.decompress_mesh(blob, cpu_mesh(2))[name], kw[kind])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compress_mesh_empty_stream(jmesh, dtype):
    verts = np.zeros((0, 3), dtype)
    blob = mc.compress_mesh(verts, mesh=cpu_mesh(8))
    assert blob == jmc.compress_mesh(verts, mesh=jmesh)
    out = mc.decompress_mesh(blob, cpu_mesh(8))
    assert out["vertices"].shape == (0, 3) and out["vertices"].dtype == dtype


# ---------------------------------------------------------------------------
# the sharded decodes (tests/test_parallel.py:144-155, test_fp64_jax.py:153,
# test_bp.py:142-164)
# ---------------------------------------------------------------------------


def test_decode_vertices_sharded(jmesh):
    vals = mesh_like_floats(4096 + 37, seed=10).view(np.uint32)
    blob = chunked.encode_chunked(vals, chunk_len=512, device="cpu")
    out = mc.decode_vertices_sharded(blob, mesh=cpu_mesh(8))
    assert out.dtype == np.uint32
    np.testing.assert_array_equal(out, vals)
    np.testing.assert_array_equal(out, jmc.decode_vertices_sharded(blob, jmesh))


def test_decode_plane_sharded_mixed_f64_groups(jmesh):
    """An adaptive f64 container whose chunks mix device groups and groups
    whose tables pass DEVICE_TABLE_WORDS, which decode on the host."""
    vals = mesh_like_floats(6 * 512 + 64, seed=35, dtype=np.float64).view(np.uint64)
    blob = chunked.encode_chunked(vals, chunk_len=512, optimize=True, device="cpu")
    _, sizes, off = chunked.parse_validated_framing(blob)
    infos = set()
    for s in sizes[:-1]:
        infos.add(fp_torch.exponents(blob[off]))
        off += s
    big = [(1 << e1) + (1 << e2) > chunked.DEVICE_TABLE_WORDS for e1, e2 in infos]
    assert any(big) and not all(big)
    out = mc.decode_plane_sharded(blob, cpu_mesh(4))
    assert out.dtype == np.uint64
    np.testing.assert_array_equal(out, vals)
    np.testing.assert_array_equal(out, jmc.decode_plane_sharded(blob, jmesh))


@pytest.mark.parametrize("width", [32, 64])
def test_decode_bp_sharded(jmesh, bunny_triangles, width):
    flat = bunny_triangles.reshape(-1).astype(np.uint32)
    if width == 64:
        flat = flat.astype(np.uint64) * np.uint64(3_000_000_017)
    blob = chunked.encode_bp_chunked(flat, chunk_len=512, device="cpu")
    assert blob == jchunked.encode_bp_chunked(flat, chunk_len=512, use_tpu=False)
    out = mc.decode_bp_sharded(blob, cpu_mesh(4))
    assert out.dtype == flat.dtype
    np.testing.assert_array_equal(out, flat)
    np.testing.assert_array_equal(out, jmc.decode_bp_sharded(blob, jmesh))


def test_compress_mesh_bunny_uses_bp(jmesh, bunny_vertices, bunny_triangles):
    blob = mc.compress_mesh(bunny_vertices, bunny_triangles, mesh=cpu_mesh(4))
    assert blob == jmc.compress_mesh(bunny_vertices, bunny_triangles, mesh=jmesh)
    stats = {}
    out = mc.decompress_mesh(blob, cpu_mesh(4), route_stats=stats)
    assert stats["sharded_bp"] == 1 and stats["sharded_fp"] == 3
    np.testing.assert_array_equal(out["vertices"], bunny_vertices)
    np.testing.assert_array_equal(out["triangles"], bunny_triangles)


# ---------------------------------------------------------------------------
# the mesh, the device, profiling
# ---------------------------------------------------------------------------


def test_make_mesh_lists_its_shards():
    m = cpu_mesh(4)
    assert m.shards == (torch.device("cpu"),) * 4
    assert (m.size, m.rank, m.world_size, m.group) == (4, 0, 1, None)
    assert mc.make_mesh(device="cpu").size == 1
    for bad in (0, -1):
        with pytest.raises(ValueError):
            cpu_mesh(bad)
    with pytest.raises(ValueError):
        mc.make_mesh(2, device="meta")
    assert [shards.shard_bounds(10, cpu_mesh(k)) for k in (1, 3, 4)] == [
        [0, 10], [0, 3, 6, 10], [0, 2, 5, 7, 10]]


def test_no_card_no_cpu_fallback():
    """make_mesh() and the entry points without a mesh run on the card, or
    raise; none goes on to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    verts = verts_of(300, (1, 2, 3))
    blob = mc.compress_mesh(verts, chunk_len=64, mesh=cpu_mesh(2))
    container = chunked.encode_chunked(verts[:, 0].copy().view(np.uint32), 64,
                                       device="cpu")
    for call in (mc.make_mesh, lambda: mc.make_mesh(2), lambda: mc.compress_mesh(verts),
                 lambda: mc.decompress_mesh(blob),
                 lambda: mc.decode_plane_sharded(container),
                 lambda: mc.encode_planes(verts.T.copy().view(np.uint32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_compress_mesh_profile_stages():
    prof = profiling.StageTimer()
    s = full_streams(n=700)
    blob = mc.compress_mesh(s["vertices"], s["triangles"], chunk_len=128,
                            mesh=cpu_mesh(2), profile=prof)
    # a stage enters the timer when it ends: the copies before the encode
    # that holds them, the byte planes before int_encode (700 vertices and
    # 2200 triangles: no LZ4 block and no BP chunk is full, so neither runs
    # on the device)
    assert list(prof.stages) == ["fp_split", "fp_h2d", "fp_d2h", "fp_device_encode",
                                 "fp_gather", "fp_assembly", "fp_tails", "fp_frame",
                                 "write.vertices", "int_planes", "int_encode",
                                 "write.triangles", "archive_join"]
    assert prof.stages["fp_assembly"].calls == 3
    assert blob == mc.compress_mesh(s["vertices"], s["triangles"], chunk_len=128,
                                    mesh=cpu_mesh(2))


@pytest.mark.parametrize("n_shards", [1, 3])
def test_process_group_of_one_takes_the_collectives(archive_case, n_shards):
    """With torch.distributed initialized (gloo, a world of one) the mesh
    spans the default group and the gathers are dist.all_gather calls; the
    bytes do not change."""
    import socket

    import torch.distributed as dist

    L, verts, tris, ref = archive_case
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = cpu_mesh(n_shards)
        assert mesh.group is not None and (mesh.rank, mesh.world_size) == (0, 1)
        blob = mc.compress_mesh(verts, tris, chunk_len=L, mesh=mesh)
        out = mc.decompress_mesh(blob, mesh)
    finally:
        dist.destroy_process_group()
    assert blob == ref[np.float32, True]
    np.testing.assert_array_equal(out["vertices"], verts)
    np.testing.assert_array_equal(out["triangles"], tris)
