"""Corrupt input through the port's sharded decoders: the counterparts of
tests/test_robustness.py:150-297.

Each mutated archive or container goes to both packages, trico_tpu on
JAX's 8 CPU devices and the port on CPU shards; the outcome must be the
same: the same arrays, or an exception from both. Framing that is corrupt
must raise ValueError before anything is launched: the device decodes of
the port are recorded and must not have been called.
"""

import struct

import jax
import numpy as np
import pytest

import trico_tpu.chunked as jchunked
from conftest import mesh_like_floats
from trico_tpu.parallel import mesh_codec as jmc
from trico_tpu_torch import chunked
from trico_tpu_torch.codec import bp_ref, bp_torch, fp64_torch, fp_torch
from trico_tpu_torch.parallel import mesh_codec as mc

DEVICE_DECODES = ((fp_torch, "decode_f32_chunks_v2"),
                  (fp64_torch, "decode_f64_chunks_v2"),
                  (bp_torch, "decode_bp32_chunks"), (bp_torch, "decode_bp64_chunks"))


@pytest.fixture
def launched(monkeypatch):
    """The names of the device decodes called during the test."""
    calls = []
    for module, name in DEVICE_DECODES:
        real = getattr(module, name)

        def record(*args, real=real, name=name):
            calls.append(name)
            return real(*args)

        monkeypatch.setattr(module, name, record)
    return calls


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 CPU devices")
    return jmc.make_mesh(8)


def cpu_mesh(n=8):
    return mc.make_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def case(jmesh):
    """tests/test_robustness.py:150-157's archive: 900 vertices, 500
    triangles, chunks of 128."""
    verts = np.stack([mesh_like_floats(900, s) for s in (0, 1, 2)], axis=1)
    tris = np.random.default_rng(3).integers(0, 900, (500, 3)).astype(np.uint32)
    blob = mc.compress_mesh(verts, tris, chunk_len=128, mesh=cpu_mesh())
    assert blob == jmc.compress_mesh(verts, tris, chunk_len=128, mesh=jmesh)
    return verts, tris, blob


def outcome(decode, data):
    try:
        return decode(data)
    except Exception as e:  # noqa: BLE001 - any exception is an outcome
        return e


def same_outcome(a, b) -> bool:
    if isinstance(a, Exception) or isinstance(b, Exception):
        return isinstance(a, Exception) and isinstance(b, Exception)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(same_outcome(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def check_mutant(data, jmesh, verts, tris, what):
    got = outcome(lambda d: mc.decompress_mesh(d, cpu_mesh()), data)
    want = outcome(lambda d: jmc.decompress_mesh(d, jmesh), data)
    assert same_outcome(got, want), f"{what}: {got!r} against {want!r}"
    if not isinstance(got, Exception):  # what decodes must not be wrong
        assert (np.array_equal(got["vertices"].view(np.uint32), verts.view(np.uint32))
                and np.array_equal(got["triangles"], tris)), f"{what} decoded wrong"


@pytest.mark.parametrize("cut", [9, 20, 60, 1 / 3, 1 / 2, -5])
def test_decompress_mesh_truncation(case, jmesh, cut):
    verts, tris, blob = case
    n = cut if isinstance(cut, int) and cut > 0 else (
        len(blob) + cut if isinstance(cut, int) else int(len(blob) * cut))
    check_mutant(blob[:n], jmesh, verts, tris, f"cut at {n}")


@pytest.mark.parametrize("part", range(4))
def test_decompress_mesh_bitflips(case, jmesh, part):
    """tests/test_robustness.py:177-195's 24 flips from seed 4, six a case;
    a flip that decodes must not give the original back unchanged."""
    verts, tris, blob = case
    rng = np.random.default_rng(4)
    positions = [int(rng.integers(8, len(blob))) for _ in range(24)]
    for pos in positions[6 * part : 6 * part + 6]:
        mut = bytearray(blob)
        mut[pos] ^= 0xFF
        got = outcome(lambda d: mc.decompress_mesh(d, cpu_mesh()), bytes(mut))
        want = outcome(lambda d: jmc.decompress_mesh(d, jmesh), bytes(mut))
        assert same_outcome(got, want), f"flip at {pos}: {got!r} against {want!r}"
        if not isinstance(got, Exception):
            assert not (got["vertices"].shape == verts.shape
                        and np.array_equal(got["vertices"].view(np.uint32),
                                           verts.view(np.uint32))
                        and np.array_equal(got["triangles"], tris)), \
                f"bit flip at {pos} silently absorbed"


def test_oversized_chunk_size_raises_before_any_launch(launched):
    vals = mesh_like_floats(1024, 7).view(np.uint32)
    cont = bytearray(chunked.encode_chunked(vals, 128, device="cpu"))
    struct.pack_into("<I", cont, 14, 1 << 30)  # the first chunk's size
    with pytest.raises(ValueError):
        mc.decode_plane_sharded(bytes(cont), cpu_mesh())
    with pytest.raises(ValueError):
        chunked.decode_chunked(bytes(cont), device="cpu")
    assert launched == []


@pytest.mark.parametrize("kind", ["bp", "fp"])
def test_chunk_count_mismatch_raises_before_any_launch(launched, kind):
    vals = np.arange(4096, dtype=np.uint32)
    if kind == "bp":
        cont, dec = chunked.encode_bp_chunked(vals, 512, device="cpu"), mc.decode_bp_sharded
    else:
        cont, dec = chunked.encode_chunked(vals, 512, device="cpu"), mc.decode_plane_sharded
    mut = bytearray(cont)
    n_chunks = struct.unpack_from("<I", mut, 10)[0]
    assert n_chunks > 1
    struct.pack_into("<I", mut, 10, n_chunks - 1)
    with pytest.raises(ValueError):
        dec(bytes(mut), cpu_mesh())
    assert launched == []


def test_bp_width_corruption_raises_before_any_launch(launched, jmesh):
    vals = np.arange(2048, dtype=np.uint32)
    cont = bytearray(chunked.encode_bp_chunked(vals, 512, device="cpu"))
    n_chunks = int.from_bytes(cont[10:14], "little")
    cont[14 + 4 * n_chunks] = 200  # the first chunk's first group width
    for dec in (lambda d: mc.decode_bp_sharded(d, cpu_mesh()),
                lambda d: chunked.decode_bp_chunked(d, device="cpu"),
                lambda d: jmc.decode_bp_sharded(d, jmesh)):
        with pytest.raises(ValueError):
            dec(bytes(cont))
    assert launched == []


def test_bp64_device_bound_8192(launched, jmesh):
    """8192 is the last BP64 chunk length the device decodes; the encoder
    caps longer requests to it."""
    vals = np.random.default_rng(5).integers(0, 1 << 40, 3 * 8192 + 100).astype(np.uint64)
    cont = chunked.encode_bp_chunked(vals, 8193, device="cpu")
    assert chunked.parse_container_header(cont).chunk_len == 8192
    assert cont == jchunked.encode_bp_chunked(vals, 8193, use_tpu=False)
    np.testing.assert_array_equal(mc.decode_bp_sharded(cont, cpu_mesh(2)), vals)
    assert launched == ["decode_bp64_chunks"] * 2


def test_foreign_bp64_chunks_past_8192_decode_on_the_host(launched, jmesh):
    """A foreign encoder's BP64 container with 8224-value chunks (a multiple
    of 32 past 8192): the sharded decode routes it to the host, exact."""
    vals = np.random.default_rng(5).integers(0, 1 << 40, 3 * 8192 + 100).astype(np.uint64)
    big = 8224
    payloads = [bp_ref.encode_chunk(vals[s : s + big]) for s in range(0, len(vals), big)]
    cont = (struct.pack("<BBIII", 1, 8 | 1, big, len(vals), len(payloads))
            + struct.pack(f"<{len(payloads)}I", *map(len, payloads)) + b"".join(payloads))
    out = mc.decode_bp_sharded(cont, cpu_mesh())
    np.testing.assert_array_equal(out, vals)
    np.testing.assert_array_equal(out, jmc.decode_bp_sharded(cont, jmesh))
    assert launched == []
