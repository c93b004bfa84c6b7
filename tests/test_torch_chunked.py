"""trico_tpu_torch.chunked (the v1 container entry points) held against
trico_tpu.chunked on JAX's CPU backend, for f32 (uint32) and f64 (uint64)
streams and every optimize profile: the same container bytes, and
containers that cross between the packages in both directions decode
bit-exact."""

import struct

import numpy as np
import pytest
import torch

import trico_tpu.chunked as jc
from trico_tpu.codec import fp64_jax, fp_jax
import trico_tpu_torch.chunked as tc
from trico_tpu_torch.codec import fp64_torch

from torch_cases import no_native, words, words64


def _stream(n, seed=0):
    """n values with every kind of row interleaved, so each chunk mixes
    smooth floats, zeros, constants and NaN/inf bit patterns."""
    return words(5, max(n, 1), seed=seed).T.reshape(-1)[:n].copy()


def _stream64(n, seed=0):
    """n doubles with every kind of words64 row interleaved."""
    return words64(6, max(n, 1), seed=seed).T.reshape(-1)[:n].copy()


@pytest.mark.parametrize("n,L", [(3 * 1024 + 77, 1024), (2 * 4096, 4096),
                                 (4096 + 5, 4096), (100, 1024), (0, 1024),
                                 (1024, 1024), (9, 8)])
@pytest.mark.parametrize("opt", [False, "fast", True])
def test_encode_chunked_matches_jax(n, L, opt):
    vals = _stream(n, seed=n)
    got = tc.encode_chunked(vals, L, optimize=opt, device="cpu")
    want = jc.encode_chunked(vals, L, use_tpu=True, layout="tpu", optimize=opt)
    assert got == want
    back, bits = tc.decode_chunked(got, device="cpu")
    assert bits == 32 and back.dtype == np.uint32
    np.testing.assert_array_equal(back, vals)


@pytest.mark.parametrize("e1,e2", [(4, 6), (4, 10), (0, 6), (0, 0)])
def test_encode_chunked_exponents_match_jax(e1, e2):
    vals = _stream(2 * 1024 + 300, seed=e2)
    got = tc.encode_chunked(vals, 1024, e1, e2, device="cpu")
    want = jc.encode_chunked(vals, 1024, e1, e2, use_tpu=True, layout="tpu")
    assert got == want


@pytest.mark.parametrize("n,L", [(3 * 1024 + 77, 1024), (2 * 2048, 2048),
                                 (2048 + 5, 2049), (100, 1024), (0, 1024),
                                 (9, 3)])
@pytest.mark.parametrize("opt", [False, "fast", True])
def test_encode_chunked_f64_matches_jax(n, L, opt):
    """Odd chunk lengths round down to even; the default exponents are
    (20,20), whose chunks decode on the host."""
    vals = _stream64(n, seed=n)
    got = tc.encode_chunked(vals, L, optimize=opt, device="cpu")
    want = jc.encode_chunked(vals, L, use_tpu=True, layout="tpu", optimize=opt)
    assert got == want
    back, bits = tc.decode_chunked(got, device="cpu")
    assert bits == 64 and back.dtype == np.uint64
    np.testing.assert_array_equal(back, vals)


@pytest.mark.parametrize("e1,e2", [(4, 6), (4, 10), (0, 6), (0, 0), (10, 12),
                                   (20, 20)])
def test_encode_chunked_f64_exponents_match_jax(e1, e2):
    vals = _stream64(2 * 1024 + 300, seed=e2)
    got = tc.encode_chunked(vals, 1024, e1, e2, device="cpu")
    assert got == jc.encode_chunked(vals, 1024, e1, e2, use_tpu=True, layout="tpu")
    np.testing.assert_array_equal(tc.decode_chunked(got, device="cpu")[0], vals)


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 0), (10, 12), (14, 18)])
def test_port_decodes_jax_containers(e1, e2):
    """(10,12) and (14,18) exceed the device table bound and take the host
    decoder; the others decode on the device path."""
    vals = _stream(3 * 1024 + 10, seed=e1)
    blob = jc.encode_chunked(vals, 1024, e1, e2, use_tpu=False, layout="tpu")
    back, bits = tc.decode_chunked(blob, device="cpu")
    np.testing.assert_array_equal(back, vals)


@pytest.mark.parametrize("e1,e2,opt", [(4, 6, False), (20, 20, False),
                                       (None, None, True)])
def test_port_decodes_jax_f64_containers(e1, e2, opt):
    """Containers of trico_tpu's host encoder, (20,20) and the adaptive mix
    on host threads, the rest on the device path."""
    vals = np.concatenate([_stream64(3 * 1024, seed=4),
                           np.arange(1024, dtype=np.uint64) * 977])
    blob = jc.encode_chunked(vals, 1024, e1, e2, use_tpu=False, layout="tpu",
                             optimize=opt)
    back, bits = tc.decode_chunked(blob, device="cpu")
    assert bits == 64
    np.testing.assert_array_equal(back, vals)


@pytest.mark.parametrize("opt", [False, True])
def test_jax_decodes_port_f64_containers(opt):
    vals = _stream64(3 * 1024 + 3, seed=9)
    blob = tc.encode_chunked(vals, 1024, 4, 6, optimize=opt, device="cpu")
    for use_tpu in (True, False):
        back, bits = jc.decode_chunked(blob, use_tpu=use_tpu)
        assert bits == 64
        np.testing.assert_array_equal(back, vals)


def test_port_decodes_jax_adaptive_container():
    """optimize=True mixes hash_info bytes across chunks, (14,18) among
    them; decode groups chunks by hash_info."""
    vals = np.concatenate([_stream(4 * 1024, seed=3),
                           np.arange(4 * 1024, dtype=np.uint32) * 977])
    blob = jc.encode_chunked(vals, 1024, use_tpu=True, layout="tpu",
                             optimize=True)
    back, _ = tc.decode_chunked(blob, device="cpu")
    np.testing.assert_array_equal(back, vals)


@pytest.mark.parametrize("opt", [False, "fast"])
def test_jax_decodes_port_containers(opt):
    vals = _stream(5 * 1024 + 3, seed=9)
    blob = tc.encode_chunked(vals, 1024, optimize=opt, device="cpu")
    for use_tpu in (True, False):
        back, bits = jc.decode_chunked(blob, use_tpu=use_tpu)
        np.testing.assert_array_equal(back, vals)


def test_bunny_matches_jax(bunny_vertices):
    for axis in range(3):
        plane = np.ascontiguousarray(bunny_vertices[:, axis]).view(np.uint32)
        got = tc.encode_chunked(plane, device="cpu")
        assert got == jc.encode_chunked(plane, use_tpu=True, layout="tpu")
        np.testing.assert_array_equal(tc.decode_chunked(got, device="cpu")[0],
                                      plane)


def test_bunny_f64_matches_jax(bunny_vertices):
    """The bunny widened to doubles: the (20,20) default on every axis, and
    the adaptive search on one."""
    for axis in range(3):
        plane = bunny_vertices[:, axis].astype(np.float64).view(np.uint64)
        for opt in (False, True) if axis == 0 else (False,):
            got = tc.encode_chunked(plane, optimize=opt, device="cpu")
            assert got == jc.encode_chunked(plane, use_tpu=True, layout="tpu",
                                            optimize=opt)
            np.testing.assert_array_equal(
                tc.decode_chunked(got, device="cpu")[0], plane)


def test_host_fallbacks_without_native_library(monkeypatch):
    """With the C++ host library absent, tails and big-table chunks take the
    NumPy codecs and the bytes do not change."""
    vals = _stream(2 * 1024 + 50, seed=1)
    with_native = tc.encode_chunked(vals, 1024, device="cpu")
    big = jc.encode_chunked(vals, 1024, 14, 18, use_tpu=False, layout="tpu")
    no_native(monkeypatch)
    assert tc.encode_chunked(vals, 1024, device="cpu") == with_native
    np.testing.assert_array_equal(tc.decode_chunked(big, device="cpu")[0], vals)


def test_f64_host_fallbacks_without_native_library(monkeypatch):
    """Without the C++ host library, f64 tails and (20,20) chunks take the
    NumPy codecs (and the port's relayout) and the bytes do not change."""
    vals = _stream64(2 * 1024 + 50, seed=1)
    with_native = tc.encode_chunked(vals, 1024, device="cpu")
    no_native(monkeypatch)
    assert tc.encode_chunked(vals, 1024, device="cpu") == with_native
    np.testing.assert_array_equal(tc.decode_chunked(with_native, device="cpu")[0],
                                  vals)


@pytest.mark.parametrize("case", ["f64", "ref", "optimize", "float32"])
def test_unported_encodes_raise(case, monkeypatch):
    """What has no counterpart raises: a reference-layout f64 adaptive chunk
    encode (none exists in fp64_jax either); an unknown layout. Float arrays
    are not raw bits. The f32 reference layout without the C++ host library,
    which raised until its device pack was ported, gives trico_tpu's
    bytes."""
    no_native(monkeypatch)
    if case == "f64":
        with pytest.raises(ValueError):
            fp64_torch.encode_f64_adaptive(np.zeros(16, np.uint64), 8,
                                           layout="ref", device="cpu")
        return
    if case == "ref":
        for vals in (np.zeros(16, np.uint32), _stream(5 * 8 + 3, seed=2)):
            got = tc.encode_chunked(vals, 8, layout="ref", device="cpu")
            assert got == jc.encode_chunked(vals, 8, use_tpu=True, layout="ref")
        return
    vals = np.zeros(16, np.float32 if case == "float32" else np.uint32)
    kw = {"float32": {}, "optimize": {"layout": "v3", "optimize": True}}[case]
    err = {"float32": TypeError, "optimize": ValueError}[case]
    with pytest.raises(err):
        tc.encode_chunked(vals, 8, device="cpu", **kw)


@pytest.mark.parametrize("case", ["f64", "ref", "lz4"])
def test_unported_decodes_raise(case, monkeypatch):
    """Without the C++ host library an f32 reference-layout container is
    parsed on the device (it raised until that parse was ported), where f64
    ones are host-decoded (trico_tpu/chunked.py:708-710); non-FP containers
    are refused."""
    no_native(monkeypatch)
    if case == "lz4":
        blob = jc.encode_lz4_chunked(np.zeros(64, np.uint8), use_tpu=False)
        with pytest.raises(ValueError):
            tc.decode_chunked(blob, device="cpu")
        return
    vals = np.arange(16, dtype=np.uint64 if case == "f64" else np.uint32)
    blob = jc.encode_chunked(vals, 8, use_tpu=False, layout="ref")
    np.testing.assert_array_equal(tc.decode_chunked(blob, device="cpu")[0], vals)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    vals = np.zeros(16, np.uint32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.encode_chunked(vals, 8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.decode_chunked(tc.encode_chunked(vals, 8, device="cpu"),
                          device="cuda")


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        tc.encode_chunked(np.zeros(16, np.uint32), 8, device="meta")


def test_corrupt_framing_raises():
    blob = tc.encode_chunked(_stream(2048), 1024, device="cpu")
    with pytest.raises(ValueError):
        tc.decode_chunked(blob[:20], device="cpu")
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 6, 5000)  # total no longer matches n_chunks
    with pytest.raises(ValueError):
        tc.decode_chunked(bytes(bad), device="cpu")


def test_format_constants_match_trico_tpu():
    assert tc.DEFAULT_CHUNK_LEN == jc.DEFAULT_CHUNK_LEN
    assert tc.F32_TPU_EXP == jc.F32_TPU_EXP
    assert tc.F32_TPU_CANDIDATES_FAST == fp_jax.F32_TPU_CANDIDATES_FAST
    assert tc.F32_TPU_CANDIDATES == fp_jax.F32_TPU_CANDIDATES
    assert tc.F64_TPU_CANDIDATES == fp64_jax.F64_TPU_CANDIDATES
    assert tc.F64_TPU_CANDIDATES_FAST == fp64_jax.F64_TPU_CANDIDATES_FAST
    assert tc.DEVICE_TABLE_WORDS == 1 << 12
