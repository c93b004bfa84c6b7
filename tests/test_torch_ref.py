"""The reference chunk layout in trico_tpu_torch.chunked (layout="ref") held
against trico_tpu.chunked's device path on JAX's CPU backend (use_tpu=True):
device predict and replay around the C++ host library's pack and parse, the
f32 adaptive search relaid out on the host, and trico_tpu's host dispatch
for f64 (adaptive chunks, or no host library). The same container bytes,
and containers that cross between the packages decode bit-exact."""

import numpy as np
import pytest

import trico_tpu.chunked as jc
import trico_tpu_torch.chunked as tc
from trico_tpu_torch.codec import fp_cuda, fp_torch

from torch_cases import (align_native, no_native, recording,  # noqa: F401
                         require_native, words, words64)

# the cases that hold the C++ host library's pack and parse of full chunks
# call require_native(); without the library the device pack and parse run
# (tests/test_torch_ref_device.py)
pytestmark = pytest.mark.usefixtures("align_native")


def _stream(n, seed=0):
    return words(5, max(n, 1), seed=seed).T.reshape(-1)[:n].copy()


def _stream64(n, seed=0):
    return words64(6, max(n, 1), seed=seed).T.reshape(-1)[:n].copy()


@pytest.mark.parametrize("n,L", [(3 * 1024 + 77, 1024), (2 * 4096, 4096),
                                 (100, 1024), (0, 1024)])
@pytest.mark.parametrize("opt", [False, "fast", True])
def test_ref_layout_f32_matches_jax(n, L, opt):
    vals = _stream(n, seed=n)
    got = tc.encode_chunked(vals, L, layout="ref", optimize=opt, device="cpu")
    assert got == jc.encode_chunked(vals, L, use_tpu=True, layout="ref",
                                    optimize=opt)
    assert jc.parse_container_header(got).layout == "ref"
    np.testing.assert_array_equal(tc.decode_chunked(got, device="cpu")[0], vals)
    for use_tpu in (True, False):
        np.testing.assert_array_equal(jc.decode_chunked(got, use_tpu=use_tpu)[0],
                                      vals)


@pytest.mark.parametrize("n,L", [(3 * 1024 + 77, 1024), (2 * 2048, 2048),
                                 (100, 1024)])
@pytest.mark.parametrize("opt", [False, "fast", True])
def test_ref_layout_f64_matches_jax(n, L, opt):
    """Fixed exponents: device predict and native pack; adaptive: trico_tpu's
    host best-of."""
    vals = _stream64(n, seed=n)
    got = tc.encode_chunked(vals, L, layout="ref", optimize=opt, device="cpu")
    assert got == jc.encode_chunked(vals, L, use_tpu=True, layout="ref",
                                    optimize=opt)
    back, bits = tc.decode_chunked(got, device="cpu")
    assert bits == 64
    np.testing.assert_array_equal(back, vals)
    np.testing.assert_array_equal(jc.decode_chunked(got, use_tpu=True)[0], vals)


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 0), (4, 10), (14, 18)])
def test_ref_layout_f32_exponents(e1, e2):
    """(14,18) predicts by the sort and decodes on the host, as do tables
    past DEVICE_TABLE_WORDS; the others replay on the device."""
    vals = _stream(2 * 1024 + 300, seed=e2)
    got = tc.encode_chunked(vals, 1024, e1, e2, layout="ref", device="cpu")
    assert got == jc.encode_chunked(vals, 1024, e1, e2, use_tpu=True, layout="ref")
    with recording(fp_cuda, "replay") as calls:
        np.testing.assert_array_equal(tc.decode_chunked(got, device="cpu")[0], vals)
    assert len(calls) == ((1 << e1) + (1 << e2) <= tc.DEVICE_TABLE_WORDS)


@pytest.mark.parametrize("e1,e2", [(4, 6), (10, 10), (10, 12), (20, 20)])
def test_ref_layout_f64_exponents(e1, e2):
    """Tables past DEVICE_TABLE_WORDS decode on the host."""
    require_native()  # without it every f64 reference-layout chunk is host-coded
    vals = _stream64(2 * 1024 + 300, seed=e1)
    got = tc.encode_chunked(vals, 1024, e1, e2, layout="ref", device="cpu")
    assert got == jc.encode_chunked(vals, 1024, e1, e2, use_tpu=True, layout="ref")
    with recording(fp_cuda, "replay64") as calls:
        np.testing.assert_array_equal(tc.decode_chunked(got, device="cpu")[0], vals)
    assert len(calls) == ((1 << e1) + (1 << e2) <= tc.DEVICE_TABLE_WORDS)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("opt", [False, True])
def test_port_decodes_jax_host_ref_containers(dtype, opt):
    """Reference-layout containers from trico_tpu's host encoder, the
    archives a CPU-only machine writes."""
    vals = (_stream if dtype == np.uint32 else _stream64)(4 * 1024 + 9, seed=2)
    blob = jc.encode_chunked(vals, 1024, use_tpu=False, layout="ref", optimize=opt)
    np.testing.assert_array_equal(tc.decode_chunked(blob, device="cpu")[0], vals)


def test_f32_ref_adaptive_relayout_without_native(monkeypatch):
    """The f32 adaptive search needs no host library in the reference layout:
    its v2 chunks are relaid out by the port's NumPy relayout."""
    vals = _stream(3 * 1024 + 5, seed=4)
    with_native = tc.encode_chunked(vals, 1024, layout="ref", optimize=True,
                                    device="cpu")
    no_native(monkeypatch)
    assert tc.encode_chunked(vals, 1024, layout="ref", optimize=True,
                             device="cpu") == with_native


@pytest.mark.parametrize("opt", [False, True])
def test_f64_ref_without_native_is_host_coded(monkeypatch, opt):
    vals = _stream64(3 * 1024 + 5, seed=6)
    with_native = tc.encode_chunked(vals, 1024, layout="ref", optimize=opt,
                                    device="cpu")
    no_native(monkeypatch)
    with recording(fp_cuda, "predict64_xors") as calls:
        got = tc.encode_chunked(vals, 1024, layout="ref", optimize=opt,
                                device="cpu")
    assert calls == [] and got == with_native
    assert got == jc.encode_chunked(vals, 1024, use_tpu=True, layout="ref",
                                    optimize=opt)
    with recording(fp_cuda, "replay64") as calls:
        np.testing.assert_array_equal(tc.decode_chunked(got, device="cpu")[0], vals)
    assert calls == []


def test_f32_ref_without_native_raises(monkeypatch):
    """Without the host library the f32 reference layout takes the device
    pack and parse (it raised until they were ported): the same container
    bytes as with the library, read back exact; a short stream (no full
    chunk) is host-coded, as in trico_tpu."""
    vals = _stream(2 * 1024, seed=8)
    with_native = tc.encode_chunked(vals, 1024, layout="ref", device="cpu")
    no_native(monkeypatch)
    with recording(fp_cuda, "logshift") as calls:
        blob = tc.encode_chunked(vals, 1024, layout="ref", device="cpu")
    assert len(calls) == 1 and blob == with_native
    assert blob == jc.encode_chunked(vals, 1024, use_tpu=True, layout="ref")
    np.testing.assert_array_equal(tc.decode_chunked(blob, device="cpu")[0], vals)
    short = vals[:1000]
    assert tc.encode_chunked(short, 1024, layout="ref", device="cpu") == \
        jc.encode_chunked(short, 1024, use_tpu=False, layout="ref")


def test_fp_entry_points_reject_unknown_layouts():
    vals = _stream(1024)
    with pytest.raises(ValueError, match="unknown layout"):
        tc.encode_chunked(vals, 1024, layout="v3", device="cpu")
    with pytest.raises(ValueError, match="unknown layout"):
        fp_torch.encode_f32(vals, 1024, layout="v3", device="cpu")
