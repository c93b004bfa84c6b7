"""trico_tpu_torch's LZ4 match search (codec/lz4_torch.py), LZ4 container
(chunked.encode_lz4_chunked) and pick-best integer coding
(chunked.encode_int_best) held against trico_tpu's device path on JAX's CPU
backend (lz4_jax, use_tpu=True) and the NumPy mirror find_matches_np: the
same candidates, the same container bytes and the same substream lists,
exact equality of every byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trico_tpu.chunked as jc
import trico_tpu_torch.chunked as tc
from trico_tpu.codec import lz4_jax
from trico_tpu_torch.codec import lz4_torch

from torch_cases import (align_native, no_native, recording,  # noqa: F401
                         require_native)
from torch_int_cases import KINDS, int_cases as _int_cases, plane as _plane

# the emitter behind the device match search is in the C++ host library: the
# cases that reach it call require_native()
pytestmark = pytest.mark.usefixtures("align_native")


@pytest.mark.parametrize("kind", KINDS)
def test_find_matches_matches_jax_and_numpy(kind):
    blocks = np.stack([_plane(kind, 4096, seed=s) for s in range(3)])
    off, rle = lz4_torch.find_matches(torch.from_numpy(blocks))
    want_off, want_rle = lz4_jax.find_matches(jnp.asarray(blocks))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    np.testing.assert_array_equal(rle.numpy(), np.asarray(want_rle))
    np_off, np_rle = lz4_jax.find_matches_np(blocks)
    np.testing.assert_array_equal(off.numpy(), np_off)
    np.testing.assert_array_equal(rle.numpy(), np_rle)
    assert off.dtype == rle.dtype == torch.int32


def test_find_matches_offsets_are_not_capped():
    """Offsets past LZ4's 64 KiB window are kept, as in lz4_jax: the host
    emitter drops what it cannot use."""
    block = np.zeros(70000, np.uint8)
    block[10:14] = block[69000:69004] = [0x41, 0x42, 0x43, 0x44]
    off, _ = lz4_torch.find_matches(torch.from_numpy(block[None]))
    want, _ = lz4_jax.find_matches(jnp.asarray(block[None]))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want))
    assert off[0, 69000] == 69000 - 10


def test_hash_matches_uint32_arithmetic():
    """The Knuth hash of 4-byte windows at the edges of the u32 range."""
    r = np.random.default_rng(0)
    w4 = np.concatenate([np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                                  np.uint32),
                         r.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)])
    want = (w4 * np.uint32(2654435761)) >> np.uint32(19)
    got = lz4_torch._hash(torch.from_numpy(w4.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [3 * 4096 + 17, 4096])
def test_lz4_container_matches_jax(kind, n):
    plane = _plane(kind, n, seed=n)
    got = tc.encode_lz4_chunked(plane, 4096, device="cpu")
    assert got == jc.encode_lz4_chunked(plane, 4096, use_tpu=True)
    np.testing.assert_array_equal(jc.decode_lz4_chunked(got), plane)


def test_lz4_container_at_the_default_block():
    """One plane of about 1.1 MiB at the production 1 MiB block: one block
    searched on the device, a tail the host matcher compresses."""
    require_native()
    plane = _plane("index", (1 << 20) + (1 << 17), seed=1)
    with recording(lz4_torch, "find_matches") as calls:
        got = tc.encode_lz4_chunked(plane, device="cpu")
    assert [tuple(c[0].shape) for c in calls] == [(1, 1 << 20)]
    assert got == jc.encode_lz4_chunked(plane, use_tpu=True)
    np.testing.assert_array_equal(jc.decode_lz4_chunked(got), plane)


@pytest.mark.parametrize("n", [0, 100, 4095])
def test_short_planes_take_the_host_codec(n):
    """A plane shorter than one block is the host codec's, in both packages:
    no device search."""
    plane = _plane("text", n)
    with recording(lz4_torch, "find_matches") as calls:
        got = tc.encode_lz4_chunked(plane, 4096, device="cpu")
    assert calls == []
    assert got == jc.encode_lz4_chunked(plane, 4096, use_tpu=True)
    np.testing.assert_array_equal(jc.decode_lz4_chunked(got), plane)


def test_lz4_container_without_native_library(monkeypatch):
    """Without the host library both packages compress every block with
    lz4_ref on the host."""
    plane = _plane("alphabet", 2 * 4096 + 5)
    no_native(monkeypatch)
    with recording(lz4_torch, "find_matches") as calls:
        got = tc.encode_lz4_chunked(plane, 4096, device="cpu")
    assert calls == []
    assert got == jc.encode_lz4_chunked(plane, 4096, use_tpu=True)
    np.testing.assert_array_equal(jc.decode_lz4_chunked(got), plane)


@pytest.mark.parametrize("case", list(_int_cases()))
def test_encode_int_best_matches_jax(case):
    arr = _int_cases()[case]
    got = tc.encode_int_best(arr, 4096, device="cpu")
    assert got == jc.encode_int_best(arr, 4096, use_tpu=True)
    assert len(got) == arr.dtype.itemsize


def test_encode_int_best_picks_both_ways():
    cases = _int_cases()
    bp = tc.encode_int_best(cases["u32_near"], 4096, device="cpu")
    assert jc.parse_container_header(bp[0]).kind == "bp"
    lz = tc.encode_int_best(cases["u32_colors"], 4096, device="cpu")
    assert [jc.parse_container_header(s).kind for s in lz] == \
        ["lz4", "lz4", "lz4", "fill"]


def test_compress_plane_needs_a_full_block():
    require_native()
    plane = _plane("text", 5000)
    out = lz4_torch.compress_plane(plane, 4096, device="cpu")
    assert len(out) == 2
    assert lz4_torch.compress_plane(plane[:0], 4096, device="cpu") == []
    with pytest.raises(ValueError):
        lz4_torch.find_matches(torch.zeros((2, 8), dtype=torch.int32))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.encode_lz4_chunked(np.zeros(8192, np.uint8), 4096, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.encode_int_best(np.zeros(8192, np.uint32), device="cuda")
