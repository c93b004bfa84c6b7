"""The reference chunk layout packed and parsed on the device
(trico_tpu_torch.codec.fp_torch.pack_f32_chunks / parse_f32_chunks and the
entry points above them) held against trico_tpu.codec.fp_jax's device pack
and parse on JAX's CPU backend, and against the C++ host library's.
Tolerance: exact (every byte, size and word equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trico_tpu.chunked as jc
from trico_tpu.codec import fp_jax, fp_ref
import trico_tpu_torch.chunked as tc
from trico_tpu_torch import _u32
from trico_tpu_torch.codec import fp_cuda, fp_torch

from torch_cases import (align_native, no_native, recording,  # noqa: F401
                         require_native, words)

LENGTHS = [8, 1024, 4096]
EXPS = [(4, 6), (0, 0), (10, 12)]


def _t(a):
    return _u32.from_numpy(a)


def _rows(L, seed):
    """The five kinds of torch_cases.words (an all-zero row among them) and
    a row of random bits."""
    x = words(6, L, seed=seed)
    x[5] = np.random.default_rng(seed).integers(
        0, 1 << 32, L, dtype=np.uint64).astype(np.uint32)
    return x


def _stream(n, seed=0):
    return words(5, max(n, 1), seed=seed).T.reshape(-1)[:n].copy()


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("e1,e2", EXPS)
def test_pack_matches_jax(L, e1, e2):
    x = _rows(L, seed=L + e2)
    bc, res = fp_jax.predict_f32_chunks(jnp.asarray(x), e1, e2)
    want, want_sizes = fp_jax.pack_f32_chunks(bc, res, e1, e2)
    got, sizes = fp_torch.pack_f32_chunks(torch.from_numpy(np.array(bc)),
                                          _t(np.asarray(res)), e1, e2)
    assert got.shape == (6, fp_torch.f32_max_chunk_bytes(L))
    assert got.dtype == torch.uint8 and sizes.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("e1,e2", EXPS)
def test_encode_matches_jax_and_oracle(L, e1, e2):
    """Each row is a whole reference FP substream of its chunk."""
    x = _rows(L, seed=3 * L + e1)
    got, sizes = fp_torch.encode_f32_chunks(_t(x), e1, e2)
    want, want_sizes = fp_jax.encode_f32_chunks(jnp.asarray(x), e1, e2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    for c in range(len(x)):
        n = int(sizes[c])
        assert got[c, :n].numpy().tobytes() == fp_ref.compress(x[c], e1, e2)
        assert not got[c, n:].any()


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("e1,e2", EXPS)
def test_parse_matches_jax(L, e1, e2):
    x = _rows(L, seed=5 * L + e2)
    payloads, _ = fp_jax.encode_f32_chunks(jnp.asarray(x), e1, e2)
    bc, xors = fp_torch.parse_f32_chunks(torch.from_numpy(np.array(payloads)),
                                         L, e1, e2)
    wbc, wxors = fp_jax.parse_f32_chunks(payloads, L, e1, e2)
    assert bc.dtype == torch.uint8 and xors.dtype == torch.int32
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u32.to_numpy(xors), np.asarray(wxors))
    pbc, pres = fp_jax.predict_f32_chunks(jnp.asarray(x), e1, e2)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(pbc))
    np.testing.assert_array_equal(_u32.to_numpy(xors), np.asarray(pres))


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("e1,e2", EXPS)
def test_decode_crosses_both_ways(L, e1, e2):
    x = _rows(L, seed=7 * L + e1)
    theirs, _ = fp_jax.encode_f32_chunks(jnp.asarray(x), e1, e2)
    ours, _ = fp_torch.encode_f32_chunks(_t(x), e1, e2)
    got = fp_torch.decode_f32_chunks(torch.from_numpy(np.array(theirs)), L, e1, e2)
    np.testing.assert_array_equal(_u32.to_numpy(got), x)
    back = fp_jax.decode_f32_chunks(jnp.asarray(ours.numpy()), L, e1, e2)
    np.testing.assert_array_equal(np.asarray(back), x)


def test_parse_takes_other_lengths_and_refuses_short_rows():
    """L = 40 has five groups: no power of two for the pointer doubling."""
    x = _rows(40, seed=1)
    payloads, _ = fp_torch.encode_f32_chunks(_t(x), 4, 6)
    wbc, wxors = fp_jax.parse_f32_chunks(jnp.asarray(payloads.numpy()), 40, 4, 6)
    bc, xors = fp_torch.parse_f32_chunks(payloads, 40, 4, 6)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u32.to_numpy(xors), np.asarray(wxors))
    with pytest.raises(ValueError, match="multiple of 8"):
        fp_torch.parse_f32_chunks(payloads, 12)
    with pytest.raises(ValueError, match="too short"):
        fp_torch.parse_f32_chunks(payloads[:, :100], 40)


@pytest.mark.parametrize("L", [1024, 4096])
def test_pack_is_one_left_compaction(L):
    """One logshift call over S = 5 + 35 L / 8 slots with 8 payload bits,
    monotone as the kernel needs it: shifts never fall along the live slots
    of a row and destinations rise."""
    x = _rows(L, seed=L)
    with recording(fp_cuda, "logshift") as calls:
        fp_torch.encode_f32_chunks(_t(x), 4, 6)
    assert len(calls) == 1
    word, pb, direction = calls[0]
    S = 5 + 35 * L // 8
    assert word.shape == (6, S) and (pb, direction) == (8, "left")
    w = _u32.to_numpy(word).astype(np.int64)
    shift = w >> pb
    for c in range(len(w)):
        live = w[c] != 0
        assert np.all(np.diff(shift[c][live]) >= 0)
        dest = np.arange(S)[live] - shift[c][live]
        assert np.all(np.diff(dest) > 0) and dest.min() >= 0


@pytest.mark.parametrize("direction", ["left", "right"])
def test_logshift_plain_at_the_pack_width(direction):
    """S = 17925, the slots of a chunk of 4096: rows that lie 4 bytes off any
    16-byte grid. The plain version against the log-shift network itself."""
    S = 5 + 35 * 4096 // 8
    r = np.random.default_rng(3)
    live = r.random((3, S)) < 0.55
    live[1] = False  # an all-dead row
    rank = np.cumsum(live, axis=1) - live
    payload = r.integers(1, 256, (3, S))
    if direction == "left":
        w = np.where(live, ((np.arange(S) - rank) << 8) | payload, 0)
    else:
        w = np.zeros((3, S), np.int64)
        rows, cols = np.nonzero(live)
        src = rank[rows, cols]
        w[rows, src] = ((cols - src) << 8) | payload[rows, cols]
    w = w.astype(np.uint32)
    got = fp_cuda.logshift(_t(w), 8, direction)
    want = fp_jax._logshift_passes(jnp.asarray(w), 8, S, direction) & 0xFF
    np.testing.assert_array_equal(_u32.to_numpy(got), np.asarray(want))
    # a CPU tensor takes the plain version
    assert torch.equal(fp_cuda.logshift_plain(_t(w), 8, direction), got)


@pytest.mark.parametrize("L,n", [(1024, 3 * 1024 + 77), (4096, 2 * 4096 + 5)])
@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 0)])
def test_host_entry_points_take_the_device_pack_and_parse(L, n, e1, e2):
    """device_pack / device_parse give the bytes and values of fp_jax's, and
    of the C++ host library's pack and parse where that is built."""
    vals = _stream(n, seed=n)
    got, sizes, tail = fp_torch.encode_f32(vals, L, e1, e2, layout="ref",
                                           device_pack=True, device="cpu")
    want, want_sizes, want_tail = fp_jax.encode_f32(vals, L, e1, e2,
                                                    device_pack=True, layout="ref")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    assert sizes.dtype == np.int64
    np.testing.assert_array_equal(tail, want_tail)
    for kw in ({"device_parse": True}, {}):
        back = fp_torch.decode_f32(got, L, e1, e2, layout="ref", device="cpu", **kw)
        np.testing.assert_array_equal(back, vals[: len(vals) - len(tail)])
    np.testing.assert_array_equal(
        fp_jax.decode_f32(got, L, e1, e2, device_parse=True, layout="ref"),
        vals[: len(vals) - len(tail)])
    host, host_sizes, _ = fp_torch.encode_f32(vals, L, e1, e2, layout="ref",
                                              device="cpu")
    np.testing.assert_array_equal(host, got)
    np.testing.assert_array_equal(host_sizes, sizes)


def test_host_library_is_taken_unless_asked_otherwise(monkeypatch):
    """With the library built and the flags unset the pack and parse are the
    host library's, as in trico_tpu; without it, or with the flags, the
    device's."""
    require_native()
    vals = _stream(2 * 1024, seed=5)
    with recording(fp_cuda, "logshift") as calls:
        mat, _, _ = fp_torch.encode_f32(vals, 1024, layout="ref", device="cpu")
        fp_torch.decode_f32(mat, 1024, layout="ref", device="cpu")
        assert calls == []
        fp_torch.encode_f32(vals, 1024, layout="ref", device_pack=True, device="cpu")
        assert len(calls) == 1
        fp_torch.decode_f32(mat, 1024, layout="ref", device_parse=True, device="cpu")
        assert len(calls) == 1  # the parse gathers; it moves nothing
        no_native(monkeypatch)
        fp_torch.encode_f32(vals, 1024, layout="ref", device="cpu")
        assert len(calls) == 2


@pytest.mark.parametrize("n,L", [(3 * 1024 + 77, 1024), (2 * 4096, 4096),
                                 (4096 + 5, 4096)])
@pytest.mark.parametrize("e", [None, (0, 0), (4, 10)])
def test_containers_without_the_host_library_match_jax(monkeypatch, n, L, e):
    """No C++ host library in either package: encode_chunked(layout="ref")
    packs on the device, as trico_tpu does, and gives its bytes; both
    packages read both containers back."""
    vals = _stream(n, seed=n)
    exps = e or ()
    no_native(monkeypatch)
    got = tc.encode_chunked(vals, L, *exps, layout="ref", device="cpu")
    want = jc.encode_chunked(vals, L, *exps, use_tpu=True, layout="ref")
    assert got == want
    assert tc.parse_container_header(got).layout == "ref"
    for blob in (got, want):
        np.testing.assert_array_equal(tc.decode_chunked(blob, device="cpu")[0], vals)
        np.testing.assert_array_equal(jc.decode_chunked(blob, use_tpu=True)[0], vals)


@pytest.mark.parametrize("opt", ["fast", True])
def test_adaptive_containers_without_the_host_library(monkeypatch, opt):
    """The adaptive search relays v2 chunks out on the host; its container
    is then parsed on the device, one hash_info group at a time."""
    vals = np.concatenate([_stream(3 * 1024, seed=3),
                           np.arange(1024 + 9, dtype=np.uint32) * 977])
    no_native(monkeypatch)
    got = tc.encode_chunked(vals, 1024, layout="ref", optimize=opt, device="cpu")
    assert got == jc.encode_chunked(vals, 1024, use_tpu=True, layout="ref",
                                    optimize=opt)
    np.testing.assert_array_equal(tc.decode_chunked(got, device="cpu")[0], vals)
    np.testing.assert_array_equal(jc.decode_chunked(got, use_tpu=True)[0], vals)


def test_container_bytes_do_not_depend_on_the_host_library(monkeypatch):
    require_native()
    vals = _stream(3 * 1024 + 5, seed=9)
    with_native = tc.encode_chunked(vals, 1024, layout="ref", device="cpu")
    no_native(monkeypatch)
    assert tc.encode_chunked(vals, 1024, layout="ref", device="cpu") == with_native
    np.testing.assert_array_equal(tc.decode_chunked(with_native, device="cpu")[0],
                                  vals)
