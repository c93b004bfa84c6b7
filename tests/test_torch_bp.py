"""trico_tpu_torch's BP32 / BP64 codec (codec/bp_torch.py) and BP container
(chunked.encode_bp_chunked / decode_bp_chunked) held against trico_tpu's
bp_jax on JAX's CPU backend and the NumPy oracle bp_ref: the same chunk
bytes, sizes and container bytes, exact equality of every byte, and
containers that cross between the packages decode bit-exact both ways."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trico_tpu.chunked as jc
import trico_tpu_torch.chunked as tc
from trico_tpu.codec import bp_jax, bp_ref, fp_jax
from trico_tpu_torch import _u32, _u64
from trico_tpu_torch.codec import bp_torch, fp_cuda, fp_torch

from torch_cases import no_native, recording

KINDS = ["index", "constant", "random", "wrap"]


def _values(kind: str, n: int, bits: int, seed: int = 0) -> np.ndarray:
    """n words of ``bits`` bits: triangle-index-like (bench.py:231-236's
    fullmesh pattern), one constant (width-0 groups after the first),
    full-width random bits, or a running sum of deltas of magnitude
    2^(bits-2) .. 2^(bits-1) that wraps past 2^bits again and again (zigzag
    words with the top bit set)."""
    r = np.random.default_rng(seed)
    dt = np.uint32 if bits == 32 else np.uint64
    if kind == "index":
        i = np.arange(n, dtype=np.uint64)
        v = i // 3 + (i % 3) * 7 + i % 1024
    elif kind == "constant":
        v = np.full(n, 0xDEADBEEFCAFEF00D & ((1 << bits) - 1), np.uint64)
    elif kind == "random":
        return np.frombuffer(r.bytes(n * bits // 8), dt).copy()
    else:
        mag = r.integers(1 << (bits - 2), 1 << (bits - 1), n, dtype=np.uint64)
        d = np.where(r.random(n) < 0.5, np.uint64(0) - mag, mag)
        v = np.cumsum(d, dtype=np.uint64)  # wraps mod 2^64
    return v.astype(dt)


def _hi_lo(v: np.ndarray):
    return (jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("C,L", [(3, 64), (5, 256), (2, 4096), (2, 16384)])
def test_bp32_chunks_match_jax_and_oracle(C, L, kind):
    v = _values(kind, C * L, 32, seed=L).reshape(C, L)
    pay, sizes = bp_torch.encode_bp32_chunks(_u32.from_numpy(v))
    want_pay, want_sizes = bp_jax.encode_bp32_chunks(jnp.asarray(v))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(want_pay))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    for c in range(C):
        assert pay[c, : sizes[c]].numpy().tobytes() == bp_ref.encode_chunk(v[c])
    np.testing.assert_array_equal(
        _u32.to_numpy(bp_torch.decode_bp32_chunks(pay, L)), v)
    np.testing.assert_array_equal(
        np.asarray(bp_jax.decode_bp32_chunks(jnp.asarray(pay.numpy()), L)), v)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("C,L", [(3, 64), (5, 256), (2, 4096), (2, 8192)])
def test_bp64_chunks_match_jax_and_oracle(C, L, kind):
    v = _values(kind, C * L, 64, seed=L).reshape(C, L)
    pay, sizes = bp_torch.encode_bp64_chunks(_u64.from_numpy(v))
    want_pay, want_sizes = bp_jax.encode_bp64_chunks(*_hi_lo(v))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(want_pay))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    for c in range(C):
        assert pay[c, : sizes[c]].numpy().tobytes() == bp_ref.encode_chunk(v[c])
    np.testing.assert_array_equal(
        _u64.to_numpy(bp_torch.decode_bp64_chunks(pay, L)), v)
    vh, vl = bp_jax.decode_bp64_chunks(jnp.asarray(pay.numpy()), L)
    np.testing.assert_array_equal(
        (np.asarray(vh).astype(np.uint64) << np.uint64(32))
        | np.asarray(vl).astype(np.uint64), v)


@pytest.mark.parametrize("bits", [32, 64])
def test_widths_are_unsigned_bit_lengths(bits):
    """A group's width is the bit length of its largest zigzag word read as
    unsigned: one delta of each magnitude 2^k gives width k + 2, up to the
    full word, and the top bit counts."""
    L = 32 * (bits + 1)
    d = np.zeros(L, np.uint64)
    for k in range(bits - 1):  # group k + 1 holds one delta of 2^k
        d[32 * (k + 1) + 5] = np.uint64(1) << np.uint64(k)
    d[32 * bits + 7] = (1 << 64) - (1 << (bits - 2))  # a delta of -2^(bits-2)
    v = np.cumsum(d, dtype=np.uint64)
    if bits == 32:
        v = v.astype(np.uint32)
        pay, _ = bp_torch.encode_bp32_chunks(_u32.from_numpy(v[None]))
    else:
        pay, _ = bp_torch.encode_bp64_chunks(_u64.from_numpy(v[None]))
    widths = pay[0, : L // 32].numpy()
    want = [0] + [min(k + 2, bits) for k in range(bits - 1)] + [bits - 1]
    assert widths.tolist() == want
    assert pay[0].numpy().tobytes()[: bp_ref.chunk_payload_size(v)] == \
        bp_ref.encode_chunk(v)


@pytest.mark.parametrize("n", [0, 31, 32, 2 * 16384 + 5])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_bp_container_matches_jax(n, dtype):
    """u64 chunks are capped at 8192; n = 31 and 0 have no full chunk and
    take the host codec in both packages."""
    v = _values("index", n, 8 * np.dtype(dtype).itemsize, seed=n)
    v[n // 2 :] += dtype(12345)  # one jump in the middle
    got = tc.encode_bp_chunked(v, device="cpu")
    assert got == jc.encode_bp_chunked(v, use_tpu=True)
    for back in (tc.decode_bp_chunked(got, device="cpu"),
                 jc.decode_bp_chunked(got, use_tpu=True),
                 jc.decode_bp_chunked(got, use_tpu=False)):
        assert back.dtype == dtype
        np.testing.assert_array_equal(back, v)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_port_decodes_jax_bp_containers(dtype):
    """Containers of trico_tpu's host encoder, at chunk lengths the device
    takes (1024) and does not (16384 for u64 is capped; 1000 is off the
    32-value grid)."""
    v = _values("wrap", 5 * 1024 + 77, 8 * np.dtype(dtype).itemsize, seed=3)
    for L in (1024, 16384, 1000):
        blob = jc.encode_bp_chunked(v, L, use_tpu=False)
        np.testing.assert_array_equal(tc.decode_bp_chunked(blob, device="cpu"), v)


def test_bp_container_without_native_library(monkeypatch):
    """Without the C++ host library the tail chunk takes bp_ref and the
    bytes do not change; decode of the tail takes bp_ref too."""
    v = _values("index", 2 * 1024 + 40, 32, seed=5)
    with_native = tc.encode_bp_chunked(v, 1024, device="cpu")
    no_native(monkeypatch)
    assert tc.encode_bp_chunked(v, 1024, device="cpu") == with_native
    np.testing.assert_array_equal(tc.decode_bp_chunked(with_native, device="cpu"), v)


@pytest.mark.parametrize("corrupt", ["width", "size"])
def test_corrupt_bp_header_raises_before_any_launch(corrupt):
    v = _values("index", 4 * 1024, 32, seed=1)
    blob = bytearray(tc.encode_bp_chunked(v, 1024, device="cpu"))
    payload0 = 14 + 4 * 4  # prefix + size table of 4 chunks
    if corrupt == "width":
        blob[payload0 + 3] = 33  # group 3 of chunk 0 claims 33 planes
    else:
        w = blob[payload0 + 3]
        blob[payload0 + 3] = w - 1 if w else w + 1  # sizes no longer match
    with recording(bp_torch, "decode_bp32_chunks") as calls:
        with pytest.raises(ValueError, match="corrupt BP32 chunk"):
            tc.decode_bp_chunked(bytes(blob), device="cpu")
    assert calls == []


def test_not_a_bp_container_raises():
    blob = tc.encode_lz4_chunked(np.zeros(64, np.uint8), device="cpu")
    with pytest.raises(ValueError, match="not a BP32 container"):
        tc.decode_bp_chunked(blob, device="cpu")
    with pytest.raises(TypeError):
        tc.encode_bp_chunked(np.zeros(64, np.uint16), device="cpu")


@pytest.mark.parametrize("direction", ["left", "right"])
def test_logshift_at_65536_slots_with_16_payload_bits(direction):
    """The BP decode's slot-id move at its largest shape: S = 65536 slots,
    16 payload bits, so shift << 16 | payload fills all 32 bits of the word.
    The port's move equals fp_jax's on random monotone moves."""
    r = np.random.default_rng(7)
    C, S = 2, 1 << 16
    live = r.random((C, S)) < 0.6
    payload = r.integers(0, 1 << 16, (C, S), dtype=np.int64).astype(np.int32)
    # live element k moves to rank k (left) or from rank k to its slot (right)
    rank = np.cumsum(live, axis=1) - 1
    lanes = np.arange(S)[None, :]
    if direction == "left":
        shift = np.where(live, lanes - rank, 0)
        valid = live
    else:  # expand ranks 0..n-1 to the live slots
        slot_of_rank = np.zeros((C, S), np.int64)
        for c in range(C):
            slot_of_rank[c, : live[c].sum()] = np.nonzero(live[c])[0]
        valid = lanes < live.sum(axis=1, keepdims=True)
        shift = np.where(valid, slot_of_rank - lanes, 0)
    shift = shift.astype(np.int32)
    move = fp_torch._compact_monotone if direction == "left" else fp_torch._expand_monotone
    jmove = fp_jax._compact_monotone if direction == "left" else fp_jax._expand_monotone
    got = move(torch.from_numpy(payload), torch.from_numpy(shift),
               torch.from_numpy(valid), 16)
    want = jmove(jnp.asarray(payload.view(np.uint32)), jnp.asarray(shift),
                 jnp.asarray(valid), 16)
    np.testing.assert_array_equal(_u32.to_numpy(got), np.asarray(want))
    assert int(np.asarray(want).max()) >= 1 << 15  # payloads use all 16 bits


def test_logshift_word_limit_raises():
    """pb + ceil(log2 S) must fit the 32-bit word: 16 + 16 does, 17 + 16
    and 16 + 17 do not."""
    ok = torch.zeros((1, 1 << 16), dtype=torch.int32)
    fp_cuda.logshift(ok, 16, "left")
    with pytest.raises(ValueError):
        fp_cuda.logshift(ok, 17, "left")
    with pytest.raises(ValueError):
        fp_cuda.logshift(torch.zeros((1, (1 << 16) + 1), dtype=torch.int32),
                         16, "right")
    with pytest.raises(ValueError, match="overflow"):
        fp_torch._compact_monotone(ok, ok, ok != 0, 17)


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        bp_torch.encode_bp32_chunks(torch.zeros((2, 48), dtype=torch.int32))
    with pytest.raises(ValueError):
        bp_torch.encode_bp64_chunks(torch.zeros((2, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        bp_torch.decode_bp32_chunks(torch.zeros((2, 10), dtype=torch.uint8), 64)
    with pytest.raises(ValueError):
        bp_torch.bp64_max_chunk_bytes(40)
    assert bp_torch.bp32_max_chunk_bytes(64) == bp_jax.bp32_max_chunk_bytes(64)
    assert bp_torch.bp64_max_chunk_bytes(64) == bp_jax.bp64_max_chunk_bytes(64)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.encode_bp_chunked(np.zeros(64, np.uint32), device="cuda")
    blob = struct.pack("<BBIII", 1, 8, 32, 0, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.decode_bp_chunked(blob, device="cuda")
