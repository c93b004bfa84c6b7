"""trico_tpu_torch.codec.fp64_torch (the f64 v2 codec) and its two kernels'
plain versions, held against trico_tpu.codec.fp64_jax on JAX's CPU backend
and fp_pallas in interpret mode. The port carries a u64 word as int64 bits,
the JAX package as (hi, lo) u32 pairs; they are compared as uint64.
Tolerance: every byte of the (C, B) payload matrix, every size and every
word equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trico_tpu.codec import fp64_jax, fp_pallas, fp_ref
from trico_tpu_torch import _u64
from trico_tpu_torch.codec import fp64_torch, fp_cuda

from torch_cases import no_native, recording, words64

EXPS = [(4, 6), (4, 10), (0, 6), (0, 0), (10, 12), (20, 20)]
LS = [1024, 2048]


def _t(a):
    return _u64.from_numpy(a)


def _hl(x):
    """uint64 (C, L) → JAX (hi, lo) u32 words."""
    return (jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def _join(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo).astype(np.uint64)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("e1,e2", EXPS)
def test_predict_matches_jax(L, e1, e2):
    x = words64(6, L, seed=L + e1 + e2)
    bc, res = fp64_torch.predict_f64_chunks(_t(x), e1, e2)
    wbc, wrh, wrl = fp64_jax.predict_f64_chunks(*_hl(x), e1, e2)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u64.to_numpy(res), _join(wrh, wrl))


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("e1,e2", EXPS)
def test_encode_v2_matches_jax(L, e1, e2):
    """Predict and pack: the payload matrix and sizes."""
    x = words64(6, L, seed=3 * L + e2)
    got, sizes = fp64_torch.encode_f64_chunks_v2(_t(x), e1, e2)
    want, want_sizes = fp64_jax.encode_f64_chunks_v2(*_hl(x), e1, e2)
    assert got.shape == (6, fp64_jax.f64_max_chunk_bytes(L))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("e1,e2", EXPS)
def test_decode_v2_of_jax_payloads(L, e1, e2):
    """Parse and replay of JAX's payloads restore the words."""
    x = words64(6, L, seed=7 * L + e1)
    payloads, _ = fp64_jax.encode_f64_chunks_v2(*_hl(x), e1, e2)
    got = fp64_torch.decode_f64_chunks_v2(torch.from_numpy(np.array(payloads)),
                                          L, e1, e2)
    np.testing.assert_array_equal(_u64.to_numpy(got), x)


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 0), (10, 12)])
def test_jax_decodes_port_payloads(e1, e2):
    x = words64(6, 1024, seed=11)
    payloads, _ = fp64_torch.encode_f64_chunks_v2(_t(x), e1, e2)
    vh, vl = fp64_jax.decode_f64_chunks_v2(jnp.asarray(payloads.numpy()),
                                           1024, e1, e2)
    np.testing.assert_array_equal(_join(vh, vl), x)


def _random_bcode_res(seed, L, C=4):
    r = np.random.default_rng(seed)
    bc = r.integers(0, 16, (C, L), dtype=np.uint8)
    bc[1] = 0  # no residual bytes
    bc[2] = 8  # 8 FCM bytes each: the full slot row
    res = np.frombuffer(r.bytes(8 * C * L), np.uint64).reshape(C, L).copy()
    return bc, res


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("L", LS)
def test_pack_matches_jax(seed, L):
    """Any bcodes and residual words (bytes past a value's length are
    ignored) pack to the same payloads."""
    bc, res = _random_bcode_res(seed, L)
    got, sizes = fp64_torch.pack_f64_chunks_v2(torch.from_numpy(bc), _t(res), 4, 6)
    want, want_sizes = fp64_jax.pack_f64_chunks_v2(jnp.asarray(bc), *_hl(res), 4, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("L", LS)
def test_parse_fuzz_matches_jax(seed, L):
    """Random payload bytes, valid or not, parse to the same (bcodes,
    xors) in both packages."""
    r = np.random.default_rng(100 + seed)
    p = r.integers(0, 256, (4, fp64_torch.f64_max_chunk_bytes(L)), dtype=np.uint8)
    p[0, 5:] = 0x88  # every bcode 8: every slot live
    p[1, 5:] = 0
    bc, xors = fp64_torch.parse_f64_chunks_v2(torch.from_numpy(p), L)
    wbc, wxh, wxl = fp64_jax.parse_f64_chunks_v2(jnp.asarray(p), L)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u64.to_numpy(xors), _join(wxh, wxl))


def test_parse_movements_are_monotone():
    """Both logshift passes of the f64 parse move live words to strictly
    increasing destinations inside the row, for any payload bytes."""
    L = 256
    p = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (4, fp64_torch.f64_max_chunk_bytes(L)), dtype=np.uint8))
    with recording(fp_cuda, "logshift") as calls:
        fp64_torch.parse_f64_chunks_v2(p, L)
    assert [c[2] for c in calls] == ["left", "right"]
    for word, pb, direction in calls:
        w = word.numpy().astype(np.int64) & 0xFFFFFFFF
        S = w.shape[1]
        assert S == 8 * L
        lanes = np.arange(S)
        dest = lanes - (w >> pb) if direction == "left" else lanes + (w >> pb)
        for c in range(w.shape[0]):
            d = dest[c][w[c] != 0]
            assert np.all(np.diff(d) > 0)
            assert d.size == 0 or (d.min() >= 0 and d.max() < S)


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 6), (4, 10), (0, 0), (10, 12)])
def test_replay_matches_jax(e1, e2):
    x = words64(6, 512, seed=5)
    bc, rh, rl = fp64_jax.predict_f64_chunks(*_hl(x), e1, e2)
    got = fp64_torch.replay_f64_chunks(torch.from_numpy(np.array(bc)),
                                       _t(_join(rh, rl)), e1, e2)
    vh, vl = fp64_jax.replay_f64_chunks(bc, rh, rl, e1, e2)
    np.testing.assert_array_equal(_u64.to_numpy(got), _join(vh, vl))
    np.testing.assert_array_equal(_u64.to_numpy(got), x)


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 6), (4, 10)])
def test_predict64_plain_matches_pallas(e1, e2):
    """L = 2048 crosses the 1024-value slab of the Pallas kernels; (4,6)
    and (4,10) run _predict64_window_kernel, (0,6) _predict64_kernel."""
    x = words64(3, 2048, seed=13 + e2)
    got = fp_cuda.predict64_xors(_t(x), e1, e2)
    x1h, x1l, x2h, x2l = fp_pallas.predict64_xors_pallas(*_hl(x), e1, e2, True)
    np.testing.assert_array_equal(_u64.to_numpy(got[0]), _join(x1h, x1l))
    np.testing.assert_array_equal(_u64.to_numpy(got[1]), _join(x2h, x2l))


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 6)])
def test_replay64_plain_matches_pallas(e1, e2):
    x = words64(3, 2048, seed=17 + e2)
    bc, res = fp64_torch.predict_f64_chunks(_t(x), e1, e2)
    got = fp_cuda.replay64(bc, res, e1, e2)
    vh, vl = fp_pallas.replay64_pallas(jnp.asarray(bc.numpy()),
                                       *_hl(_u64.to_numpy(res)), e1, e2, True)
    np.testing.assert_array_equal(_u64.to_numpy(got), _join(vh, vl))
    np.testing.assert_array_equal(_u64.to_numpy(got), x)


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 0), (10, 12)])
def test_predict64_plain_matches_oracle(e1, e2):
    x = words64(6, 1024, seed=3)
    xor1, xor2 = fp_cuda.predict64_xors(_t(x), e1, e2)
    for c in range(len(x)):
        p1, p2 = fp_ref.predictions(x[c], *fp_cuda._norm_exponents(e1, e2))
        np.testing.assert_array_equal(_u64.to_numpy(xor1)[c], x[c] ^ p1)
        np.testing.assert_array_equal(_u64.to_numpy(xor2)[c], x[c] ^ p2)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("cands", ["full", "fast"])
def test_adaptive_matches_jax(L, cands):
    c = {"full": fp64_torch.F64_TPU_CANDIDATES,
         "fast": fp64_torch.F64_TPU_CANDIDATES_FAST}[cands]
    x = words64(6, L, seed=L + len(c))
    got, sizes = fp64_torch.encode_f64_chunks_v2_adaptive(_t(x), c)
    want, want_sizes = fp64_jax.encode_f64_chunks_v2_adaptive(*_hl(x), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))


def test_adaptive_candidate_sets_match_jax():
    assert fp64_torch.F64_TPU_CANDIDATES == fp64_jax.F64_TPU_CANDIDATES
    assert fp64_torch.F64_TPU_CANDIDATES_FAST == fp64_jax.F64_TPU_CANDIDATES_FAST


def test_adaptive_routes_each_candidate():
    """One predictor per candidate: the kernel where the u64 tables fit
    ((4,6), (10,12)), the sort for (10,16) and (20,20)."""
    x = _t(words64(2, 256))
    with recording(fp_cuda, "predict64_xors") as kern, \
            recording(fp64_torch, "_predict_sort64") as sort:
        fp64_torch.encode_f64_chunks_v2_adaptive(x)
    assert [c[1:] for c in kern] == [(4, 6), (10, 12)]
    assert [c[1:] for c in sort] == [(10, 16), (20, 20)]


@pytest.mark.parametrize("L,n", [(1024, 3 * 1024 + 77), (2048, 2 * 2048 + 5)])
def test_host_entry_points_match_jax(L, n):
    """encode_f64 / decode_f64 (layout "tpu") with a ragged tail."""
    vals = words64(6, n, seed=n).T.reshape(-1)[:n].copy()  # kinds interleaved
    got, sizes, tail = fp64_torch.encode_f64(vals, L, 4, 6, device="cpu")
    want, want_sizes, want_tail = fp64_jax.encode_f64(vals, L, 4, 6, layout="tpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    assert sizes.dtype == np.int64
    np.testing.assert_array_equal(tail, want_tail)
    back = fp64_torch.decode_f64(got, L, 4, 6, device="cpu")
    np.testing.assert_array_equal(back, vals[: len(vals) - len(tail)])


def test_host_adaptive_entry_matches_jax():
    """Odd chunk_len rounds down to even, as in fp64_jax."""
    n = 3 * 1024 + 33
    vals = words64(6, n, seed=2).T.reshape(-1)[:n].copy()
    got, sizes, tail = fp64_torch.encode_f64_adaptive(vals, 1025, device="cpu")
    want, want_sizes, want_tail = fp64_jax.encode_f64_adaptive(vals, 1025)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    np.testing.assert_array_equal(tail, want_tail)


def test_host_entry_points_without_full_chunks():
    vals = words64(1, 100)[0]
    mat, sizes, tail = fp64_torch.encode_f64(vals, 1024, device="cpu")
    assert mat.shape == (0, fp64_torch.f64_max_chunk_bytes(1024))
    assert len(sizes) == 0 and np.array_equal(tail, vals)
    assert len(fp64_torch.decode_f64(mat, 1024, device="cpu")) == 0


@pytest.mark.parametrize("fn", ["encode_f64", "encode_f64_adaptive", "decode_f64"])
def test_ref_layout_raises(fn, monkeypatch):
    """Without the C++ host library, which packs and parses the reference
    layout, encode_f64 / decode_f64 say that it is missing (chunked
    host-codes such chunks and never calls them then); the adaptive encode
    has no reference layout in fp64_jax either."""
    no_native(monkeypatch)
    arg = np.zeros((1, fp64_torch.f64_max_chunk_bytes(8)), np.uint8) \
        if fn == "decode_f64" else np.zeros(16, np.uint64)
    err = ValueError if fn == "encode_f64_adaptive" else NotImplementedError
    with pytest.raises(err):
        getattr(fp64_torch, fn)(arg, 8, layout="ref", device="cpu")
    if err is NotImplementedError:
        with pytest.raises(err, match="host library, which is not built"):
            getattr(fp64_torch, fn)(arg, 8, layout="ref", device="cpu")


@pytest.mark.parametrize("e1,e2", [(4, 6), (20, 20)])
def test_relayout_matches_jax_and_oracle(e1, e2):
    x = words64(6, 1024, seed=4)
    payloads, sizes = fp64_torch.encode_f64_chunks_v2(_t(x), e1, e2)
    for c in range(len(x)):
        v2 = payloads[c, : int(sizes[c])].numpy()
        v1 = fp64_torch.relayout_f64_v2_to_v1(v2)
        np.testing.assert_array_equal(v1, fp64_jax.relayout_f64_v2_to_v1(v2))
        assert v1.tobytes() == fp_ref.compress(x[c], e1, e2)


def test_bcode_res_from_xors64_matches_jax():
    r = np.random.default_rng(0)
    edges = np.array([0, 1, 0xFF, 0x100, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF,
                      0x100000000, 0xFFFFFFFFFF, 0xFFFFFFFFFFFF,
                      0xFFFFFFFFFFFFFF, 0x100000000000000, 0x7FFFFFFFFFFFFFFF,
                      0x8000000000000000, 0xFFFFFFFFFFFFFFFF], np.uint64)
    rand = np.frombuffer(r.bytes(8 * 1000), np.uint64)
    x1 = np.concatenate([np.repeat(edges, len(edges)), rand])[None]
    x2 = np.concatenate([np.tile(edges, len(edges)), rand[::-1]])[None]
    bc, res = fp64_torch._bcode_res_from_xors64(_t(x1), _t(x2))
    wbc, wrh, wrl = fp64_jax._bcode_res_from_xors64(*_hl(x1), *_hl(x2))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u64.to_numpy(res), _join(wrh, wrl))
    np.testing.assert_array_equal(bc.numpy()[0], fp_ref._bcodes_f64(x1[0], x2[0]))


def test_glen64_and_sizes_match_jax():
    bc = np.arange(16, dtype=np.uint8)[None].repeat(3, 0)
    np.testing.assert_array_equal(fp64_torch._glen64(torch.from_numpy(bc)).numpy(),
                                  np.asarray(fp64_jax._glen64(jnp.asarray(bc))))
    for L in (2, 1024, 4096):
        assert fp64_torch.f64_max_chunk_bytes(L) == fp64_jax.f64_max_chunk_bytes(L)
    with pytest.raises(ValueError):
        fp64_torch.f64_max_chunk_bytes(1023)
