"""trico_tpu_torch.codec.fp_torch (the f32 v2 codec) held against
trico_tpu.codec.fp_jax on JAX's CPU backend. Tolerance: every byte of the
(C, B) payload matrix, every size and every decoded word equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trico_tpu.codec import fp_jax, fp_pallas, fp_ref, pack_funnel
from trico_tpu_torch import _u32
from trico_tpu_torch.codec import fp_cuda, fp_torch

from torch_cases import no_native, recording, words

EXPS = [(4, 6), (4, 10), (0, 6), (0, 0)]


def _t(a):
    return _u32.from_numpy(a)


@pytest.mark.parametrize("L", [1024, 4096])
@pytest.mark.parametrize("e1,e2", EXPS)
def test_encode_v2_matches_jax(L, e1, e2):
    x = words(5, L, seed=L + e2)
    got, sizes = fp_torch.encode_f32_chunks_v2(_t(x), e1, e2)
    want, want_sizes = fp_jax.encode_f32_chunks_v2(jnp.asarray(x), e1, e2)
    assert got.shape == (5, fp_jax.f32_max_chunk_bytes(L))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))


@pytest.mark.parametrize("L", [1024, 4096])
@pytest.mark.parametrize("e1,e2", EXPS)
def test_decode_v2_of_jax_payloads(L, e1, e2):
    x = words(5, L, seed=7 * L + e1)
    payloads, _ = fp_jax.encode_f32_chunks_v2(jnp.asarray(x), e1, e2)
    got = fp_torch.decode_f32_chunks_v2(torch.from_numpy(np.array(payloads)),
                                        L, e1, e2)
    np.testing.assert_array_equal(_u32.to_numpy(got), x)


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 0)])
def test_jax_decodes_port_payloads(e1, e2):
    x = words(5, 1024, seed=11)
    payloads, _ = fp_torch.encode_f32_chunks_v2(_t(x), e1, e2)
    back = fp_jax.decode_f32_chunks_v2(jnp.asarray(payloads.numpy()), 1024, e1, e2)
    np.testing.assert_array_equal(np.asarray(back), x)


@pytest.mark.parametrize("e1,e2", EXPS)
def test_predict_matches_jax(e1, e2):
    x = words(5, 512, seed=e1 + e2)
    bc, res = fp_torch.predict_f32_chunks(_t(x), e1, e2)
    wbc, wres = fp_jax.predict_f32_chunks(jnp.asarray(x), e1, e2)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u32.to_numpy(res), np.asarray(wres))


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 6)])
def test_replay_matches_jax(e1, e2):
    x = words(5, 512, seed=5)
    bc, res = fp_jax.predict_f32_chunks(jnp.asarray(x), e1, e2)
    got = fp_torch.replay_f32_chunks(torch.from_numpy(np.array(bc)),
                                     _t(np.asarray(res)), e1, e2)
    want = fp_jax.replay_f32_chunks(bc, res, e1, e2)
    np.testing.assert_array_equal(_u32.to_numpy(got), np.asarray(want))


def _random_payloads(seed, L, C=4):
    r = np.random.default_rng(seed)
    p = r.integers(0, 256, (C, fp_torch.f32_max_chunk_bytes(L)), dtype=np.uint8)
    p[0, 5:] = 0xFF  # every tag 7: all DFCM, 3 bytes each
    p[1, 5:] = 0  # every tag 0: no residual bytes
    return p


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("L", [256, 1024])
def test_parse_fuzz_matches_jax(seed, L):
    """Random payload bytes, valid or not, parse to the same (bcodes,
    xors) in both packages."""
    p = _random_payloads(seed, L)
    bc, xors = fp_torch.parse_f32_chunks_v2(torch.from_numpy(p), L)
    wbc, wxors = fp_jax.parse_f32_chunks_v2(jnp.asarray(p), L)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u32.to_numpy(xors), np.asarray(wxors))


@pytest.mark.parametrize("seed", range(3))
def test_parse_movements_are_monotone_for_any_bytes(seed):
    """The layout comes from the tags alone, so whatever the payload bytes,
    both logshift passes move live words to strictly increasing
    destinations that stay in the row — the precondition of the direct
    scatter that replaces the log-shift network."""
    L = 256
    p = torch.from_numpy(_random_payloads(seed, L))
    with recording(fp_cuda, "logshift") as calls:
        fp_torch.parse_f32_chunks_v2(p, L)
    assert [c[2] for c in calls] == ["left", "right"]
    for word, pb, direction in calls:
        w = _u32.to_numpy(word).astype(np.int64)
        S = w.shape[1]
        shift = w >> pb
        lanes = np.arange(S)
        dest = lanes - shift if direction == "left" else lanes + shift
        for c in range(w.shape[0]):
            live = w[c] != 0
            d = dest[c][live]
            assert np.all(np.diff(d) > 0)
            assert d.size == 0 or (d.min() >= 0 and d.max() < S)
            if direction == "left":
                assert np.all(np.diff(shift[c][live]) >= 0)


def test_bcode_res_from_xors_matches_jax():
    r = np.random.default_rng(0)
    edges = np.array([0, 1, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFF, 0x1000000,
                      0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    x1 = np.concatenate([np.repeat(edges, len(edges)),
                         r.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)])
    x2 = np.concatenate([np.tile(edges, len(edges)),
                         r.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)])
    bc, res = fp_torch._bcode_res_from_xors(_t(x1[None]), _t(x2[None]))
    wbc, wres = fp_jax._bcode_res_from_xors(jnp.asarray(x1[None]), jnp.asarray(x2[None]))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u32.to_numpy(res), np.asarray(wres))


def test_glen32_and_sizes_match_jax():
    bc = np.arange(8, dtype=np.uint8)[None].repeat(3, 0)
    np.testing.assert_array_equal(fp_torch._glen32(torch.from_numpy(bc)).numpy(),
                                  np.asarray(fp_jax._glen32(jnp.asarray(bc))))
    for L in (8, 1024, 4096):
        assert fp_torch.f32_max_chunk_bytes(L) == fp_jax.f32_max_chunk_bytes(L)
    with pytest.raises(ValueError):
        fp_torch.f32_max_chunk_bytes(12)


@pytest.mark.parametrize("L", [1024, 4096])
def test_adaptive_fast_matches_jax(L):
    x = words(5, L, seed=L)
    got, sizes = fp_torch.encode_f32_chunks_v2_adaptive(
        _t(x), fp_torch.F32_TPU_CANDIDATES_FAST)
    want, want_sizes = fp_jax.encode_f32_chunks_v2_adaptive(
        jnp.asarray(x), fp_jax.F32_TPU_CANDIDATES_FAST)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    assert set(got[:, 0].tolist()) <= {fp_torch.hash_info(0, 6),
                                       fp_torch.hash_info(4, 6)}


@pytest.mark.parametrize("L,n", [(1024, 3 * 1024 + 77), (4096, 2 * 4096 + 5)])
def test_host_entry_points_match_jax(L, n):
    """encode_f32 / decode_f32 (layout "tpu") with a ragged tail."""
    vals = words(5, n, seed=n).T.reshape(-1)[:n].copy()  # kinds interleaved
    got, sizes, tail = fp_torch.encode_f32(vals, L, 4, 6, device="cpu")
    want, want_sizes, want_tail = fp_jax.encode_f32(vals, L, 4, 6, layout="tpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    assert sizes.dtype == np.int64
    np.testing.assert_array_equal(tail, want_tail)
    back = fp_torch.decode_f32(got, L, 4, 6, device="cpu")
    np.testing.assert_array_equal(back, vals[: len(vals) - len(tail)])


def test_host_adaptive_entry_matches_jax():
    """Both defaults: the full candidate set."""
    vals = words(5, 4 * 1024 + 33, seed=2).reshape(-1)[: 4 * 1024 + 33 + 2048].copy()
    got, sizes, tail = fp_torch.encode_f32_adaptive(vals, 1024, device="cpu")
    want, want_sizes, want_tail = fp_jax.encode_f32_adaptive(vals, 1024)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    np.testing.assert_array_equal(tail, want_tail)


def test_host_entry_points_without_full_chunks():
    vals = words(1, 100)[0]
    mat, sizes, tail = fp_torch.encode_f32(vals, 1024, device="cpu")
    assert mat.shape == (0, fp_torch.f32_max_chunk_bytes(1024))
    assert len(sizes) == 0 and np.array_equal(tail, vals)
    assert len(fp_torch.decode_f32(mat, 1024, device="cpu")) == 0


@pytest.mark.parametrize("fn", ["encode_f32", "encode_f32_adaptive", "decode_f32"])
def test_ref_layout_raises(fn, monkeypatch):
    """Without the C++ host library the reference layout's pack and parse
    are the device ones: encode_f32 and decode_f32, which raised before these
    were ported, give fp_jax's bytes and values. The adaptive encode relays
    its v2 chunks out on the host and needs no library; it refuses an
    unknown layout."""
    no_native(monkeypatch)
    if fn == "encode_f32_adaptive":
        with pytest.raises(ValueError, match="unknown layout"):
            fp_torch.encode_f32_adaptive(np.zeros(16, np.uint32), 8, layout="v3",
                                         device="cpu")
        return
    vals = words(5, 16, seed=3).reshape(-1)
    want, want_sizes, want_tail = fp_jax.encode_f32(vals, 8, layout="ref")
    if fn == "encode_f32":
        got, sizes, tail = fp_torch.encode_f32(vals, 8, layout="ref", device="cpu")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(sizes, want_sizes)
        np.testing.assert_array_equal(tail, want_tail)
    else:
        back = fp_torch.decode_f32(want, 8, layout="ref", device="cpu")
        np.testing.assert_array_equal(back, vals)
        np.testing.assert_array_equal(fp_jax.decode_f32(want, 8, layout="ref"), vals)


def test_relayout_matches_jax_and_oracle():
    x = words(3, 1024, seed=4)
    payloads, sizes = fp_torch.encode_f32_chunks_v2(_t(x), 4, 6)
    for c in range(3):
        v2 = payloads[c, : int(sizes[c])].numpy()
        v1 = fp_torch.relayout_f32_v2_to_v1(v2)
        np.testing.assert_array_equal(v1, fp_jax.relayout_f32_v2_to_v1(v2))
        assert v1.tobytes() == fp_ref.compress(x[c], 4, 6)


def test_hash_info_matches_oracle_header():
    for e1 in range(0, 31, 2):
        for e2 in range(0, 31, 2):
            info = fp_ref.compress(np.zeros(8, np.uint32), e1, e2)[0]
            assert fp_torch.hash_info(e1, e2) == info
            assert fp_torch.exponents(info) == (e1, e2)


def test_jax_pallas_composite_matches_port(monkeypatch):
    """JAX's own device path (Pallas predict, pair compaction, log-shift and
    replay kernels, forced on and run in interpret mode) gives the port's
    bytes and values."""
    L = 256
    x = words(3, L, seed=21)
    monkeypatch.setattr(fp_jax, "_use_pallas", lambda: True)
    monkeypatch.setattr(fp_jax, "_predict_mode", lambda: "pallas")
    monkeypatch.setattr(pack_funnel, "_use_pallas", lambda: True)
    used = set()
    for name in ("predict_xors_pallas", "logshift_pallas",
                 "pair_compact_or_pallas", "replay_pallas"):
        real = getattr(fp_pallas, name)

        def interpreted(*a, _r=real, _n=name, **k):
            used.add(_n)
            return _r(*a[:_arity(_r)], True)

        monkeypatch.setattr(fp_pallas, name, interpreted)
    want, want_sizes = fp_jax._pack_f32_chunks_v2_impl(
        *fp_jax.predict_f32_chunks.__wrapped__(jnp.asarray(x), 4, 6), 4, 6)
    got, sizes = fp_torch.encode_f32_chunks_v2(_t(x), 4, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    bc, xors = fp_jax._parse_f32_chunks_v2_impl(jnp.asarray(got.numpy()), L, 4, 6)
    back = fp_jax._replay_impl(bc, xors, 4, 6)
    np.testing.assert_array_equal(np.asarray(back), x)
    assert len(used) == 4


def _arity(fn):
    """Positional arguments before ``interpret`` in a fp_pallas entry."""
    import inspect

    params = list(inspect.signature(fn).parameters)
    return params.index("interpret")
