"""trico_tpu_torch.codec.fp_cuda: each kernel's plain PyTorch version held
against the Pallas kernel it replaces, run in interpret mode on the CPU, and
the NumPy oracle. Tolerance: every word equal.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds each
against these plain versions there.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trico_tpu.codec import fp_pallas, fp_ref
from trico_tpu_torch import _u32, _u64
from trico_tpu_torch.codec import fp64_torch, fp_cuda, fp_torch

from torch_cases import recording, words, words64

EXPS = [(4, 6), (4, 10), (0, 6), (0, 0), (6, 0), (10, 10), (5, 7)]


def _np(t):
    return _u32.to_numpy(t)


@pytest.mark.parametrize("e1,e2", EXPS)
def test_predict_xors_matches_pallas(e1, e2):
    """L=256 runs _predict_window_kernel (K=4) when both exponents are
    nonzero and _predict_kernel otherwise."""
    x = words(5, 256, seed=e1 * 31 + e2)
    got = fp_cuda.predict_xors(_u32.from_numpy(x), e1, e2)
    want = fp_pallas.predict_xors_pallas(jnp.asarray(x), e1, e2, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("e1,e2", [(4, 6), (4, 10)])
def test_predict_xors_matches_pallas_one_step_kernel(e1, e2):
    """L=252 is no multiple of the window K=4: _predict_kernel runs."""
    x = words(5, 252, seed=9)
    got = fp_cuda.predict_xors(_u32.from_numpy(x), e1, e2)
    want = fp_pallas.predict_xors_pallas(jnp.asarray(x), e1, e2, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("e1,e2", [(4, 6), (0, 0), (10, 10)])
def test_predict_xors_matches_oracle(e1, e2):
    x = words(5, 1024, seed=3)
    xor1, xor2 = fp_cuda.predict_xors(_u32.from_numpy(x), e1, e2)
    for c in range(len(x)):
        p1, p2 = fp_ref.predictions(x[c], *fp_cuda._norm_exponents(e1, e2))
        np.testing.assert_array_equal(_np(xor1)[c], x[c] ^ p1)
        np.testing.assert_array_equal(_np(xor2)[c], x[c] ^ p2)


def test_prev_occurrence_matches_oracle():
    r = np.random.default_rng(0)
    keys = r.integers(0, 7, (3, 500))
    vals = r.integers(0, 1 << 32, (3, 500), dtype=np.uint64).astype(np.int64)
    got = fp_cuda._prev_occurrence(torch.from_numpy(keys), torch.from_numpy(vals))
    for c in range(3):
        want = fp_ref.prev_occurrence(keys[c].astype(np.uint32),
                                      vals[c].astype(np.uint32))
        np.testing.assert_array_equal(got[c].numpy().astype(np.uint32), want)


@pytest.mark.parametrize("e1,e2", EXPS)
def test_replay_matches_pallas(e1, e2):
    x = words(5, 256, seed=e2)
    bc, res = fp_torch.predict_f32_chunks(_u32.from_numpy(x), e1, e2)
    got = fp_cuda.replay(bc, res, e1, e2)
    want = fp_pallas.replay_pallas(jnp.asarray(bc.numpy()),
                                   jnp.asarray(_np(res)), e1, e2, True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), x)


def _parse_calls(seed, L):
    """The logshift calls of one parse of random payload bytes."""
    r = np.random.default_rng(seed)
    B = fp_torch.f32_max_chunk_bytes(L)
    p = torch.from_numpy(r.integers(0, 256, (4, B), dtype=np.uint8))
    with recording(fp_cuda, "logshift") as calls:
        fp_torch.parse_f32_chunks_v2(p, L)
    return calls


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", [0, 1], ids=["left_slot_ids", "right_bytes"])
def test_logshift_matches_pallas_on_parse_words(seed, which):
    word, pb, direction = _parse_calls(seed, 256)[which]
    assert direction == ("left" if which == 0 else "right")
    got = fp_cuda.logshift(word, pb, direction)
    want = fp_pallas.logshift_pallas(jnp.asarray(_np(word)), pb, direction, True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _monotone_words(seed, C=4, S=1024, pb=8):
    """Random monotone movements: live lanes to strictly increasing
    destinations with nondecreasing shifts (left), and their inverses
    (right)."""
    r = np.random.default_rng(seed)
    live = r.random((C, S)) < 0.6
    rank = np.cumsum(live, axis=1) - live
    dead = np.arange(S)[None, :] - rank
    dest = rank + np.floor(r.random((C, 1)) * dead).astype(np.int64)
    payload = r.integers(1, 1 << pb, (C, S))
    left = np.where(live, ((np.arange(S) - dest) << pb) | payload, 0)
    right = np.zeros((C, S), np.int64)
    rows, cols = np.nonzero(live)
    src = dest[rows, cols]
    right[rows, src] = ((cols - src) << pb) | payload[rows, cols]
    return left.astype(np.uint32), right.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_logshift_matches_pallas_on_random_monotone_words(seed, direction):
    left, right = _monotone_words(seed)
    w = left if direction == "left" else right
    got = fp_cuda.logshift(_u32.from_numpy(w), 8, direction)
    want = fp_pallas.logshift_pallas(jnp.asarray(w), 8, direction, True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _pack_calls(seed, L):
    """The pair_compact_or calls of one pack of random (bcode, res)."""
    r = np.random.default_rng(seed)
    bc = torch.from_numpy(r.integers(0, 8, (4, L), dtype=np.uint8))
    bc[1] = 0
    bc[2] = 4
    res = _u32.from_numpy(r.integers(0, 1 << 32, (4, L), dtype=np.uint64)
                          .astype(np.uint32))
    with recording(fp_cuda, "pair_compact_or") as calls:
        fp_torch.pack_f32_chunks_v2(bc, res)
    return calls


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", [0, 1], ids=["c0", "c1"])
def test_pair_compact_or_matches_pallas(seed, which):
    carrier, payload, nbits = _pack_calls(seed, 256)[which]
    got = fp_cuda.pair_compact_or(carrier, payload, nbits)
    want = fp_pallas.pair_compact_or_pallas(
        jnp.asarray(_np(carrier)), jnp.asarray(_np(payload)), nbits, True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _merging_compaction(C, S, seed):
    """(carrier, payload, nbits) of a merging monotone left compaction on
    which the network of _pair_compact_kernel and a direct scatter agree.
    Row 0 is all dead (payload garbage only). In the others, live slots come
    in runs of 1-5 that share a destination, with dead slots (payload
    garbage) between; each run's destination is one past the last one's, so
    displacements never fall either; a tenth of the payloads are 0. Besides,
    where no moving carrier passes: carriers past slot 0 in the slots before
    the first destination, with a power of two above the slot as their
    displacement (one pass takes them out of the row), and carriers out of
    reach in the last three slots, after every live one, with displacements
    of 1-3 x 2^nbits (no pass moves them). Anywhere else such carriers can
    meet moving ones in the network, which then ORs their payloads in where
    the direct scatter drops them."""
    r = np.random.default_rng(seed)
    nbits = max(S - 1, 1).bit_length()
    carrier = np.zeros((C, S), np.uint64)
    payload = r.integers(0, 1 << 32, (C, S), dtype=np.uint64)
    for c in range(1, C):
        first = int(r.integers(2, 9))  # the row's first destination
        live = np.nonzero(r.random(S) < 0.55)[0]
        dest, left = first - 1, 0
        for s in live[(live >= first) & (live < S - 3)]:
            if left == 0:  # a new run
                dest, left = dest + 1, int(r.integers(1, 6))
            left -= 1
            carrier[c, s] = ((s - dest) << 1) | 1
            if r.random() < 0.1:
                payload[c, s] = 0
        for s in range(first):
            if r.random() < 0.5:
                carrier[c, s] = ((1 << s.bit_length()) << 1) | 1
        for s in range(S - 3, S):
            if r.random() < 0.5:
                carrier[c, s] = ((int(r.integers(1, 4)) << nbits) << 1) | 1
    return carrier.astype(np.uint32), payload.astype(np.uint32), nbits


def _kept_destinations(carrier, nbits):
    """Per slot the destination of a carrier the direct scatter keeps, -1
    for every other slot."""
    c = carrier.astype(np.int64)
    disp = c >> 1
    lanes = np.arange(c.shape[1])[None, :]
    ok = ((c & 1) == 1) & ((disp >> nbits) == 0) & (disp <= lanes)
    return np.where(ok, lanes - disp, -1)


@pytest.mark.parametrize("S", [24, 37, 64, 129, 257])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_compact_or_merging_runs_match_pallas(S, seed):
    """The plain version against the network on merging compactions with an
    all-dead row, dropped carriers and zero payloads."""
    carrier, payload, nbits = _merging_compaction(4, S, seed)
    dest = _kept_destinations(carrier, nbits)
    live = carrier & 1 == 1
    assert not live[0].any() and (live & (dest < 0)).any()
    kept = dest[dest >= 0]
    assert len(np.unique(kept)) < len(kept)  # some payloads merge
    got = fp_cuda.pair_compact_or(_u32.from_numpy(carrier),
                                  _u32.from_numpy(payload), nbits)
    want = fp_pallas.pair_compact_or_pallas(
        jnp.asarray(carrier), jnp.asarray(payload), nbits, True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("C,S", [(5, 37), (1, 4096), (3, 2 * 2048 + 9)])
def test_chip_smoke_merging_compactions(C, S):
    """The merging compactions on which chip_smoke.py holds the
    pair_compact_or kernels: destinations never fall over kept carriers, a
    merge run crosses every tile edge at each of the four offsets a row can
    have from the 16-byte grid, and the plain version equals a direct
    scatter with OR."""
    cs = _chip_smoke()
    carrier, payload, nbits = cs.merging_compaction(C, S, seed=C + S)
    dest = _kept_destinations(carrier, nbits)
    want = np.zeros((C, S), np.uint32)
    rows, cols = np.nonzero(dest >= 0)
    np.bitwise_or.at(want, (rows, dest[rows, cols]), payload[rows, cols])
    got = fp_cuda.pair_compact_or(_u32.from_numpy(carrier),
                                  _u32.from_numpy(payload), nbits)
    np.testing.assert_array_equal(_np(got), want)
    for r in range(C):
        d = dest[r][dest[r] >= 0]
        assert np.all(np.diff(d) >= 0)
        if C > 2 and r == C // 2:
            assert not carrier[r].any()
            continue
        for edge in range(cs.TILE_SLOTS, S - 4, cs.TILE_SLOTS):
            for o in range(4):
                a, b = dest[r, : edge - o], dest[r, edge - o :]
                assert a[a >= 0][-1] == b[b >= 0][0]


@pytest.mark.parametrize("L", [1, 8, 33, 40])
@pytest.mark.parametrize("e1s", [(8,), (2, 6, 8), (2, 3, 4, 5, 6, 8, 10, 12)],
                         ids=["K1", "K3", "K8"])
def test_fcm_multi_plain_matches_pallas_at_short_chunks(L, e1s):
    """fcm_multi_xors (its plain version on the CPU) against
    _fcm_multi_kernel in interpret mode at chunk lengths off the CUDA
    kernel's 32-value windows (one value, one past a window), up to the 8
    exponents one launch takes."""
    x = words(6, L, seed=L + len(e1s))
    got = fp_cuda.fcm_multi_xors(_u32.from_numpy(x), e1s)
    want = fp_pallas.predict_fcm_xors_pallas(jnp.asarray(x), e1s, True)
    assert len(got) == len(want) == len(e1s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    fp_cuda.reset_launches()
    x = _u32.from_numpy(words(3, 64))
    xor1, xor2 = fp_cuda.predict_xors(x, 4, 6)
    ref1, ref2 = fp_cuda.predict_xors_plain(x, 4, 6)
    assert torch.equal(xor1, ref1) and torch.equal(xor2, ref2)
    x64 = _u64.from_numpy(words64(3, 64))
    assert torch.equal(fp_cuda.predict64_xors(x64, 4, 6)[0],
                       fp_cuda.predict64_xors_plain(x64, 4, 6)[0])
    bc, res = fp_torch._bcode_res_from_xors(xor1, xor2)
    assert torch.equal(fp_cuda.replay(bc, res, 4, 6), x)
    assert fp_cuda.launches == dict.fromkeys(fp_cuda.KERNELS, 0)


@pytest.mark.parametrize("name", fp_cuda.KERNELS)
def test_wrappers_reject_devices_other_than_cpu_and_cuda(name):
    m = torch.empty((2, 64), dtype=torch.int32, device="meta")
    m64 = torch.empty((2, 64), dtype=torch.int64, device="meta")
    bc = torch.empty((2, 64), dtype=torch.uint8, device="meta")
    args = {"predict_xors": (m, 4, 6),
            "fcm_multi_xors": (m, (2, 6)),
            "replay": (bc, m, 4, 6),
            "logshift": (m, 8, "left"),
            "pair_compact_or": (m, m, 6),
            "predict64_xors": (m64, 4, 6),
            "replay64": (bc, m64, 4, 6),
            "predict_sort_xors": (m, 14, 18),
            "predict64_sort_xors": (m64, 20, 20)}[name]
    with pytest.raises(ValueError):
        getattr(fp_cuda, name)(*args)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((2, 64), dtype=torch.int64)
    with pytest.raises(ValueError):
        fp_cuda.predict_xors(x, 4, 6)
    with pytest.raises(ValueError):
        fp_cuda.logshift(torch.zeros((2, 64), dtype=torch.int32), 8, "up")
    with pytest.raises(ValueError):
        fp_cuda.logshift(torch.zeros((2, 1 << 12), dtype=torch.int32), 21, "left")
    with pytest.raises(ValueError):
        fp_cuda.replay(torch.zeros((2, 8), dtype=torch.uint8),
                       torch.zeros((2, 16), dtype=torch.int32), 4, 6)
    with pytest.raises(ValueError):
        fp_cuda.predict64_xors(torch.zeros((2, 64), dtype=torch.int32), 4, 6)
    with pytest.raises(ValueError):
        fp_cuda.replay64(torch.zeros((2, 16), dtype=torch.uint8),
                         torch.zeros((2, 16), dtype=torch.int32), 4, 6)
    with pytest.raises(ValueError):
        fp_cuda.fcm_multi_xors(torch.zeros((2, 64), dtype=torch.int64), (4,))


def test_norm_exponents_match_reference():
    for e1 in range(0, 34):
        for e2 in (0, 1, 6, 7, 29, 30, 31, 33):
            assert fp_cuda._norm_exponents(e1, e2) == fp_pallas._norm_exponents(e1, e2)


# The shapes chip_smoke.py gives the redesigned replay kernels on the card,
# at a size the Pallas interpreter takes: L below, at and past a tile and off
# the 4-value vector and 32-lane grids, one chunk and a chunk count that fills
# no block, zero exponents, tables of 2048 words, and inputs that are views
# at an odd word offset of a larger tensor (rows not 16-byte aligned).
REPLAY_SHAPES = [(1, 8), (3, 40), (5, 264), (1, 1), (7, 13)]
REPLAY_EXPS = [(4, 6), (0, 0), (0, 6), (4, 10), (10, 10)]


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """The same values as a contiguous view one element into a larger
    tensor."""
    big = torch.zeros(t.numel() + 3, dtype=t.dtype)
    big[1 : 1 + t.numel()] = t.reshape(-1)
    return big[1 : 1 + t.numel()].view(t.shape)


@pytest.mark.parametrize("C,L", REPLAY_SHAPES)
@pytest.mark.parametrize("e1,e2", REPLAY_EXPS)
def test_replay_wrapper_shapes_match_pallas(C, L, e1, e2):
    x = words(C, L, seed=C * 100 + L + e2)
    bc, res = fp_torch.predict_f32_chunks(_u32.from_numpy(x), e1, e2)
    want = fp_pallas.replay_pallas(jnp.asarray(bc.numpy()),
                                   jnp.asarray(_np(res)), e1, e2, True)
    np.testing.assert_array_equal(np.asarray(want), x)
    for b, r in ((bc, res), (_offset_view(bc), _offset_view(res))):
        assert b.is_contiguous() and r.is_contiguous()
        np.testing.assert_array_equal(_np(fp_cuda.replay(b, r, e1, e2)), x)
    # G and T only steer the kernel: a CPU tensor takes the plain version
    np.testing.assert_array_equal(_np(fp_cuda.replay(bc, res, e1, e2, 2, 64)), x)


@pytest.mark.parametrize("C,L", [(1, 2), (3, 6), (5, 38), (2, 258), (4, 1)])
@pytest.mark.parametrize("e1,e2", REPLAY_EXPS)
def test_replay64_wrapper_shapes_match_pallas(C, L, e1, e2):
    x = words64(C, L, seed=C * 100 + L + e1)
    bc, res = fp64_torch.predict_f64_chunks(_u64.from_numpy(x), e1, e2)
    r64 = _u64.to_numpy(res)
    vh, vl = fp_pallas.replay64_pallas(
        jnp.asarray(bc.numpy()), jnp.asarray((r64 >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(r64.astype(np.uint32)), e1, e2, True)
    want = (np.asarray(vh).astype(np.uint64) << np.uint64(32)) | np.asarray(vl)
    np.testing.assert_array_equal(want, x)
    for b, r in ((bc, res), (_offset_view(bc), _offset_view(res))):
        np.testing.assert_array_equal(_u64.to_numpy(fp_cuda.replay64(b, r, e1, e2)), x)


def test_replay_needs_room_for_its_stages():
    """A replay block holds its tiles beside its tables: tables that fill a
    block's shared memory to the last word are refused before any launch."""
    fp_cuda._need_fit("replay", (14, 14), 4, fp_cuda.REPLAY_STAGE_BYTES)
    with pytest.raises(ValueError, match="shared memory"):
        fp_cuda._need_fit("replay64", (14, 12), 8, 128 * 1024)
    assert fp_cuda.tables_fit((14, 14)) and not fp_cuda.tables_fit((16, 16))
