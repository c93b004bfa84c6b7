"""The full f32 adaptive search of trico_tpu_torch.codec.fp_torch (any
candidate set, the (e2-grouped) candidate xors, the fcm_multi_xors plain
version) and the route of big tables to the sort predictor, held against
trico_tpu.codec.fp_jax on JAX's CPU backend and fp_pallas in interpret mode.
Tolerance: every byte, size and word equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trico_tpu.codec import fp_jax, fp_pallas, fp_ref
from trico_tpu_torch import _u32
from trico_tpu_torch.codec import fp_cuda, fp_torch

from torch_cases import recording, words

# the four sets of tests/test_fp_pallas.py:262-267; the first is production
CANDIDATE_SETS = {
    "production": ((0, 6), (4, 6), (4, 10), (14, 18)),
    "fused3": ((0, 6), (4, 6), (8, 6), (4, 10)),
    "two_e1_zero": ((0, 8), (0, 6), (4, 6)),
    "singletons": ((4, 10), (14, 18)),
}


def _t(a):
    return _u32.from_numpy(a)


def test_production_set_matches_jax():
    assert fp_torch.F32_TPU_CANDIDATES == fp_jax.F32_TPU_CANDIDATES
    assert fp_torch.F32_TPU_CANDIDATES == CANDIDATE_SETS["production"]
    assert fp_torch.F32_TPU_CANDIDATES_FAST == fp_jax.F32_TPU_CANDIDATES_FAST


@pytest.mark.parametrize("L", [1024, 2048])
@pytest.mark.parametrize("name", list(CANDIDATE_SETS))
def test_adaptive_matches_jax(L, name):
    cands = CANDIDATE_SETS[name]
    x = words(5, L, seed=L + len(name))
    got, sizes = fp_torch.encode_f32_chunks_v2_adaptive(_t(x), cands)
    want, want_sizes = fp_jax.encode_f32_chunks_v2_adaptive(jnp.asarray(x), cands)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    infos = {fp_torch.hash_info(*fp_cuda._norm_exponents(*e)) for e in cands}
    assert set(got[:, 0].tolist()) <= infos


@pytest.mark.parametrize("name", list(CANDIDATE_SETS))
def test_candidate_xors_match_sort(name):
    """The grouped candidate xors equal one sort predictor per candidate."""
    x = words(5, 256, seed=77)
    norm = [fp_cuda._norm_exponents(*e) for e in CANDIDATE_SETS[name]]
    got = fp_torch._candidate_xors(_t(x), norm)
    for (g1, g2), (e1, e2) in zip(got, norm):
        w1, w2 = fp_jax._predict_sort(jnp.asarray(x), e1, e2)
        np.testing.assert_array_equal(_u32.to_numpy(g1), np.asarray(w1))
        np.testing.assert_array_equal(_u32.to_numpy(g2), np.asarray(w2))


@pytest.mark.parametrize("name,predict,fcm,sort", [
    # (4,6) gives the e2=6 group's DFCM xor and e1=4; e1=0 is v ^ vprev
    ("production", [(4, 6), (4, 10)], [], [(14, 18)]),
    ("fused3", [(4, 6), (4, 10)], [(8,)], []),
    ("two_e1_zero", [(0, 8), (4, 6)], [], []),
    ("singletons", [(4, 10)], [], [(14, 18)]),
])
def test_candidate_groups_decide_the_kernels(name, predict, fcm, sort):
    """Which kernel wrappers the adaptive encode calls, and with what: the
    production set never reaches fcm_multi_xors; a set whose e2 group holds
    two nonzero e1s does; (14,18) takes the sort predictor."""
    x = _t(words(2, 256))
    with recording(fp_cuda, "predict_xors") as p, \
            recording(fp_cuda, "fcm_multi_xors") as f, \
            recording(fp_torch, "_predict_sort") as s:
        fp_torch.encode_f32_chunks_v2_adaptive(x, CANDIDATE_SETS[name])
    assert [c[1:] for c in p] == predict
    assert [c[1] for c in f] == fcm
    assert [c[1:] for c in s] == sort


@pytest.mark.parametrize("e1s", [(2, 6, 8), (8,), (4, 10)])
def test_fcm_multi_plain_matches_pallas(e1s):
    """fcm_multi_xors (its plain version on the CPU) against
    _fcm_multi_kernel in interpret mode and the NumPy oracle."""
    x = words(5, 256, seed=sum(e1s))
    got = fp_cuda.fcm_multi_xors(_t(x), e1s)
    want = fp_pallas.predict_fcm_xors_pallas(jnp.asarray(x), e1s, True)
    assert len(got) == len(want) == len(e1s)
    for g, w, e in zip(got, want, e1s):
        np.testing.assert_array_equal(_u32.to_numpy(g), np.asarray(w))
        for c in range(len(x)):
            p1, _ = fp_ref.predictions(x[c], e, 0)
            np.testing.assert_array_equal(_u32.to_numpy(g)[c], x[c] ^ p1)


@pytest.mark.parametrize("e1s", [(), (0,), (1,), (4, 31), tuple(range(2, 20, 2))])
def test_fcm_multi_rejects_bad_exponents(e1s):
    with pytest.raises(ValueError):
        fp_cuda.fcm_multi_xors(_t(words(1, 64)), e1s)


@pytest.mark.parametrize("e1,e2,kernel", [
    (4, 6, True), (14, 14, True), (16, 16, False), (14, 18, False), (20, 20, False)])
def test_big_tables_route_to_the_sort(e1, e2, kernel):
    """The named rule decides, before any launch, between the predict_xors
    kernel and the sort predictor: (14,14) holds 128 KB of tables, (16,16)
    512 KB, more than one block's 227 KB of shared memory. Both give
    fp_jax's words at L = 4096."""
    assert fp_cuda.tables_fit((e1, e2)) is kernel
    x = _t(words(2, 4096, seed=e2))
    with recording(fp_cuda, "predict_xors") as p, \
            recording(fp_torch, "_predict_sort") as s:
        bc, res = fp_torch.predict_f32_chunks(x, e1, e2)
    assert (len(p), len(s)) == ((1, 0) if kernel else (0, 1))
    wbc, wres = fp_jax.predict_f32_chunks(jnp.asarray(x.numpy().view(np.uint32)), e1, e2)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(wbc))
    np.testing.assert_array_equal(_u32.to_numpy(res), np.asarray(wres))


@pytest.mark.parametrize("e1,e2", [(16, 16), (14, 18)])
def test_encode_big_tables_matches_jax(e1, e2):
    """The repaired route end to end: the encode at exponents whose tables
    no kernel holds gives fp_jax's bytes."""
    x = words(5, 1024, seed=e1)
    got, sizes = fp_torch.encode_f32_chunks_v2(_t(x), e1, e2)
    want, want_sizes = fp_jax.encode_f32_chunks_v2(jnp.asarray(x), e1, e2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))


def test_f64_routing_rule():
    """u64 tables take twice the bytes: (10,12) fits, (10,16) does not."""
    for exps, fits in (((4, 6), True), ((10, 12), True), ((12, 14), True),
                       ((10, 16), False), ((20, 20), False)):
        assert fp_cuda.tables_fit(exps, 8) is fits


def test_new_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    fp_cuda.reset_launches()
    x = _t(words(3, 64))
    got = fp_cuda.fcm_multi_xors(x, (2, 6))
    want = fp_cuda.fcm_multi_xors_plain(x, (2, 6))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x64 = torch.from_numpy(words(3, 64).astype(np.int64) * -977)
    got = fp_cuda.predict64_xors(x64, 4, 6)
    want = fp_cuda.predict64_xors_plain(x64, 4, 6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    from trico_tpu_torch.codec import fp64_torch

    bc, res = fp64_torch._bcode_res_from_xors64(*got)
    assert torch.equal(fp_cuda.replay64(bc, res, 4, 6), x64)
    assert fp_cuda.launches == dict.fromkeys(fp_cuda.KERNELS, 0)


@pytest.mark.parametrize("n,L", [(4 * 1024 + 33, 1024), (2 * 4096 + 9, 4096)])
def test_host_adaptive_entry_full_set_matches_jax(n, L):
    vals = words(5, n, seed=n).T.reshape(-1)[:n].copy()
    got, sizes, tail = fp_torch.encode_f32_adaptive(vals, L, device="cpu")
    want, want_sizes, want_tail = fp_jax.encode_f32_adaptive(vals, L)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    np.testing.assert_array_equal(tail, want_tail)
