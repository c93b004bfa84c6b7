"""trico_tpu_torch.codec.fp_cuda.predict_sort_xors and predict64_sort_xors:
the predictor for tables that the window kernels cannot hold. On CPU tensors
the wrappers run their plain version, held here against the JAX package's
sort predictor (fp_jax._predict_sort, fp64_jax._predict_sort64) on JAX's CPU
backend where its keys fit 32 bits, and against a sequential table walk
(the recurrence of tests/seq_oracle.py) past them; the routing of the f32 and
f64 encoders to the new wrappers (the encodes ``tools/sort_compare.py``
times among them), and that no codec module names a plain version.
Tolerance: every word equal. The CUDA kernels run only on a card:
``chip_smoke.py`` holds them against the same plain versions there.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trico_tpu.codec import fp64_jax, fp_jax
from trico_tpu_torch import _u32, _u64
from trico_tpu_torch.codec import fp64_torch, fp_cuda, fp_torch
from trico_tpu_torch.tools import sort_compare

from torch_cases import recording, words, words64

PKG = Path(__file__).resolve().parents[1] / "trico_tpu_torch"
SHAPES = [(1, 8), (3, 40), (2, 1000), (2, 4096)]
EXPS32 = [(14, 18), (16, 16), (12, 18), (16, 20)]
EXPS64 = [(10, 16), (20, 20), (16, 20)]
# keys past 32 bits: JAX's sort would overflow, its scan would need 2^30-row
# (2^22-row) one-hot tables
WIDE32 = [(0, 30), (30, 30)]
WIDE64 = [(20, 22)]
WIDE_SHAPES = [(2, 40), (1, 4104)]


def _lbits(L: int) -> int:
    return max(L - 1, 1).bit_length()


def _hl(x):
    return (jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def _join(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo)


def walk_xors(row: np.ndarray, e1: int, e2: int, bits: int):
    """The FCM and DFCM xors of one chunk by the reference's sequential
    table walk (fps.c's hash recurrences, as tests/seq_oracle.py writes
    them), with Python ints and dict tables."""
    mask = (1 << bits) - 1
    m1, m2 = (1 << e1) - 1, (1 << e2) - 1
    t1, t2 = {}, {}
    h1 = h2 = pred1 = pred2 = last = 0
    x1, x2 = [], []
    for v in map(int, row):
        x1.append(v ^ pred1)
        x2.append(v ^ ((last + pred2) & mask))
        t1[h1] = v
        h1 = ((h1 << e1) ^ (v >> (bits - e1))) & m1 if e1 else 0
        pred1 = t1.get(h1, 0)
        stride = (v - last) & mask
        last = v
        t2[h2] = stride
        h2 = ((h2 << (e2 // 2)) ^ (stride >> (bits - e2))) & m2 if e2 else 0
        pred2 = t2.get(h2, 0)
    return x1, x2


@pytest.mark.parametrize("e1,e2", EXPS32)
@pytest.mark.parametrize("C,L", SHAPES)
def test_f32_matches_jax_sort(C, L, e1, e2):
    assert max(e1, e2) + _lbits(L) <= 32  # fp_jax._prev_occurrence_multi's rule
    x = words(C, L, seed=L + e1 + e2)
    got = fp_cuda.predict_sort_xors(_u32.from_numpy(x), e1, e2)
    want = fp_jax._predict_sort(jnp.asarray(x), e1, e2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u32.to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("e1,e2", EXPS64)
@pytest.mark.parametrize("C,L", SHAPES)
def test_f64_matches_jax_sort(C, L, e1, e2):
    assert max(e1, e2) + _lbits(L) <= 32
    x = words64(C, L, seed=L + e1 + e2)
    got = fp_cuda.predict64_sort_xors(_u64.from_numpy(x), e1, e2)
    x1h, x1l, x2h, x2l = fp64_jax._predict_sort64(*_hl(x), e1, e2)
    np.testing.assert_array_equal(_u64.to_numpy(got[0]), _join(x1h, x1l))
    np.testing.assert_array_equal(_u64.to_numpy(got[1]), _join(x2h, x2l))


@pytest.mark.parametrize("width,e1,e2", [(32, *e) for e in WIDE32]
                         + [(64, *e) for e in WIDE64])
@pytest.mark.parametrize("C,L", WIDE_SHAPES)
def test_keys_past_32_bits_match_the_table_walk(C, L, width, e1, e2):
    """Exponents whose composite keys need more than 32 bits at some of
    these lengths (u64 composites in the kernel; f64 (20,22) at 4104)
    against the sequential walk."""
    if width == 32:
        x = words(C, L, seed=e2 + L)
        got = fp_cuda.predict_sort_xors(_u32.from_numpy(x), e1, e2)
        got = [_u32.to_numpy(g) for g in got]
    else:
        x = words64(C, L, seed=e2 + L)
        got = fp_cuda.predict64_sort_xors(_u64.from_numpy(x), e1, e2)
        got = [_u64.to_numpy(g) for g in got]
    for c in range(C):
        w1, w2 = walk_xors(x[c], e1, e2, width)
        assert [int(v) for v in got[0][c]] == w1
        assert [int(v) for v in got[1][c]] == w2


@pytest.mark.parametrize("e1,e2", [(14, 18), (4, 6), (0, 0), (7, 31)])
def test_f32_matches_the_table_walk(e1, e2):
    """The walk also holds at small and odd exponents (31 normalises to
    30), so the two oracles agree with each other."""
    x = words(5, 300, seed=e1)
    got = fp_cuda.predict_sort_xors(_u32.from_numpy(x), e1, e2)
    n1, n2 = fp_cuda._norm_exponents(e1, e2)
    for c in range(len(x)):
        w1, w2 = walk_xors(x[c], n1, n2, 32)
        assert [int(v) for v in _u32.to_numpy(got[0])[c]] == w1
        assert [int(v) for v in _u32.to_numpy(got[1])[c]] == w2


@pytest.mark.parametrize("name", ["predict_sort_xors", "predict64_sort_xors"])
def test_wrappers_reject_bad_inputs(name):
    fn = getattr(fp_cuda, name)
    dt = torch.int32 if name == "predict_sort_xors" else torch.int64
    other = torch.int64 if dt == torch.int32 else torch.int32
    good = torch.zeros((2, 64), dtype=dt)
    for bad in (good.to(other), good.reshape(-1), good.reshape(2, 8, 8),
                good.t(), good[:, ::2]):
        with pytest.raises(ValueError):
            fn(bad, 14, 18)
    with pytest.raises(ValueError):
        fn(torch.zeros((2, 64), dtype=dt, device="meta"), 14, 18)


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    fp_cuda.reset_launches()
    x = _u32.from_numpy(words(3, 64))
    got = fp_cuda.predict_sort_xors(x, 16, 16)
    want = fp_cuda.predict_xors_plain(x, 16, 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x64 = _u64.from_numpy(words64(3, 64))
    got = fp_cuda.predict64_sort_xors(x64, 20, 20)
    want = fp_cuda.predict64_xors_plain(x64, 20, 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fp_cuda.launches == dict.fromkeys(fp_cuda.KERNELS, 0)
    assert fp_cuda.plain_on_card == 0  # CPU tensors


def test_nine_kernels_each_with_a_plain_version():
    assert len(fp_cuda.KERNELS) == len(set(fp_cuda.KERNELS)) == 9
    assert fp_cuda.KERNELS[-2:] == ("predict_sort_xors", "predict64_sort_xors")
    assert fp_torch._predict_sort is fp_cuda.predict_sort_xors
    assert fp64_torch._predict_sort64 is fp_cuda.predict64_sort_xors


def test_f32_adaptive_set_sorts_only_14_18():
    """F32_TPU_CANDIDATES: one call of the sort predictor, at (14,18), whose
    1 MiB of tables no block holds."""
    x = _u32.from_numpy(words(2, 256))
    norm = [fp_cuda._norm_exponents(*e) for e in fp_torch.F32_TPU_CANDIDATES]
    with recording(fp_torch, "_predict_sort") as s, \
            recording(fp_cuda, "predict_xors") as p:
        fp_torch._candidate_xors(x, norm)
    assert [c[1:] for c in s] == [(14, 18)]
    assert [c[1:] for c in p] == [(4, 6), (4, 10)]


def test_f64_adaptive_encode_sorts_10_16_and_20_20():
    x = _u64.from_numpy(words64(2, 256))
    with recording(fp64_torch, "_predict_sort64") as s:
        fp64_torch.encode_f64_chunks_v2_adaptive(x)
    assert [c[1:] for c in s] == [(10, 16), (20, 20)]


@pytest.mark.parametrize("path", ["codec/fp_torch.py", "codec/fp64_torch.py",
                                  "chunked.py", "archive.py", "parallel"])
def test_codec_modules_name_no_plain_version(path):
    """Only fp_cuda's wrappers reach a plain version (for CPU tensors)."""
    root = PKG / path
    files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert files
    for f in files:
        names = re.findall(r"\b\w+_plain\b", f.read_text())
        assert not names, f"{f.relative_to(PKG)} names {names}"


def test_sort_compare_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sort_compare.main(["--parent", str(tmp_path)]) == 1


@pytest.mark.parametrize("name", sorted(sort_compare.ENCODES))
def test_sort_compare_encodes_reach_the_sort_predictor(name):
    """Each encode that tools/sort_compare.py times takes the sort
    predictor for some candidate, and gives the sizes that the tool sums
    (here on small CPU tensors)."""
    scope = {"fp_torch": fp_torch, "fp64_torch": fp64_torch,
             "x": _u32.from_numpy(words(2, 256)),
             "x64": _u64.from_numpy(words64(2, 256))}
    fn = eval("lambda: " + sort_compare.ENCODES[name], scope)
    with recording(fp_torch, "_predict_sort") as s, \
            recording(fp64_torch, "_predict_sort64") as s64:
        sizes = fn()[1]
    assert len(s) + len(s64) > 0
    assert int(sizes.sum().item()) > 0
