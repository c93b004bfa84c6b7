"""trico_tpu_torch._u64 and the int64 idioms the f64 codec relies on: u64
words as int64 tensors, held against NumPy uint64 (exact)."""

import numpy as np
import pytest
import torch

from trico_tpu_torch import _u64
from trico_tpu_torch.codec import fp_cuda

EDGES = np.array([0, 1, 2, 0xFF, 0xFFFFFFFF, 0x100000000, 0x7FFFFFFFFFFFFFFF,
                  0x8000000000000000, 0x8000000000000001, 0xFFFFFFFFFFFFFFFE,
                  0xFFFFFFFFFFFFFFFF, 0xFFF0000000000000, 0x7FF8000000000001],
                 np.uint64)


def _pair(seed, n=4096):
    r = np.random.default_rng(seed)
    a = np.frombuffer(r.bytes(8 * n), np.uint64).copy()
    b = np.frombuffer(r.bytes(8 * n), np.uint64).copy()
    k = len(EDGES)
    a[:k], b[:k] = EDGES, EDGES[::-1]
    a[k : 2 * k], b[k : 2 * k] = EDGES, EDGES
    return a, b


def _t(a):
    return _u64.from_numpy(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_sub_wrap_like_uint64(seed):
    """int64 add and subtract wrap mod 2^64: fp64_jax's carry and borrow."""
    a, b = _pair(seed)
    np.testing.assert_array_equal(_u64.to_numpy(_t(a) + _t(b)), a + b)
    np.testing.assert_array_equal(_u64.to_numpy(_t(a) - _t(b)), a - b)


@pytest.mark.parametrize("e", [0, 2, 6, 12, 20, 30])
def test_top_bits_are_logical(e):
    """The predictors' key read: the top e bits, masked after the
    arithmetic shift; 0 when e == 0."""
    a, _ = _pair(e)
    want = a >> np.uint64(64 - e) if e else np.zeros_like(a)
    got = fp_cuda._top(_t(a), e, 64)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.min() >= 0


def test_join_builds_words_from_u32_halves():
    a, _ = _pair(5)
    hi = (a >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    np.testing.assert_array_equal(
        _u64.to_numpy(_u64.join(torch.from_numpy(hi), torch.from_numpy(lo.view(np.int32)))), a)
    np.testing.assert_array_equal(  # lo may also come as int64 holding the word
        _u64.to_numpy(_u64.join(torch.from_numpy(hi), torch.from_numpy(lo.astype(np.int64)))), a)


@pytest.mark.parametrize("byte", range(8))
def test_masked_arithmetic_shift_reads_bytes(byte):
    """The pack's byte read: ``(x >> 8k) & 0xFF`` on int64 is the byte, the
    sign copies of an arithmetic shift landing above bit 7."""
    a, _ = _pair(byte)
    want = (a >> np.uint64(8 * byte)) & np.uint64(0xFF)
    np.testing.assert_array_equal(((_t(a) >> (8 * byte)) & 0xFF).numpy(),
                                  want.astype(np.int64))


def test_bitwise_ops_and_equality_need_no_helper():
    a, b = _pair(6)
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(_u64.to_numpy(ta ^ tb), a ^ b)
    np.testing.assert_array_equal(_u64.to_numpy(ta & tb), a & b)
    np.testing.assert_array_equal(_u64.to_numpy(ta | tb), a | b)
    np.testing.assert_array_equal((ta == tb).numpy(), a == b)


def test_numpy_views_keep_bits():
    a, _ = _pair(4)
    t = _u64.from_numpy(a)
    assert t.dtype == torch.int64
    assert t.data_ptr() == a.ctypes.data  # no copy
    np.testing.assert_array_equal(_u64.to_numpy(t), a)
    f = np.array([-0.0, np.nan, -np.inf, 5e-324, -1.5])
    np.testing.assert_array_equal(_u64.to_numpy(_u64.from_numpy(f.view(np.uint64))),
                                  f.view(np.uint64))
