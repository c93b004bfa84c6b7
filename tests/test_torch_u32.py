"""trico_tpu_torch._u32: u32 arithmetic on int32 tensors, held against NumPy
uint32 (exact)."""

import numpy as np
import pytest
import torch

from trico_tpu_torch import _u32

EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                  0xFFFFFFFF, 0x00FF00FF, 0xFF00FF00], np.uint32)


def _pair(seed, n=4096):
    r = np.random.default_rng(seed)
    a = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    a[: len(EDGES)] = EDGES
    b[: len(EDGES)] = EDGES[::-1]
    b[len(EDGES) : 2 * len(EDGES)] = EDGES
    a[len(EDGES) : 2 * len(EDGES)] = EDGES
    return a, b


def _t(a):
    return _u32.from_numpy(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_widened_add_sub_wrap_like_uint32(seed):
    """The plain kernels' arithmetic: widen, add or subtract, mask, narrow."""
    a, b = _pair(seed)
    wa, wb = _u32.widen(_t(a)), _u32.widen(_t(b))
    np.testing.assert_array_equal(_u32.to_numpy(_u32.narrow(wa + wb)), a + b)
    np.testing.assert_array_equal(_u32.to_numpy(_u32.narrow(wa - wb)), a - b)
    np.testing.assert_array_equal(((wa - wb) & _u32.MASK).numpy(),
                                  (a - b).astype(np.int64))


@pytest.mark.parametrize("k", [0, 1, 7, 8, 15, 16, 24, 31, 32])
def test_shifts_by_int(k):
    a, _ = _pair(k)
    a64 = a.astype(np.uint64)
    want_l = ((a64 << np.uint64(k)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want_r = (a64 >> np.uint64(k)).astype(np.uint32)
    np.testing.assert_array_equal(_u32.to_numpy(_u32.shl(_t(a), k)), want_l)
    np.testing.assert_array_equal(_u32.to_numpy(_u32.shr(_t(a), k)), want_r)


def test_shifts_by_tensor():
    a, _ = _pair(7)
    k = np.random.default_rng(7).integers(0, 33, len(a))
    a64 = a.astype(np.uint64)
    want_l = ((a64 << k.astype(np.uint64)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want_r = (a64 >> k.astype(np.uint64)).astype(np.uint32)
    kt = torch.from_numpy(k.astype(np.int32))
    np.testing.assert_array_equal(_u32.to_numpy(_u32.shl(_t(a), kt)), want_l)
    np.testing.assert_array_equal(_u32.to_numpy(_u32.shr(_t(a), kt)), want_r)


@pytest.mark.parametrize("seed", [0, 1])
def test_widened_words_order_like_uint32(seed):
    a, b = _pair(seed)
    np.testing.assert_array_equal(
        (_u32.widen(_t(a)) < _u32.widen(_t(b))).numpy(), a < b)


def test_widen_narrow_round_trip():
    a, _ = _pair(3)
    wide = _u32.widen(_t(a))
    assert wide.dtype == torch.int64
    np.testing.assert_array_equal(wide.numpy(), a.astype(np.int64))
    np.testing.assert_array_equal(_u32.to_numpy(_u32.narrow(wide)), a)
    # narrow keeps the low 32 bits of anything wider
    big = wide + (np.int64(5) << 32)
    np.testing.assert_array_equal(_u32.to_numpy(_u32.narrow(big)), a)


def test_numpy_views_keep_bits():
    a, _ = _pair(4)
    t = _u32.from_numpy(a)
    assert t.dtype == torch.int32
    assert t.data_ptr() == a.ctypes.data  # no copy
    np.testing.assert_array_equal(_u32.to_numpy(t), a)


def test_bitwise_ops_need_no_helper():
    """XOR, AND, OR and == act on int32 bits exactly as on uint32."""
    a, b = _pair(5)
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(_u32.to_numpy(ta ^ tb), a ^ b)
    np.testing.assert_array_equal(_u32.to_numpy(ta & tb), a & b)
    np.testing.assert_array_equal(_u32.to_numpy(ta | tb), a | b)
    np.testing.assert_array_equal((ta == tb).numpy(), a == b)
