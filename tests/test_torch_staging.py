"""The reused host buffers of the copies from the card
(trico_tpu_torch.staging): the pool's logic with pageable slots
(``HostPool(pin=False)``) and the integer encode routed through it on the
host; on the card, the integer encode through page-locked slots gives the
host path's bytes (which test_torch_lz4.py holds against trico_tpu's), no
view of a slot outlives its call, and a second write grows no slot.

The file imports no JAX, so its card cases run where there is none:
``python -m pytest tests/test_torch_staging.py --noconftest -q`` on the
card (tests/conftest.py imports JAX)."""

import numpy as np
import pytest
import torch

import trico_tpu_torch.chunked as tc
from trico_tpu_torch import ArchiveWriter, native, profiling, staging
from trico_tpu_torch.codec import lz4_torch

from torch_int_cases import KINDS, int_cases, plane

SLOTS = {"lz4_off", "lz4_rle", "bp_rows", "bp_sizes"}


def _delta(before: dict, name: str) -> tuple[int, int]:
    """(calls, bytes) added to the tally under ``name`` since ``before``."""
    calls, nbytes = profiling.tally().get(name, (0, 0))
    c0, b0 = before.get(name, (0, 0))
    return calls - c0, nbytes - b0


def _require_native():
    if not native.available():
        pytest.skip("needs the C++ host library (g++): the LZ4 emitter")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")


@pytest.fixture
def host_pool(monkeypatch):
    """Every tensor the codec copies to the host goes through one pageable
    pool, as a CUDA tensor goes through the page-locked one."""
    pool = staging.HostPool(pin=False)
    monkeypatch.setattr(staging, "to_host", lambda t, slot: pool.copy(t, slot))
    return pool


# --- the pool ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
def test_a_second_copy_of_the_same_size_reuses_the_slot(dtype):
    pool = staging.HostPool(pin=False)
    t = torch.arange(3 * 1000, dtype=dtype).reshape(3, 1000)
    first = pool.copy(t, "a")
    before = profiling.tally()
    second = pool.copy(t + 1, "a")
    assert _delta(before, "pinned_grow") == (0, 0)
    assert np.shares_memory(first, second)
    np.testing.assert_array_equal(second, (t + 1).numpy())
    assert second.dtype == t.numpy().dtype and second.shape == (3, 1000)


@pytest.mark.parametrize("n", [1, 1000, 4096, 4097])
def test_a_larger_copy_grows_the_slot_to_a_power_of_two(n):
    pool = staging.HostPool(pin=False)
    pool.copy(torch.zeros(1, dtype=torch.int32), "a")
    assert pool._slots["a"].numel() == 4
    before = profiling.tally()
    got = pool.copy(torch.arange(n, dtype=torch.int32), "a")
    size = 1 << (4 * n - 1).bit_length()
    assert pool._slots["a"].numel() == size
    assert _delta(before, "pinned_grow") == ((1, size) if size > 4 else (0, 0))
    np.testing.assert_array_equal(got, np.arange(n, dtype=np.int32))
    before = profiling.tally()
    pool.copy(torch.ones(1, dtype=torch.int32), "a")  # smaller: no growth
    assert _delta(before, "pinned_grow") == (0, 0) and pool._slots["a"].numel() == size


@pytest.mark.parametrize("shape", [(0,), (5, 7), (2, 3, 4)])
def test_the_tally_counts_the_bytes_of_every_copy(shape):
    pool = staging.HostPool(pin=False)
    t = torch.ones(shape, dtype=torch.int32)
    before = profiling.tally()
    pool.copy(t, "a")
    pool.copy(t, "a")
    assert _delta(before, "pinned_d2h") == (2, 2 * 4 * t.numel())


def test_slots_are_apart_and_a_view_lasts_until_its_slot_is_refilled():
    pool = staging.HostPool(pin=False)
    a = pool.copy(torch.full((8,), 1, dtype=torch.int32), "a")
    b = pool.copy(torch.full((8,), 2, dtype=torch.int32), "b")
    assert not np.shares_memory(a, b)
    assert (a == 1).all() and (b == 2).all()
    pool.copy(torch.full((8,), 3, dtype=torch.int32), "a")
    assert (a == 3).all() and (b == 2).all()  # a view, as the docstring says


def test_a_strided_tensor_comes_back_in_order():
    pool = staging.HostPool(pin=False)
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    np.testing.assert_array_equal(pool.copy(t.T, "a"), t.numpy().T)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_a_tensor_off_the_card_comes_back_as_its_own_numpy(dtype):
    t = torch.arange(64, dtype=dtype)
    before = profiling.tally()
    got = staging.to_host(t, "lz4_off")
    assert np.shares_memory(got, t.numpy())
    assert _delta(before, "pinned_d2h") == (0, 0)
    assert _delta(before, "pinned_grow") == (0, 0)


# --- the integer encode through the pool, on the host -------------------------


@pytest.mark.parametrize("case", ["u32_index", "u32_near", "u32_colors",
                                  "u64_index", "u64_wide", "u16"])
def test_the_integer_encode_through_the_slots_gives_the_same_bytes(case, host_pool):
    _require_native()
    arr = int_cases()[case]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(staging, "to_host", lambda t, slot: t.numpy())
        want = tc.encode_int_best(arr, 4096, device="cpu")
    before = profiling.tally()
    assert tc.encode_int_best(arr, 4096, device="cpu") == want
    assert _delta(before, "pinned_d2h")[1] == (
        _delta(before, "lz4_d2h")[1] + _delta(before, "bp_d2h")[1]) > 0


def test_a_second_encode_of_one_shape_grows_no_slot(host_pool):
    _require_native()
    arr = int_cases()["u32_index"]
    tc.encode_int_best(arr, 4096, device="cpu")
    assert set(host_pool._slots) == SLOTS
    before = profiling.tally()
    tc.encode_int_best(arr[::-1].copy(), 4096, device="cpu")
    assert _delta(before, "pinned_grow") == (0, 0)
    copies = _delta(before, "lz4_d2h")[0] + _delta(before, "bp_d2h")[0]
    assert _delta(before, "pinned_d2h")[0] == 2 * copies  # two slots a copy span


# --- on the card ----------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,block", [(3 * 4096 + 17, 4096), ((2 << 20) + 5, 1 << 20)])
def test_compress_plane_on_the_card_gives_the_host_bytes(card, kind, n, block):
    _require_native()
    p = plane(kind, n, seed=n)
    assert (lz4_torch.compress_plane(p, block, device="cuda")
            == lz4_torch.compress_plane(p, block, device="cpu"))


@pytest.mark.card
@pytest.mark.parametrize("case", list(int_cases()))
def test_encode_int_best_on_the_card_gives_the_host_bytes(card, case):
    arr = int_cases()[case]
    assert (tc.encode_int_best(arr, 4096, device="cuda")
            == tc.encode_int_best(arr, 4096, device="cpu"))


@pytest.mark.card
def test_no_view_of_a_slot_outlives_its_call(card):
    """Planes of two sizes in turns through the same slots: each call's
    bytes are a fresh call's."""
    _require_native()
    a, b = plane("index", 3 * (1 << 20) + 9, seed=1), plane("ff", 2 << 20, seed=2)
    want = {k: lz4_torch.compress_plane(p, 1 << 20, device="cpu")
            for k, p in (("a", a), ("b", b))}
    for k, p in (("a", a), ("b", b), ("a", a), ("b", b)):
        assert lz4_torch.compress_plane(p, 1 << 20, device="cuda") == want[k]


@pytest.mark.card
def test_a_second_write_on_the_card_grows_no_slot(card):
    """Every byte of the integer encode's copies lands in a page-locked
    slot, and a second write of one shape allocates none."""
    _require_native()
    i = np.arange(3 * 400_000, dtype=np.uint32)
    tris = (i // 3 + (i % 3) * 7 + i % 1024).reshape(-1, 3)  # planes of 1.2 MB

    def write():
        w = ArchiveWriter(chunk_len=4096, device="cuda")
        w.write_triangles(tris)
        return w.tobytes()

    host = ArchiveWriter(chunk_len=4096, device="cpu")
    host.write_triangles(tris)
    assert write() == host.tobytes()
    before = profiling.tally()
    assert write() == host.tobytes()
    assert _delta(before, "pinned_grow") == (0, 0)
    lz4, bp = _delta(before, "lz4_d2h"), _delta(before, "bp_d2h")
    assert (lz4[0], bp[0]) == (3, 1)  # three planes searched (the fourth is a fill), BP
    assert _delta(before, "pinned_d2h") == (2 * (lz4[0] + bp[0]), lz4[1] + bp[1])
