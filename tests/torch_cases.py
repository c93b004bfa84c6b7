"""Inputs and helpers shared by the tests of trico_tpu_torch (test_torch_*)."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

import trico_tpu.native
import trico_tpu_torch.native
from conftest import mesh_like_floats

SPECIAL = np.array([0x7FC00000, 0xFFC00000, 0x7F800000, 0xFF800000,
                    0x7F800001, 0x00000000, 0x80000000, 0x3F800000,
                    0xFFFFFFFF, 0x00000001], np.uint32)


def words(C: int, L: int, seed: int = 0) -> np.ndarray:
    """(C, L) uint32 rows cycling through mesh-like floats, zeros, a
    constant, random bits with NaN/inf patterns mixed in, and alternating
    signs."""
    r = np.random.default_rng(seed)
    out = np.empty((C, L), np.uint32)
    for c in range(C):
        kind = c % 5
        if kind == 0:
            out[c] = mesh_like_floats(L, seed=seed + c).view(np.uint32)
        elif kind == 1:
            out[c] = 0
        elif kind == 2:
            out[c] = np.float32(1.5).view(np.uint32)
        elif kind == 3:
            row = r.integers(0, 1 << 32, L, dtype=np.uint64).astype(np.uint32)
            hit = r.random(L) < 0.3
            row[hit] = SPECIAL[r.integers(0, len(SPECIAL), hit.sum())]
            out[c] = row
        else:
            f = mesh_like_floats(L, seed=seed + c)
            out[c] = (f * np.where(np.arange(L) % 2, -1, 1)).astype(
                np.float32).view(np.uint32)
    return out


SPECIAL64 = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 5e-324,
                      -1e-310, 2.2250738585072014e-308, 1.0, -1.5],
                     np.float64).view(np.uint64)


def words64(C: int, L: int, seed: int = 0) -> np.ndarray:
    """(C, L) uint64 rows cycling through mesh-like doubles, zeros, a
    constant, random bits with NaN/inf/signed-zero/subnormal patterns mixed
    in, negative random walks, and float32 mesh values widened to double."""
    r = np.random.default_rng(seed)
    out = np.empty((C, L), np.uint64)
    for c in range(C):
        kind = c % 6
        if kind == 0:
            out[c] = mesh_like_floats(L, seed=seed + c, dtype=np.float64).view(np.uint64)
        elif kind == 1:
            out[c] = 0
        elif kind == 2:
            out[c] = np.float64(-2.75).view(np.uint64)
        elif kind == 3:
            row = np.frombuffer(r.bytes(8 * L), np.uint64).copy()
            hit = r.random(L) < 0.3
            row[hit] = SPECIAL64[r.integers(0, len(SPECIAL64), hit.sum())]
            out[c] = row
        elif kind == 4:
            out[c] = (-np.abs(np.cumsum(r.normal(0, 1, L)))).view(np.uint64)
        else:
            out[c] = mesh_like_floats(L, seed=seed + c).astype(np.float64).view(np.uint64)
    return out


@contextlib.contextmanager
def recording(module, name: str):
    """Record the arguments of every call to ``module.name`` in a list."""
    calls = []
    real = getattr(module, name)

    def call(*args):
        calls.append(args)
        return real(*args)

    setattr(module, name, call)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def no_native(monkeypatch) -> None:
    """Run the rest of the test as if no C++ host library were built, in
    either package: both take their NumPy fallbacks."""
    monkeypatch.setattr(trico_tpu_torch.native, "available", lambda: False)
    monkeypatch.setattr(trico_tpu.native, "available", lambda: False)


_TPU_NATIVE_ASKED_AGAIN = []


def tpu_native_available() -> bool:
    """``trico_tpu.native.available()``, asked a second time after a
    failure. pytest-xdist workers that build trico_tpu's library at the same
    time write one shared temporary file (trico_tpu/native/__init__.py:43-49),
    so a worker can find it renamed by another, and then it holds the library
    unavailable for the rest of its run although the library was built. The
    second attempt, made once the workers have collected their tests, finds
    the library built and loads it; without g++ it fails again."""
    if not trico_tpu.native.available() and not _TPU_NATIVE_ASKED_AGAIN:
        _TPU_NATIVE_ASKED_AGAIN.append(True)
        trico_tpu.native._LOAD_ERROR = None
    return trico_tpu.native.available()


def require_native() -> None:
    """Skip the calling test unless the C++ host libraries are built: for the
    cases that have no NumPy fallback (the reference-layout pack and parse,
    the LZ4 emitter behind the device match search)."""
    if not (trico_tpu_torch.native.available() and tpu_native_available()):
        pytest.skip("needs the C++ host library (g++)")


@pytest.fixture
def align_native(monkeypatch):
    """The two packages pick their host codec by whether their own C++
    library is built. Where only one of the two built, run both without, so
    that a parity test compares like with like."""
    if tpu_native_available() != trico_tpu_torch.native.available():
        no_native(monkeypatch)
