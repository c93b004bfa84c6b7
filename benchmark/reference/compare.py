"""The comparison that decides ``correct``: raw words, exactly."""

from __future__ import annotations

import numpy as np

_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def words(a) -> np.ndarray:
    """An array's raw words, flat: floats as their bits."""
    a = np.ascontiguousarray(a)
    return a.reshape(-1).view(_UINT[a.dtype.itemsize])


def words_wrong(got: dict, want: dict) -> int:
    """Words of ``want`` that ``got`` does not hold exactly: a stream that
    is missing, extra, or of another shape or width counts whole."""
    wrong = 0
    for name in sorted(set(got) | set(want)):
        a = words(got[name]) if name in got else None
        b = words(want[name]) if name in want else None
        if a is None or b is None:
            wrong += len(a if b is None else b)
        elif a.dtype != b.dtype or a.shape != b.shape:
            wrong += max(len(a), len(b))
        else:
            wrong += int(np.count_nonzero(a != b))
    return wrong


def strided(arrays: dict, stride: int) -> dict:
    """Every ``stride``-th word of each stream, and its length in words,
    for a check that keeps little of a large answer."""
    flat = {name: words(a) for name, a in arrays.items()}
    return {name: (w[::stride].copy(), w.size, w.dtype) for name, w in flat.items()}


def strided_wrong(got: dict, want: dict) -> int:
    """:func:`words_wrong` of two :func:`strided` samples."""
    wrong = 0
    for name in sorted(set(got) | set(want)):
        if name not in got or name not in want:
            wrong += (got.get(name) or want.get(name))[1]
            continue
        (a, na, da), (b, nb, db) = got[name], want[name]
        if na != nb or da != db:
            wrong += max(na, nb)
        else:
            wrong += int(np.count_nonzero(a != b))
    return wrong
