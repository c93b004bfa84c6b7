"""u32 word arithmetic on torch tensors.

The port carries every u32 word as a ``torch.int32`` tensor holding the
word's bits: torch has no CPU add, right shift or compare for
``torch.uint32``. XOR, AND, OR and ``==`` act on those bits unchanged.
So do two torch operations on int32 whose low 32 bits are the u32 answer:
add and subtract wrap mod 2^32 in two's complement (as ``_u64`` relies on
for int64), and ``<<`` shifts the word's unsigned bits, so bits shifted
past bit 31 are lost and bit 31 is set as a u32 shift sets it. The port
uses these where the word's bits are the result: the BP32 zigzag deltas
and the ``logshift`` word. What reads a word as an unsigned number (a
compare, a logical right shift, a sum that must not wrap) runs in int64 on
the widened word (0 .. 2^32-1), masked with ``MASK``, and is narrowed back
to int32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bits → int64 holding the unsigned word."""
    return x.to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 bits of its low 32 bits (the word mod 2^32)."""
    x = x & MASK
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def shl(x, k):
    """Left shift by ``k`` (int or tensor, 0..32); bits past 31 are lost."""
    return narrow(widen(x) << k)


def shr(x, k):
    """Logical right shift by ``k`` (int or tensor, 0..32)."""
    return narrow(widen(x) >> k)


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """uint32 array → int32 tensor sharing its memory."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) → uint32 array."""
    return t.detach().cpu().numpy().view(np.uint32)
