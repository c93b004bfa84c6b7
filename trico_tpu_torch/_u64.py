"""u64 word arithmetic on torch tensors.

The port carries every u64 word (the bits of a double) as a ``torch.int64``
tensor holding the word's bits; the JAX package carries it as a (hi, lo)
pair of u32 words because the TPU has no 64-bit integers
(``trico_tpu/codec/fp64_jax.py``). XOR, AND, OR, ``==``, add and subtract
act on int64 bits as on u64: add and subtract wrap mod 2^64 in two's
complement, which is what ``fp64_jax._add64`` / ``_sub64`` compute with
their carry and borrow.

Two operations differ from u64: ``>>`` on int64 is arithmetic, so a read
of the top e bits masks off the copies of the sign bit (``fp_cuda._top``);
and a left shift into bit 63 is signed overflow, so :func:`join` builds a
word from its u32 halves with the high half sign-extended, where the shift
cannot overflow.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """u64 words from their u32 halves, each given as int32 bits (or, for
    ``lo``, as int64 holding the word)."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & MASK32)


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """uint64 array → int64 tensor sharing its memory."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor (any device) → uint64 array."""
    return t.detach().cpu().numpy().view(np.uint64)
