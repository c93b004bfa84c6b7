"""Page-locked host buffers that the copies from the card reuse.

A copy from the card into fresh pageable memory (``t.cpu()``) goes through
CUDA's own staging buffer and touches every new page on the host; into
page-locked (pinned) memory the card writes at the link's rate.
:func:`to_host` copies a CUDA tensor into a named slot of a pool of
page-locked buffers and returns a NumPy array over the slot; a tensor
that is not on a CUDA device comes back as its own ``numpy()``.

A slot grows, to the next power of two of bytes (the size PyTorch's pinned
allocator takes for it anyway), only when a copy needs more than the slot
holds; so writes of one shape allocate page-locked memory on their first
write alone. Each thread of each process keeps its own pool, and nothing
frees it before the thread ends: a Lucy-size triangle stream (three
searched byte planes of 80 MiB, the BP rows of 339 MB) holds 1.5 GiB of
page-locked memory in the slots below, and a run of P processes holds P
pools.

The array is a view of the slot: it is valid until the next copy into the
same slot of the same thread. A caller consumes it, or copies out of it,
before it returns, and hands no view of a slot on to its own caller.

Slots of the port: ``lz4_off`` and ``lz4_rle`` (``lz4_torch.compress_plane``:
both are alive during the emit), ``bp_rows`` and ``bp_sizes``
(``chunked.encode_bp_chunked``). Tally (:func:`.profiling.count`):
``pinned_d2h``, a call and its bytes per copy into a slot; ``pinned_grow``,
a call and the bytes allocated per growth of a slot.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import profiling


class HostPool:
    """Named host buffers that only grow. ``pin=False`` allocates pageable
    memory with the same logic (what a host without a card can run)."""

    def __init__(self, pin: bool = True):
        self.pin = pin
        self._slots: dict[str, torch.Tensor] = {}

    def copy(self, t: torch.Tensor, slot: str) -> np.ndarray:
        """``t``'s values in ``slot``, as a NumPy array of its dtype and
        shape that views the slot."""
        nbytes = t.numel() * t.element_size()
        buf = self._slots.get(slot)
        if buf is None or buf.numel() < nbytes:
            size = 1 << max(nbytes - 1, 0).bit_length()
            del buf  # the old buffer goes before the new one comes
            self._slots.pop(slot, None)
            buf = self._slots[slot] = torch.empty(size, dtype=torch.uint8,
                                                  pin_memory=self.pin)
            profiling.count("pinned_grow", size)
        out = buf[:nbytes].view(t.dtype).view(t.shape)
        out.copy_(t)
        profiling.count("pinned_d2h", nbytes)
        return out.numpy()


_LOCAL = threading.local()


def to_host(t: torch.Tensor, slot: str) -> np.ndarray:
    """``t`` on the host: a CUDA tensor copied into ``slot`` of the calling
    thread's page-locked pool (a view, valid until the next copy into that
    slot), any other tensor as its own ``numpy()``."""
    if t.device.type != "cuda":
        return t.numpy()
    pool = getattr(_LOCAL, "pool", None)
    if pool is None:
        pool = _LOCAL.pool = HostPool()
    return pool.copy(t, slot)
