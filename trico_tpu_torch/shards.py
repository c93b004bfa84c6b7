"""The shard runner: a mesh of devices, and the chunks each shard takes.

A :class:`Mesh` is one axis of shards (``"chunks"``), each a torch device;
one device is the mesh of one shard. Every codec of :mod:`.chunked` that
runs full chunks on a device runs them here: each shard takes its own
contiguous range of the chunks as one batch (:func:`local_chunks`), with no
communication, and :func:`gather_to_host` gathers the shards' rows in chunk
order.

In one process a gather is the host concatenation of each shard's result,
and a shard's results come to the host before the next shard starts, so
shards that share a card bound its peak memory. Where ``torch.distributed``
is initialized, a mesh of :func:`make_mesh` spans the default process group
and the gather is a ``dist.all_gather`` (gloo with CPU tensors, NCCL with
CUDA tensors), each rank's rows padded to one shape. Every rank holds the
whole host input and ends with the whole result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import _u32, _u64, profiling


def torch_device(device="cuda") -> torch.device:
    """The torch device to run on; raises for a card that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Mesh:
    """The devices a call spreads its chunks over: one axis of ``size``
    shards. ``shards`` are this process's shards in order, one
    ``torch.device`` each (a device may repeat); ``group`` is the process
    group the mesh spans: None in one process, the default group where
    ``torch.distributed`` is initialized. Global shard ``rank * len(shards)
    + j`` is rank ``rank``'s local shard ``j``."""

    def __init__(self, shards, group=None):
        self.shards = tuple(torch.device(s) for s in shards)
        if not self.shards:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world_size = dist.get_world_size(group) if group is not None else 1
        self.size = self.world_size * len(self.shards)

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, rank={self.rank}, "
                f"shards={[str(s) for s in self.shards]})")


def make_mesh(n_devices: int | None = None, *, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards in all, on ``device``: ``"cuda"``
    (the default; raises where there is no card) or ``"cpu"``.

    In one process, ``make_mesh()`` has one shard per visible card, and
    ``make_mesh(n)`` n shards; with ``device="cuda"`` global shard ``g`` is
    on card ``g % device_count``, so shards repeat a card where there are
    more shards than cards (``device="cuda:k"`` puts every shard on card
    k). ``make_mesh(n, device="cpu")`` lists the CPU n times. Where
    ``torch.distributed`` is initialized, ``n_devices`` (one per rank by
    default) must be a multiple of the world size, and each rank holds
    ``n_devices / world_size`` shards."""
    dev = torch_device(device)
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    if n_devices is None:
        n_devices = (world if group is not None or dev.type == "cpu"
                     else torch.cuda.device_count())
    if n_devices < 1 or n_devices % world:
        raise ValueError(f"{n_devices} shards cannot be split evenly over "
                         f"{world} processes")
    if group is not None and dev.type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("an NCCL process group needs a mesh on CUDA devices")
    n_local = n_devices // world
    first = (dist.get_rank() if group is not None else 0) * n_local
    if dev.type == "cuda" and dev.index is None:
        shards = [torch.device("cuda", g % torch.cuda.device_count())
                  for g in range(first, first + n_local)]
    else:
        shards = [dev] * n_local
    return Mesh(shards, group)


def shard_bounds(C: int, mesh: Mesh) -> list[int]:
    """Chunk boundaries of the mesh's global shards: shard g takes chunks
    ``bounds[g]:bounds[g + 1]`` (an even split; counts differ by one at
    most)."""
    return [g * C // mesh.size for g in range(mesh.size + 1)]


def _rank_counts(C: int, mesh: Mesh) -> list[int]:
    """Chunks each rank's shards take together, in rank order."""
    b = shard_bounds(C, mesh)
    n = len(mesh.shards)
    return [b[(r + 1) * n] - b[r * n] for r in range(mesh.world_size)]


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """u32 words → int32 bits, u64 words → int64 bits, bytes as they are."""
    if a.dtype == np.uint32:
        return _u32.from_numpy(a)
    if a.dtype == np.uint64:
        return _u64.from_numpy(a)
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8))


def _to_host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().view(dtype)


def local_chunks(fn, rows, mesh: Mesh, specs,
                 copies: tuple[str, str]) -> list[np.ndarray]:
    """Apply ``fn`` to this process's chunks of host ``rows`` (p, C, ...),
    or of each array of a tuple of them that share (p, C): each local shard
    takes its range of the chunk axis as one batch of ``p * c`` chunks on
    its device, and ``fn`` (one tensor per input array) returns one tensor
    per ``specs`` entry ``(trailing shape, NumPy dtype)``, each (p * c, ...).
    Returns the host arrays (p, c_rank, ...) of this rank's chunks, in
    order. A shard's results reach the host before the next shard starts.
    ``copies`` names the spans of the copy to the device and of the copy
    back (``profiling.span``); while tracing is on, the device is waited
    for before the copy back, so that span holds no kernel."""
    h2d, d2h = copies
    rows = rows if isinstance(rows, tuple) else (rows,)
    p, C = rows[0].shape[:2]
    bounds = shard_bounds(C, mesh)
    first = mesh.rank * len(mesh.shards)
    parts = [[] for _ in specs]
    for j, dev in enumerate(mesh.shards):
        lo, hi = bounds[first + j], bounds[first + j + 1]
        if hi == lo:
            continue
        with profiling.span(h2d, nbytes=sum(r[:, lo:hi].nbytes for r in rows)):
            xs = [_to_tensor(np.ascontiguousarray(r[:, lo:hi]).reshape(
                p * (hi - lo), *r.shape[2:])).to(dev) for r in rows]
        outs = fn(*xs)
        profiling.settle(dev)
        with profiling.span(d2h, nbytes=sum(o.numel() * o.element_size()
                                            for o in outs)):
            for part, out, (shape, dtype) in zip(parts, outs, specs):
                part.append(_to_host(out, dtype).reshape(p, hi - lo, *shape))
        del xs, outs
    return [part[0] if len(part) == 1
            else np.concatenate(part, axis=1) if part
            else np.zeros((p, 0, *shape), dtype)
            for part, (shape, dtype) in zip(parts, specs)]


def gather_to_host(x: np.ndarray, C: int, mesh: Mesh) -> np.ndarray:
    """This rank's chunk rows (p, c_rank, ...) → every rank's, (p, C, ...) in
    chunk order, on every rank.

    In one process the rows are already all of them. Across processes it
    is one ``dist.all_gather`` of the rows as bytes, each rank's padded to
    the largest rank's count: CPU tensors for gloo, tensors on the rank's
    first shard for NCCL."""
    if mesh.group is None:
        return x
    counts = _rank_counts(C, mesh)
    cmax = max(counts)
    if cmax == 0:
        return x
    padded = np.zeros((x.shape[0], cmax, *x.shape[2:]), x.dtype)
    padded[:, : x.shape[1]] = x
    t = torch.from_numpy(padded.reshape(-1).view(np.uint8))
    if dist.get_backend(mesh.group) == "nccl":
        t = t.to(mesh.shards[0])
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return np.concatenate(
        [_to_host(q, x.dtype).reshape(padded.shape)[:, :c]
         for q, c in zip(parts, counts)], axis=1)
