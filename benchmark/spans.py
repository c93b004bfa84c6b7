"""The benchmark's spans, recorded from its own files.

``compress_mesh(profile=...)`` takes any object with a ``StageTimer``-like
``stage(name, nbytes=0, sync=None)`` context manager, and times its stages
with it: ``fp_device_encode``, ``fp_gather``, ``fp_assembly``, ``fp_tails``
and ``int_encode``. ``decompress_mesh`` has no such hook, so the benchmark
wraps the three functions it routes containers to while a traced run
lasts: ``fp_decode`` (``mesh_codec.decode_plane_sharded``), ``bp_decode``
(``mesh_codec.decode_bp_sharded``) and ``lz4_decode``
(``chunked.decode_lz4_chunked``). Every request is a span too (``write``,
``read``). Each span is also a ``torch.profiler`` annotation of the same
name, so the device trace can be cut by it.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    """Spans in memory: (name, request kind, start, end), host clock."""

    def __init__(self):
        self.records: list[tuple[str, str | None, float, float]] = []
        self.kind: str | None = None

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0, sync=None):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
                if sync is not None and torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self.records.append((name, self.kind, t0, time.perf_counter()))

    @contextlib.contextmanager
    def request(self, kind: str):
        self.kind = kind
        try:
            with self.stage(kind):
                yield
        finally:
            self.kind = None

    @contextlib.contextmanager
    def wrapping_decoders(self):
        """Wrap the decoders ``decompress_mesh`` routes to, and put them
        back afterwards."""
        from trico_tpu_torch import chunked
        from trico_tpu_torch.parallel import mesh_codec
        targets = [(mesh_codec, "decode_plane_sharded", "fp_decode"),
                   (mesh_codec, "decode_bp_sharded", "bp_decode"),
                   (chunked, "decode_lz4_chunked", "lz4_decode")]
        saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]

        def wrap(fn, name):
            def timed(*args, **kwargs):
                with self.stage(name):
                    return fn(*args, **kwargs)
            return timed

        for (owner, attr, name), (_, _, fn) in zip(targets, saved):
            setattr(owner, attr, wrap(fn, name))
        try:
            yield
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)

    def seconds(self, names, kind: str | None = None) -> float:
        """Summed seconds of the spans named ``names`` (of requests of
        ``kind``, if given)."""
        return sum(t1 - t0 for n, k, t0, t1 in self.records
                   if n in names and (kind is None or k == kind))

    def count(self, names, kind: str | None = None) -> int:
        return sum(1 for n, k, _, _ in self.records
                   if n in names and (kind is None or k == kind))
