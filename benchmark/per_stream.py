"""Per-stream readings of what the program records of itself:
``compress_mesh`` opens the span ``write.<stream>`` around each stream's
writer and tallies the bytes the stream added to the archive under
``archive.<stream>``; ``decompress_mesh`` opens ``read.<stream>`` around
each stream's decode.

A program that has no such span or count (its tally holds no entry of the
name) gives None to every reader here, never 0 ms or a ratio of nothing.
"""

from __future__ import annotations

from .inside import _profiling, recorded_ms, traced_ms
from .reference.archive import FP_STREAMS, INT_STREAMS, streams


def _tallied(name: str) -> bool:
    profiling = _profiling()
    return profiling is not None and name in profiling.tally()


def write_ms(run, stream: str) -> float | None:
    """Milliseconds a write spends in ``write.<stream>`` (the recorder's
    spans), per write."""
    span = f"write.{stream}"
    return recorded_ms(run, "write", (span,)) if _tallied(span) else None


def read_ms(run, stream: str) -> float | None:
    """Milliseconds a read spends in ``read.<stream>`` (the trace's
    annotations), per read."""
    span = f"read.{stream}"
    return traced_ms(run, "read", (span,)) if _tallied(span) else None


def _raw_and_stored(blob: bytes, stream: str) -> tuple[int, int]:
    """A stream's raw bytes, from its count, and the bytes it takes in the
    archive: its type byte and count, and each substream's size and
    container (what the program counts under ``archive.<stream>``)."""
    for st, count, subs in streams(blob):
        if st in FP_STREAMS and FP_STREAMS[st][0] == stream:
            _, width, bits = FP_STREAMS[st]
            raw = count * width * bits // 8
        elif st in INT_STREAMS and INT_STREAMS[st][0] == stream:
            _, width, mult = INT_STREAMS[st]
            raw = count * mult * width
        else:
            continue
        stored = 5 + sum(4 + 14 + 4 * len(c.chunks) + sum(len(p) for p in c.chunks)
                         for c in subs)
        return raw, stored
    return 0, 0


def ratio(run, stream: str) -> float | None:
    """Raw bytes of ``stream`` over the bytes it takes in the archives, over
    the first archive written of each pool entry, as ``ratio`` takes the
    whole archives: deterministic for a seed. The bytes are those the
    program counts under ``archive.<stream>``, read from the archives'
    framing: the tally sums every write of the process, so it would weigh
    the entries by how many writes each had in the window."""
    if not _tallied(f"archive.{stream}"):
        return None
    first: dict[int, bytes] = {}
    for r in run.of("write"):
        first.setdefault(r.pool, r.archive)
    pairs = [_raw_and_stored(blob, stream) for _, blob in sorted(first.items())]
    stored = sum(s for _, s in pairs)
    return sum(r for r, _ in pairs) / stored if stored else None
