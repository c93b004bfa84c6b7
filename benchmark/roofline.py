"""The table of peaks, and the bytes an FP stream's codec has to move.

A roofline share here is the least time the card could take for the work
(its bytes over the card's memory bandwidth; the FP codec does a few
integer operations a byte, so bandwidth bounds it), over the time the card
was busy with it. The work is the stream's and not the kernels': each
full chunk's words read once and its payload written once (or, to decode,
the payload read once and the words written once). The partial last
chunk of a plane is coded on the host and is not counted. Kernels that are
fused, removed or replaced leave the count as it is.
"""

from __future__ import annotations

from .reference.archive import FP_STREAMS, streams

# NVIDIA's H100 SXM data sheet: HBM3 at 3.35 TB/s, at the full 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str) -> float | None:
    """The card's memory bandwidth, or None for a card not in the table."""
    peak = PEAKS.get(kind)
    return peak["hbm_bytes_per_s"] if peak else None


def fp_full_chunk_bytes(blob: bytes) -> int:
    """Words and payload bytes of every full FP chunk in an archive."""
    total = 0
    for st, _, subs in streams(blob):
        if st not in FP_STREAMS:
            continue
        word = FP_STREAMS[st][2] // 8
        for c in subs:
            for payload, n in zip(c.chunks, c.counts()):
                if n == c.chunk_len:
                    total += n * word + len(payload)
    return total
