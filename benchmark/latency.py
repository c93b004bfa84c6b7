"""A latency tail of the window's requests, on the host's clock."""

from __future__ import annotations

LEAST = 200  # requests a p95 needs, so that ten or more lie beyond it


def nearest_rank(values, percent: int) -> float:
    """The ``percent``-th percentile of ``values`` by nearest rank: the
    least value that ``percent`` % of them do not exceed."""
    ordered = sorted(values)
    rank = max(-(-percent * len(ordered) // 100), 1)  # ceil, in integers
    return ordered[rank - 1]


def p95_ms(run, kind: str) -> float | None:
    """The 95th percentile of one request's wall time, over every request
    of ``kind`` that the window completed, in ms; None where the window
    completed fewer than ``LEAST``."""
    ms = [(r.t1 - r.t0) * 1e3 for r in run.of(kind)]
    return nearest_rank(ms, 95) if len(ms) >= LEAST else None
