"""What the program records of itself, for the readers of per-layer
metrics: the spans ``trico_tpu_torch`` opens with ``profiling.span`` and
its tally of calls and bytes (``profiling.tally``).

Spans of a write reach the run's recorder (``compress_mesh(profile=...)``
makes it theirs); spans of a read are ``torch.profiler`` annotations in the
run's trace, as the harness passes no recorder to ``decompress_mesh``. A
program that has no such spans or tally gives None to every reader here,
so its result line leaves the metric out; one that has them but did not
open a span in the window spent 0 ms there.
"""

from __future__ import annotations


def _profiling():
    """The program's profiling module, if it has spans and a tally."""
    try:
        from trico_tpu_torch import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "span") and hasattr(profiling, "tally")):
        return None
    return profiling


def recorded_ms(run, kind: str, names) -> float | None:
    """Milliseconds a request of ``kind`` spends in the recorder's spans
    ``names``, summed, per request."""
    n = len(run.of(kind))
    if _profiling() is None or run.spans is None or not n:
        return None
    return run.spans.seconds(names, kind) * 1e3 / n


def traced_ms(run, kind: str, names) -> float | None:
    """Milliseconds a request of ``kind`` spends in the union of the trace's
    annotations ``names``, per request (the names are the program's spans
    of that kind of request alone)."""
    n = len(run.of(kind))
    if _profiling() is None or run.trace is None or not n:
        return None
    return run.trace.span_seconds(names) * 1e3 / n


def tally_bytes_ratio(num, den) -> float | None:
    """The tally's bytes under the names ``num`` over those under ``den``.
    The tally counts the whole process: set-up's warm write and read too."""
    profiling = _profiling()
    if profiling is None:
        return None
    tally = profiling.tally()
    below = sum(tally.get(k, (0, 0))[1] for k in den)
    if not below:
        return None
    return sum(tally.get(k, (0, 0))[1] for k in num) / below
