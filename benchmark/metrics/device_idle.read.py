"""Percent of the reads' wall time in which the card ran nothing
(torch.profiler: kernels, copies and memsets, inside the read spans)."""


def read(run):
    if run.trace is None or not run.trace.busy_s.size:
        return None
    total = run.trace.span_seconds(["read"])
    return 100 * (1 - run.trace.busy_in(["read"]) / total) if total > 0 else None
