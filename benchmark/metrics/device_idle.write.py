"""Percent of the writes' wall time in which the card ran nothing
(torch.profiler: kernels, copies and memsets, inside the write spans)."""


def read(run):
    if run.trace is None or not run.trace.busy_s.size:
        return None
    total = run.trace.span_seconds(["write"])
    return 100 * (1 - run.trace.busy_in(["write"]) / total) if total > 0 else None
