"""The 95th percentile of one write's wall time in the window, from the
call into compress_mesh until the archive's bytes are on the host, over
every write of the window, in ms (host clock; nearest rank): a write's
tail, per layer where its runs spread too widely to hold a bound. Nothing
where the window holds fewer than 200 writes."""

from benchmark.latency import p95_ms


def read(run):
    return p95_ms(run, "write")
