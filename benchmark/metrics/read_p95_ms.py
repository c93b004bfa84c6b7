"""The 95th percentile of one read's wall time in the window, from the
call into decompress_mesh until the arrays are on the host, over every
read of the window, in ms (host clock; nearest rank): a read's tail, per
layer where its runs spread too widely to hold a bound. Nothing where the
window holds fewer than 200 reads."""

from benchmark.latency import p95_ms


def read(run):
    return p95_ms(run, "read")
