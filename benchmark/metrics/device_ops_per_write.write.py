"""Device operations (kernels, copies and memsets, torch.profiler) that a
write launches: those enqueued inside each write span, averaged over the
writes of each pool entry and then over the entries (see
benchmark/devtrace.py's ops_per_request). The data decides which chunks
go to the host, so it may differ between seeds; for one seed it repeats."""

from benchmark.devtrace import ops_per_request


def read(run):
    return ops_per_request(run, "write")
