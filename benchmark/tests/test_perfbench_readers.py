"""The readers of the latency tail and of the device operations per
request: exact on known inputs, and nothing where there is too little to
read."""

import pytest

from benchmark import harness, latency
from benchmark.devtrace import Trace, ops_per_request
from conftest import REPO


def reader(name):
    return harness.load_reader(REPO / "benchmark", name)


def run_of(requests, trace=None):
    run = harness.Run({}, {}, {}, "cpu")
    run.requests = requests
    run.trace = trace
    return run


def timed(kind, ms, pool=0):
    return [harness.Request(kind, pool, 0.0, t / 1e3, 1, b"x") for t in ms]


@pytest.mark.parametrize("kind,metric", [("write", "write_p95_ms"), ("read", "read_p95_ms")])
def test_the_p95_is_the_nearest_rank_of_every_request(kind, metric):
    other = "read" if kind == "write" else "write"
    ms = [(37 * i) % 200 + 1 for i in range(200)]  # 1..200, shuffled
    run = run_of(timed(kind, ms) + timed(other, [5000] * 300))
    assert reader(metric)(run) == pytest.approx(190.0, abs=1e-9)
    run = run_of(timed(kind, list(range(1, 202))))  # 201: rank ceil(190.95) = 191
    assert reader(metric)(run) == pytest.approx(191.0, abs=1e-9)
    failed = [harness.Request(kind, 0, 0.0, 9.0, 0, None)] * 50  # not completed: not counted
    run = run_of(timed(kind, ms[:199]) + failed)
    assert reader(metric)(run) is None


def test_nearest_rank():
    assert latency.nearest_rank([3, 1, 2], 95) == 3
    assert latency.nearest_rank(range(1, 101), 95) == 95
    assert latency.nearest_rank(range(1, 21), 95) == 19
    assert latency.nearest_rank([7], 50) == 7


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_trace():
    """Three writes (pool entries 0, 1, 0) and two reads, in microseconds.

    Write 1 (0-100) launches three kernels; the third launches at 90 and
    runs at 120-130, after the span: it is still the write's. Write 2
    (200-300) launches one copy and one memset. Write 3 (400-500) launches
    three. A kernel with no launch in the trace counts where it starts
    (read 1's). A launch that lies in no span counts for nothing."""
    ev = [X("user_annotation", "write", 0, 100), X("user_annotation", "write", 200, 100),
          X("user_annotation", "write", 400, 100),
          X("user_annotation", "read", 100, 90), X("user_annotation", "read", 300, 90),
          X("user_annotation", "fp_decode", 305, 10)]
    corr = 0

    def op(cat, launch, start):
        nonlocal corr
        corr += 1
        ev.append(X("cuda_runtime", "cudaLaunchKernel", launch, 2, corr))
        ev.append(X(cat, "k", start, 5, corr))

    for t in (10, 50, 90):
        op("kernel", t, t + 30)
    op("gpu_memcpy", 210, 215)
    op("gpu_memset", 250, 255)
    for t in (410, 420, 430):
        op("kernel", t, t + 5)
    ev.append(X("kernel", "orphan", 150, 5))  # no launch: read 1's by its start
    op("kernel", 310, 312)  # read 2
    op("kernel", 600, 605)  # in no span
    return Trace(ev)


def test_device_ops_are_counted_per_span_by_their_launch():
    trace = hand_trace()
    assert trace.ops_in_each("write").tolist() == [3, 2, 3]
    assert trace.ops_in_each("read").tolist() == [1, 1]
    assert trace.ops_in_each("nothing").tolist() == []


def test_the_op_readers_average_each_pool_entry_then_the_entries():
    trace = hand_trace()
    reqs = (timed("write", [1], 0) + timed("write", [1], 1) + timed("write", [1], 0)
            + timed("read", [1], 0) + timed("read", [1], 1))
    reqs.sort(key=lambda r: r.kind)  # order within a kind is what pairs them
    run = run_of(reqs, trace)
    # entry 0: (3 + 3) / 2, entry 1: 2; their mean 2.5, where 8 / 3 is per write
    assert reader("device_ops_per_write.write")(run) == 2.5
    assert reader("device_ops_per_read.read")(run) == 1.0
    assert ops_per_request(run_of(reqs[:2], trace), "write") is None  # spans and requests differ
    assert ops_per_request(run_of(reqs, None), "write") is None
    assert ops_per_request(run_of(reqs, Trace([])), "write") is None
