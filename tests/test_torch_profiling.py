"""trico_tpu_torch.profiling held against trico_tpu.profiling: the same
stages, counters and report shapes from the same sequence of stages, a
trace that lands in a file, and annotations that nest. Times differ from
run to run, so what is compared is structure; bytes and calls are exact."""

import json
import re

import pytest
import torch

from trico_tpu import profiling as jprof
from trico_tpu_torch import profiling as tprof


def _run(mod):
    prof = mod.StageTimer()
    with prof.stage("transpose", nbytes=1000):
        pass
    for _ in range(3):
        with prof.stage("fp_encode", nbytes=4096):
            sum(range(1000))
    with prof.stage("framing"):
        pass
    return prof


def test_stage_timer_accumulates_like_trico_tpu():
    ours, theirs = _run(tprof), _run(jprof)
    assert list(ours.stages) == list(theirs.stages) == ["transpose", "fp_encode",
                                                        "framing"]
    for name in ours.stages:
        a, b = ours.stages[name], theirs.stages[name]
        assert (a.calls, a.nbytes) == (b.calls, b.nbytes)
        assert a.seconds > 0
    assert ours.stages["fp_encode"].calls == 3
    assert ours.stages["fp_encode"].nbytes == 3 * 4096


def test_gbps():
    prof = tprof.StageTimer()
    assert prof.gbps("missing") == 0.0
    with prof.stage("s", nbytes=10**9):
        pass
    s = prof.stages["s"]
    assert prof.gbps("s") == pytest.approx(1.0 / s.seconds)
    s.seconds = 0.0
    assert prof.gbps("s") == 0.0
    assert jprof.StageTimer(stages={"s": s}).gbps("s") == 0.0


def test_report_and_json_have_trico_tpus_shape():
    ours, theirs = _run(tprof), _run(jprof)
    mask = lambda text: re.sub(r"[0-9.]+ (ms|GB/s)", r"# \1", text)  # noqa: E731
    rows, want = ours.report().splitlines(), theirs.report().splitlines()
    assert len(rows) == 3
    assert [mask(r).split() for r in rows] == [mask(r).split() for r in want]
    assert rows[2].split()[-1] == "-"  # a stage without bytes has no rate
    a, b = json.loads(ours.as_json()), json.loads(theirs.as_json())
    assert list(a) == list(b)
    for name in a:
        assert list(a[name]) == list(b[name]) == ["calls", "seconds", "bytes", "gbps"]
        assert (a[name]["calls"], a[name]["bytes"]) == (b[name]["calls"], b[name]["bytes"])
    assert a["framing"]["gbps"] == 0.0


def test_a_failing_stage_is_counted_and_not_synchronised():
    prof = tprof.StageTimer()
    with pytest.raises(KeyError):
        with prof.stage("boom", nbytes=7, sync=lambda: undefined_name):  # noqa: F821
            raise KeyError("inside")
    assert prof.stages["boom"].calls == 1 and prof.stages["boom"].nbytes == 7


@pytest.mark.parametrize("sync", ["cpu", torch.device("cpu"), torch.zeros(2),
                                  lambda: torch.zeros(2), lambda: "cpu"])
def test_sync_on_the_cpu_waits_for_nothing(sync, monkeypatch):
    called = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: called.append(a))
    prof = tprof.StageTimer()
    with prof.stage("s", sync=sync):
        pass
    assert called == [] and prof.stages["s"].calls == 1


def test_sync_on_a_cuda_device_synchronises_it(monkeypatch):
    called = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: called.append(a))
    prof = tprof.StageTimer()
    with prof.stage("s", sync="cuda:0"):
        pass
    with prof.stage("s", sync=lambda: torch.device("cuda", 1)):
        pass
    assert called == [(torch.device("cuda:0"),), (torch.device("cuda:1"),)]


def test_trace_writes_a_file_and_annotations_nest(tmp_path):
    with tprof.trace(tmp_path / "t") as prof:
        with tprof.annotate("outer"):
            with tprof.annotate("inner"):
                torch.arange(100).sum()
    files = list((tmp_path / "t").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("name") in ("outer", "inner") and "dur" in e}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert {"outer", "inner"} <= {e.key for e in prof.key_averages()}
