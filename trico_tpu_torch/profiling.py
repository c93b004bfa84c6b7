"""Observability: per-stage timers, throughput counters, torch profiler hooks.

Counterpart of ``trico_tpu/profiling.py``: every codec stage can be timed
with :class:`StageTimer`, results aggregate into GB/s counters, and
:func:`trace` wraps a region in a ``torch.profiler`` trace that records the
CPU and, where there is a card, the CUDA kernels (view the files under
``log_dir`` with TensorBoard or a Chrome trace viewer).

Usage::

    from trico_tpu_torch.profiling import StageTimer, annotate, trace

    prof = StageTimer()
    with prof.stage("predict", nbytes=x.numel() * 4, sync=x.device):
        xor1, xor2 = fp_cuda.predict_xors(x, 4, 6)
    print(prof.report())

    with trace("trace_out"):              # timeline of the card
        with annotate("encode"):
            encode_chunked(vals)
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import torch


@dataclass
class _Stage:
    calls: int = 0
    seconds: float = 0.0
    nbytes: int = 0


def _synchronize(sync) -> None:
    """Wait for the CUDA device that ``sync`` names: a device, its string,
    a tensor on it, or a callable that returns one of these. The CPU has
    nothing to wait for."""
    if callable(sync):
        sync = sync()
    device = sync.device if torch.is_tensor(sync) else torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StageTimer:
    """Accumulates wall-clock + byte counts per named pipeline stage."""

    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0, sync=None):
        """Time a stage. Pass ``sync`` (the stage's device, or a tensor it
        made, or a callable returning either) to include the device's
        completion; otherwise a CUDA stage counts only the time to launch
        its kernels."""
        t0 = time.perf_counter()
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            # only sync on success: on an exception the stage's outputs may
            # not exist (a sync callable closing over unassigned names would
            # raise NameError from this finally and mask the real error)
            if ok and sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            s = self.stages.setdefault(name, _Stage())
            s.calls += 1
            s.seconds += dt
            s.nbytes += nbytes

    def gbps(self, name: str) -> float:
        s = self.stages.get(name)
        if not s or s.seconds == 0:
            return 0.0
        return s.nbytes / 1e9 / s.seconds

    def report(self) -> str:
        rows = []
        for name, s in self.stages.items():
            tp = f"{s.nbytes / 1e9 / s.seconds:7.2f} GB/s" if s.seconds and s.nbytes else "      -    "
            rows.append(f"{name:<24} {s.calls:>5}x {s.seconds*1e3:9.2f} ms {tp}")
        return "\n".join(rows)

    def as_json(self) -> str:
        return json.dumps(
            {
                name: {"calls": s.calls, "seconds": s.seconds, "bytes": s.nbytes,
                       "gbps": (s.nbytes / 1e9 / s.seconds) if s.seconds else 0.0}
                for name, s in self.stages.items()
            }
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region (the CPU,
    and the CUDA kernels where there is a card) into a file under
    ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


def annotate(name: str):
    """Named trace annotation for a code region (shows up on the timeline)."""
    return torch.profiler.record_function(name)
