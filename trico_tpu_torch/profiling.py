"""Observability: spans, per-stage timers, a tally of counts and bytes,
and torch profiler hooks.

Counterpart of ``trico_tpu/profiling.py``: every codec stage can be timed
with :class:`StageTimer`, results aggregate into GB/s counters, and
:func:`trace` wraps a region in a ``torch.profiler`` trace that records the
CPU and, where there is a card, the CUDA kernels (view the files under
``log_dir`` with TensorBoard or a Chrome trace viewer).

The port marks its own steps with :func:`span` (name, bytes, device to
wait for). A span

* forwards to the active *recorder*, if there is one: any object with a
  ``stage(name, nbytes=0, sync=None)`` context manager, such as a
  :class:`StageTimer`. ``compress_mesh(profile=...)`` and
  ``decompress_mesh(profile=...)`` make their ``profile`` the active
  recorder for the call (:func:`recording`; a ``contextvars`` variable, so
  no ``prof`` argument runs through the codec's signatures);
* with no recorder, while ``torch.profiler`` is recording, is a
  ``record_function`` annotation of its name. :meth:`StageTimer.stage`
  annotates too while the profiler is on, so each span is annotated once
  whichever recorder is active, on the clock of the card's kernels and
  copies;
* always adds one call and its bytes under its name to the process-wide
  tally (:func:`tally`): counts and bytes, no clock, so it costs next to
  nothing with tracing off. :func:`count` adds to the tally alone.

With tracing off (no recorder and no profiler) no span enters
``record_function`` or waits for the device: ``sync`` is honoured only
while tracing is on, as is :func:`settle`.

Usage::

    from trico_tpu_torch.profiling import StageTimer, annotate, span, trace

    prof = StageTimer()
    with prof.stage("predict", nbytes=x.numel() * 4, sync=x.device):
        xor1, xor2 = fp_cuda.predict_xors(x, 4, 6)
    print(prof.report())

    with trace("trace_out"):              # timeline of the card
        with annotate("encode"):
            encode_chunked(vals)

    blob = compress_mesh(verts, tris, profile=prof)   # the port's spans
    print(tally()["lz4_d2h"])                          # (calls, bytes)
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import threading
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
        its kernels. While the profiler is recording, the stage is also a
        ``record_function`` annotation of its name."""
        t0 = time.perf_counter()
        try:
            with _annotation(name):
                yield
                # only sync on success: on an exception the stage's outputs
                # may not exist (a sync callable closing over unassigned
                # names would raise NameError and mask the real error)
                if sync is not None:
                    _synchronize(sync)
        finally:
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


# ---------------------------------------------------------------------------
# the port's spans: one recorder path, annotations and the tally
# ---------------------------------------------------------------------------

_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "trico_tpu_torch_recorder", default=None)
_TALLY: dict[str, list[int]] = {}
_TALLY_LOCK = threading.Lock()


def _profiler_on() -> bool:
    return torch.autograd._profiler_enabled()


def _annotation(name: str):
    """``record_function(name)`` while the profiler is recording, else
    nothing."""
    return (torch.profiler.record_function(name) if _profiler_on()
            else contextlib.nullcontext())


@contextlib.contextmanager
def recording(recorder):
    """Make ``recorder`` (an object with ``stage(name, nbytes=0,
    sync=None)``) the one every :func:`span` inside forwards to. None
    leaves the active recorder as it is."""
    if recorder is None:
        yield
        return
    token = _RECORDER.set(recorder)
    try:
        yield
    finally:
        _RECORDER.reset(token)


def tracing() -> bool:
    """Whether spans are being timed or annotated: a recorder is active or
    the profiler is recording."""
    return _RECORDER.get() is not None or _profiler_on()


def count(name: str, nbytes: int = 0, calls: int = 1) -> None:
    """Add ``calls`` and ``nbytes`` under ``name`` to the tally."""
    with _TALLY_LOCK:
        entry = _TALLY.setdefault(name, [0, 0])
        entry[0] += calls
        entry[1] += nbytes


def tally() -> dict[str, tuple[int, int]]:
    """The process's tally since the last :func:`reset_tally`: (calls,
    bytes) per name."""
    with _TALLY_LOCK:
        return {name: (c, b) for name, (c, b) in _TALLY.items()}


def reset_tally() -> None:
    with _TALLY_LOCK:
        _TALLY.clear()


def settle(sync) -> None:
    """Wait for ``sync``'s device while tracing is on, so the next span
    holds no wait for work launched before it."""
    if tracing():
        _synchronize(sync)


@contextlib.contextmanager
def span(name: str, nbytes: int = 0, sync=None):
    """One step of the port: tallied always; timed by the active recorder
    (``sync`` passed on), or else annotated while the profiler is on (and
    ``sync`` waited for on success); nothing more with tracing off."""
    count(name, nbytes)
    recorder = _RECORDER.get()
    if recorder is not None:
        with recorder.stage(name, nbytes, sync):
            yield
    elif _profiler_on():
        with torch.profiler.record_function(name):
            yield
            if sync is not None:
                _synchronize(sync)
    else:
        yield
