"""The card's activity read from a ``torch.profiler`` Chrome trace, and the
arithmetic of intervals the device metrics need.

Device activity is every kernel, copy and memset on the card. The
benchmark's spans are ``record_function`` annotations, so they carry the
same clock as the card's events. Each device operation is also matched,
by the trace's correlation id, to the host call that enqueued it. Times
are seconds.
"""

from __future__ import annotations

import json

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # a kernel's name in a breakdown: its templates run to thousands


def union(starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """Merge intervals into sorted disjoint ones."""
    s = np.asarray(starts, np.float64)
    e = np.asarray(ends, np.float64)
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > reach[:-1]])
    first = np.nonzero(new)[0]
    last = np.concatenate([first[1:], [len(s)]]) - 1
    return s[first], reach[last]


class Trace:
    """Busy intervals of the card and the annotated spans of one trace."""

    def __init__(self, events: list[dict]):
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.op_names = [e.get("name", "") for e in dev]
        self.op_s = np.array([e["ts"] for e in dev], np.float64) * 1e-6
        self.op_e = self.op_s + np.array([e.get("dur", 0) for e in dev], np.float64) * 1e-6
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        self.op_launch = np.array(
            [launch.get(e.get("args", {}).get("correlation"), e["ts"]) for e in dev],
            np.float64) * 1e-6
        self.busy_s, self.busy_e = union(self.op_s, self.op_e)
        self._cum = np.concatenate([[0.0], np.cumsum(self.busy_e - self.busy_s)])
        self.spans: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        for name in {e["name"] for e in ann}:
            mine = [e for e in ann if e["name"] == name]
            s = np.array([e["ts"] for e in mine], np.float64) * 1e-6
            self.spans[name] = (s, s + np.array([e.get("dur", 0) for e in mine]) * 1e-6)

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def _busy_to(self, t: np.ndarray) -> np.ndarray:
        """Busy seconds of the card before each time in ``t``."""
        i = np.searchsorted(self.busy_s, t, side="right") - 1
        j = np.maximum(i, 0)
        part = np.clip(np.minimum(t, self.busy_e[j]) - self.busy_s[j], 0, None)
        return np.where(i >= 0, self._cum[j] + part, 0.0)

    def busy_in(self, names) -> float:
        """Seconds in which the card was busy inside the union of the spans
        named ``names``."""
        s, e = self.span_union(names)
        if not len(s) or not len(self.busy_s):
            return 0.0
        return float(np.sum(self._busy_to(e) - self._busy_to(s)))

    def span_union(self, names):
        parts = [self.spans[n] for n in names if n in self.spans]
        if not parts:
            return np.zeros(0), np.zeros(0)
        return union(np.concatenate([p[0] for p in parts]),
                     np.concatenate([p[1] for p in parts]))

    def span_seconds(self, names) -> float:
        s, e = self.span_union(names)
        return float(np.sum(e - s))

    def ops_in_each(self, name: str) -> np.ndarray:
        """The device operations of each span ``name``, in the spans' order
        of start: those whose host call (matched by correlation id) lies
        inside the span, or, where the trace holds no such call, that
        start inside it. The spans of one name do not overlap."""
        if name not in self.spans:
            return np.zeros(0, np.int64)
        s, e = self.spans[name]
        order = np.argsort(s, kind="stable")
        t = np.sort(self.op_launch)
        return (np.searchsorted(t, e[order], side="right")
                - np.searchsorted(t, s[order], side="left"))

    def top_ops(self, k: int = 10) -> list[list]:
        """The device operations that took the most time: [name, seconds]."""
        tot: dict[str, float] = {}
        for name, d in zip(self.op_names, (self.op_e - self.op_s).tolist()):
            tot[name] = tot.get(name, 0.0) + d
        return [[n[:NAME_CHARS], s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_by_span(self, within, k: int = 10) -> list[list]:
        """Idle seconds of the card inside the spans ``within``, each gap
        charged to the shortest annotated span around its middle (what the
        host was doing): [span name, seconds], the largest first."""
        ws, we = self.span_union(within)
        gs = np.concatenate([[-np.inf], self.busy_e])
        ge = np.concatenate([self.busy_s, [np.inf]])
        pieces_s, pieces_e = [], []
        for a, b in zip(ws, we):
            lo = np.searchsorted(ge, a, side="right")
            hi = np.searchsorted(gs, b, side="left")
            s = np.maximum(gs[lo:hi], a)
            e = np.minimum(ge[lo:hi], b)
            keep = e > s
            pieces_s.append(s[keep])
            pieces_e.append(e[keep])
        if not pieces_s:
            return []
        s, e = np.concatenate(pieces_s), np.concatenate(pieces_e)
        mid = (s + e) / 2
        order = np.argsort(mid)
        s, e, mid = s[order], e[order], mid[order]
        best = np.full(len(mid), np.inf)
        label = np.full(len(mid), -1)
        names = sorted(self.spans)
        for n, name in enumerate(names):
            for a, b in zip(*self.spans[name]):
                i0, i1 = np.searchsorted(mid, [a, b])
                shorter = (b - a) < best[i0:i1]
                best[i0:i1] = np.where(shorter, b - a, best[i0:i1])
                label[i0:i1] = np.where(shorter, n, label[i0:i1])
        tot: dict[str, float] = {}
        for lab, d in zip(label.tolist(), (e - s).tolist()):
            name = names[lab] if lab >= 0 else "(no span)"
            tot[name] = tot.get(name, 0.0) + d
        return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def ops_per_request(run, kind: str) -> float | None:
    """Device operations per request of ``kind`` (``write`` or ``read``):
    each request's count (:meth:`Trace.ops_in_each` over its span),
    averaged over the requests of each pool entry and then over the
    entries. As the writes of one entry launch the same operations, that
    is the count of a whole cycle of the pool over its length, wherever the
    window cuts the cycle. None without device activity in the trace, or
    where its spans do not pair one to one with the requests."""
    if run.trace is None or not run.trace.busy_s.size:
        return None
    requests = [r for r in run.requests if r.kind == kind]
    counts = run.trace.ops_in_each(kind)
    if not requests or len(counts) != len(requests):
        return None
    by_entry: dict[int, list[int]] = {}
    for r, c in zip(requests, counts.tolist()):
        by_entry.setdefault(r.pool, []).append(c)
    return float(np.mean([np.mean(c) for c in by_entry.values()]))
