"""The device trace of a ``--trace 1`` run, from ``torch.profiler``.

Only the card's activity is recorded (``ProfilerActivity.CUDA``: kernels,
copies, fills); no host operator is, which would cost the host microseconds
an operator and inflate the idle share. The host's side is the harness's
own spans (requests and waits), on ``time.perf_counter``; the profiler's
nanoseconds are the wall clock's, which one offset taken at the start maps
onto it. ``trace_seconds`` in the mix, when set, stops the profiler after
the first request that ends past it, so that a cell of many small kernels
stays within a run's time.
"""
from __future__ import annotations

import bisect
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

TOP = 10


def device_kind(event) -> Optional[str]:
    """``kernel``, ``memcpy`` or ``memset`` for an operation on the card,
    else ``None`` (host calls, annotations). Kineto names the card's
    copies ``Memcpy ...`` and its fills ``Memset ...``."""
    from torch.autograd import DeviceType
    if event.device_type() != DeviceType.CUDA:
        return None
    if getattr(event, "is_user_annotation", lambda: False)():
        return None
    name = event.name()
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """Sorted, merged copy of ``intervals``."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged: Sequence[Sequence[float]], lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


@dataclass
class DeviceTrace:
    """Device operations (name, kind, start, end) in perf_counter seconds,
    over the traced window [t0, t1]."""
    t0: float
    t1: float
    ops: List[Tuple[str, str, float, float]]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def intervals(self, kinds: Optional[Sequence[str]] = None):
        return [(a, b) for _, k, a, b in self.ops
                if kinds is None or k in kinds]

    def busy_s(self, kinds: Optional[Sequence[str]] = None) -> float:
        """Seconds of the window in which an operation of ``kinds`` (any
        by default) ran on the device."""
        return covered(union(self.intervals(kinds)), self.t0, self.t1)

    def within(self, requests, name: str, kinds: Sequence[str] = ("kernel",),
               match: str = ""):
        """For each request ``name`` wholly inside the window, the device
        operations of ``kinds`` (with ``match`` in their names) that start
        while it runs: ``[(request, [op, ...]), ...]``."""
        ops = sorted((op[2], op) for op in self.ops
                     if op[1] in kinds and match in op[0])
        starts = [a for a, _ in ops]
        out = []
        for r in requests:
            if r.name != name or r.sent < self.t0 or r.done > self.t1:
                continue
            lo = bisect.bisect_left(starts, r.sent)
            hi = bisect.bisect_left(starts, r.done)
            out.append((r, [op for _, op in ops[lo:hi]]))
        return out

    def breakdown(self, spans: Sequence[Tuple[str, float, float]]) -> Dict:
        """The device operations that took most time, and the idle time
        by what the host was doing (the harness span covering the middle of
        each gap, else ``harness``: the spans do not overlap), each summed
        by name."""
        by_op: Dict[str, float] = {}
        for name, _, a, b in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (b - a)
        busy = union(self.intervals())
        gaps, edge = [], self.t0
        for a, b in busy + [[self.t1, self.t1]]:
            if a > edge:
                gaps.append((edge, min(a, self.t1)))
            edge = max(edge, b)
        inside = sorted(spans, key=lambda s: s[1])
        starts = [s[1] for s in inside]
        by_host: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            host = inside[i][0] if i >= 0 and inside[i][2] >= mid else \
                "harness"
            by_host[host] = by_host.get(host, 0.0) + (b - a)

        def top(d: Dict[str, float]):
            return [[k[:120], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}

    def save(self, path: Path, spans) -> None:
        """The trace and the host spans as one compact JSON file."""
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"t0": self.t0, "t1": self.t1, "ops": self.ops,
                       "spans": [s for s in spans
                                 if self.t0 <= s[1] <= self.t1]}, f)


class Tracer:
    """Profiles the card from the window's start until ``seconds`` have
    passed (the whole window when ``None``)."""

    def __init__(self, seconds: Optional[float] = None):
        self.seconds = seconds
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()

    def tick(self, now: float) -> None:
        if (self.prof is not None and self.seconds is not None
                and now >= self.t0 + self.seconds):
            self._stop()

    def _stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None

    def finish(self) -> DeviceTrace:
        if self.prof is not None:
            self._stop()
        ops = []
        off = self.offset_ns
        for e in self.events:
            kind = device_kind(e)
            if kind is None:
                continue
            a = (e.start_ns() - off) * 1e-9
            ops.append((e.name(), kind, a, a + e.duration_ns() * 1e-9))
        return DeviceTrace(self.t0, self.t1, ops)
