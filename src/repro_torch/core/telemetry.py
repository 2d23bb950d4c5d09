"""Timeline-resolved telemetry: span tracing, metrics, trace export.

The simulator's accounting discipline (`repro_torch.core.fabric`) produces
end-of-run aggregates — ``tier_bytes``, ``busy_time``, ``StagingReport``
totals — which say *how much* but never *when*. This module adds the
instrument on a timeline: a :class:`Tracer` records hierarchical spans, a
:class:`MetricsRegistry` collects counters, gauges and fixed-bucket
histograms, and two exporters turn a recording into something a human
can read — Chrome trace-event JSON (:func:`to_chrome_trace`, loadable in
Perfetto / ``chrome://tracing``) and a plain-text flight-recorder report
(:func:`flight_recorder`) with a critical-path breakdown of where each
stage's simulated seconds went.

The recorder is clock agnostic: callers pass the stamps. The simulator
stamps SIMULATED seconds (its fabric's tracer, ``fabric.attach_tracer``);
the HEDM hot path (`repro_torch.hedm.pipeline`'s ``reduce_frames`` and
``fit_grid``) stamps ``time.perf_counter()`` seconds on track ``host``
into the tracer that :func:`recording` makes current, and puts the
device seconds of its CUDA-event-timed phases on the spans as ``device_s``;
so does the serving path (`repro_torch.serve.engine.ServeSession.step`,
with :class:`DeviceMarks` a layer inside its decode).

The contract carried over from the fault and QoS layers: telemetry is
STRICTLY additive. Every instrumentation site in the fabric guards on
``tracer.enabled`` (the default :data:`NULL_TRACER` is off), so the
disabled path is the exact pre-telemetry code path — all quick-parity
anchors bit-exact — and the enabled path only RECORDS simulated times
computed by the existing arithmetic; it never feeds back into them.

Span taxonomy, metrics catalog and exporter how-tos are documented in
``docs/observability.md``; the two paths of the port's stage 1 and what
each records in ``docs/observability_torch.md``.
"""
from __future__ import annotations

import bisect
import contextvars
import json
import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np


def exact_percentile(values: Sequence[float], p: float) -> float:
    """The shared percentile everyone quotes: ``np.percentile`` with its
    default linear interpolation, returned as a plain float. QoS summary
    latencies (`repro_torch.core.qos.QoSScheduler.summary`) and the benchmark
    anchors route through here so the recorded baselines stay bit-exact
    no matter who computes the number."""
    return float(np.percentile(np.asarray(list(values), dtype=float), p))


# -- metrics ----------------------------------------------------------------

# Simulated-seconds histogram edges: geometric 100us .. 1000s, generous
# enough for a single collective and an 8K-host QoS campaign alike.
DEFAULT_SECONDS_BUCKETS: Tuple[float, ...] = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
    1.0, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0)


@dataclass
class Counter:
    """Monotone event counter."""
    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclass
class Gauge:
    """A sampled time series of ``(simulated t, value)`` points — e.g.
    per-tier bandwidth utilization or stream-cache resident bytes. Points
    are kept in record order; exporters emit them as Chrome ``C``
    (counter-track) events."""
    name: str
    series: List[Tuple[float, float]] = field(default_factory=list)

    def record(self, t: float, value: float) -> None:
        self.series.append((float(t), float(value)))

    @property
    def last(self) -> Optional[float]:
        return self.series[-1][1] if self.series else None


class Histogram:
    """Fixed-bucket histogram with closed-form percentile estimation.

    ``buckets`` are ascending upper bounds (``le`` semantics); one
    implicit overflow bucket catches everything above the last edge.
    :meth:`percentile` linearly interpolates within the target bucket
    assuming a uniform in-bucket distribution (Prometheus
    ``histogram_quantile`` semantics), clamped to the observed
    ``[min, max]`` — so a single-bucket histogram has an exact closed
    form the tests pin down."""

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_SECONDS_BUCKETS):
        if list(buckets) != sorted(buckets) or len(buckets) == 0:
            raise ValueError(f"histogram {name!r}: bucket edges must be "
                             f"non-empty and ascending, got {buckets!r}")
        self.name = name
        self.edges: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile (``0 <= p <= 100``) from the bucket
        counts alone; ``nan`` when empty."""
        if self.count == 0:
            return math.nan
        target = (p / 100.0) * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = self.edges[i] if i < len(self.edges) else self.vmax
                frac = (target - cum) / c
                est = lo + frac * (hi - lo)
                return min(max(est, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "count": self.count, "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "buckets": {f"le_{e:g}": c
                        for e, c in zip(self.edges, self.counts)},
            "overflow": self.counts[-1],
        }
        for p in (50, 90, 99):
            q = self.percentile(p)
            out[f"p{p}"] = None if math.isnan(q) else q
        return out


class MetricsRegistry:
    """Name-addressed registry of counters, gauges and histograms.

    ``counter``/``gauge``/``histogram`` are get-or-create (one instance
    per name for the registry's lifetime); :meth:`snapshot` returns a
    JSON-able dict — the ``metrics`` block embedded in every
    ``BENCH_*.json``."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_SECONDS_BUCKETS
                  ) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, buckets)
        return h

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {n: self.counters[n].value
                         for n in sorted(self.counters)},
            "gauges": {n: {"n": len(g.series), "last": g.last,
                           "min": (min(v for _, v in g.series)
                                   if g.series else None),
                           "max": (max(v for _, v in g.series)
                                   if g.series else None)}
                       for n, g in sorted(self.gauges.items())},
            "histograms": {n: self.histograms[n].snapshot()
                           for n in sorted(self.histograms)},
        }


# -- spans ------------------------------------------------------------------

@dataclass
class Span:
    """One closed interval of the recording's clock on a named track.

    ``parent`` is the enclosing span's ``span_id`` (None for roots);
    ``track`` is the coarse UI row family (``engine``, ``fs``, ``net``,
    ``net/<tier>``, ``svc``, ``qos``, ``stream``). ``t_end == t_start``
    marks an instant (a lifecycle transition)."""
    name: str
    t_start: float
    t_end: float
    track: str = "main"
    parent: Optional[int] = None
    span_id: int = -1
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


class Tracer:
    """Records :class:`Span`\\ s and owns a :class:`MetricsRegistry`.

    Two recording styles:

      * :meth:`span` — a completed interval, parented to the innermost
        open :meth:`region` (or an explicit ``parent``).
      * :meth:`region` — a context manager opening a span whose end is
        not yet known; spans recorded inside auto-nest under it. The
        caller sets ``sp.t_end`` before the block exits (it defaults to
        the start time otherwise — telemetry never invents durations).

    Every fabric instrumentation site guards on :attr:`enabled`, so a
    :class:`NullTracer` (``enabled = False``) costs one attribute check
    and nothing else."""

    enabled = True

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.spans: List[Span] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._stack: List[Span] = []

    # -- recording ----------------------------------------------------------
    def _resolve_parent(self, parent: Union[None, int, Span]
                        ) -> Tuple[Optional[int], Optional[str]]:
        if isinstance(parent, Span):
            return parent.span_id, parent.track
        if parent is not None:
            return parent, None
        if self._stack:
            top = self._stack[-1]
            return top.span_id, top.track
        return None, None

    def span(self, name: str, t_start: float, t_end: float,
             track: Optional[str] = None,
             parent: Union[None, int, Span] = None, **attrs: Any) -> Span:
        """Record a completed span; returns it."""
        pid, ptrack = self._resolve_parent(parent)
        sp = Span(name=name, t_start=float(t_start), t_end=float(t_end),
                  track=track or ptrack or "main", parent=pid,
                  span_id=len(self.spans), attrs=attrs)
        self.spans.append(sp)
        return sp

    def instant(self, name: str, t: float, track: Optional[str] = None,
                **attrs: Any) -> Span:
        """Record a zero-duration lifecycle event at simulated `t`."""
        return self.span(name, t, t, track=track, **attrs)

    @contextmanager
    def region(self, name: str, t_start: float,
               track: Optional[str] = None, **attrs: Any) -> Iterator[Span]:
        """Open a span covering the ``with`` block; see class docstring."""
        sp = self.span(name, t_start, math.nan, track=track, **attrs)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            if math.isnan(sp.t_end):
                sp.t_end = sp.t_start

    # -- inspection ---------------------------------------------------------
    def roots(self, track: Optional[str] = None) -> List[Span]:
        """Top-level spans (no parent), optionally filtered by track."""
        return [s for s in self.spans if s.parent is None
                and (track is None or s.track == track)]

    def children(self, span: Span) -> List[Span]:
        """Direct children of `span`, in record order."""
        return [s for s in self.spans if s.parent == span.span_id]


class _NullMetric:
    """Shared sink behind :class:`NullTracer`: every recording method is
    a no-op, so even un-guarded metric calls on the off path cannot
    accumulate state."""

    def inc(self, n: float = 1.0) -> None:
        pass

    def record(self, t: float, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


_NULL_METRIC = _NullMetric()


class _NullRegistry:
    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, buckets: Sequence[float] = ()
                  ) -> _NullMetric:
        return _NULL_METRIC

    def snapshot(self) -> Dict[str, Any]:
        return {"counters": {}, "gauges": {}, "histograms": {}}


class NullTracer:
    """The default, disabled tracer: records nothing, costs an attribute
    check. Instrumentation sites MUST guard span/metric recording on
    ``tracer.enabled`` — only :meth:`region` (used as a structural
    ``with``) is expected to run on the off path, and it yields a shared
    dummy span."""

    enabled = False

    def __init__(self) -> None:
        self.spans: Tuple[Span, ...] = ()
        self.metrics = _NullRegistry()
        self._dummy = Span("null", 0.0, 0.0)

    def span(self, name: str, t_start: float, t_end: float,
             track: Optional[str] = None,
             parent: Union[None, int, Span] = None, **attrs: Any) -> Span:
        return self._dummy

    def instant(self, name: str, t: float, track: Optional[str] = None,
                **attrs: Any) -> Span:
        return self._dummy

    @contextmanager
    def region(self, name: str, t_start: float,
               track: Optional[str] = None, **attrs: Any) -> Iterator[Span]:
        yield self._dummy

    def roots(self, track: Optional[str] = None) -> List[Span]:
        return []

    def children(self, span: Span) -> List[Span]:
        return []


NULL_TRACER = NullTracer()

TracerLike = Union[Tracer, NullTracer]

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_current_tracer", default=NULL_TRACER)


def current() -> TracerLike:
    """The tracer that :func:`recording` made current in this context
    (thread or task), else :data:`NULL_TRACER`. Hot-path code looks it up
    once a call and guards every site on its ``enabled``."""
    return _CURRENT.get()


@contextmanager
def recording(tracer: TracerLike) -> Iterator[TracerLike]:
    """Make ``tracer`` current for the ``with`` block (and restore the
    previous one after it): the instrumented hot path records into it."""
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)


def device_event(device: Any) -> Any:
    """A CUDA event recorded now on ``device``'s current stream, or None
    off a card."""
    if getattr(device, "type", None) != "cuda":
        return None
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class DeviceMarks:
    """Back-to-back spans on ``time.perf_counter()``, each closed by
    :meth:`mark` and named ``prefix + name``, under the tracer's innermost
    open region. On a card each carries ``device_s``, the seconds between
    CUDA events recorded at its two ends, left pending until
    :func:`settle_device_s` reads it once the device has passed them."""

    def __init__(self, tracer: Tracer, prefix: str, device: Any):
        import time
        self.tracer, self.prefix, self.device = tracer, prefix, device
        self._clock = time.perf_counter
        self._last = (self._clock(), device_event(device))

    def mark(self, name: str, **attrs: Any) -> Span:
        now = (self._clock(), device_event(self.device))
        (a, ev_a), self._last = self._last, now
        pending = (ev_a, now[1]) if ev_a is not None else None
        return self.tracer.span(self.prefix + name, a, now[0],
                                device_s=pending, **attrs)


def settle_device_s(tracer: TracerLike, since: int = 0) -> None:
    """Turn the pending ``device_s`` (a pair of CUDA events) of the spans
    recorded from index ``since`` on into seconds. Call it after a copy to
    the host has waited for the device; it does not synchronise."""
    for sp in tracer.spans[since:]:
        ev = sp.attrs.get("device_s")
        if isinstance(ev, tuple):
            sp.attrs["device_s"] = ev[0].elapsed_time(ev[1]) * 1e-3


# -- Chrome trace-event export ---------------------------------------------

def _assign_lanes(spans: List[Span]) -> Dict[int, int]:
    """Greedy interval partitioning of ROOT spans into display lanes
    (Chrome ``tid``\\ s): a root goes to the first lane whose previous
    occupant ended by its start, so overlapping roots (concurrent QoS
    requests) get separate rows while a serial stream (the FS busy
    timeline) stays on one. Children inherit the root's lane."""
    lanes: List[float] = []
    out: Dict[int, int] = {}
    for sp in sorted(spans, key=lambda s: (s.t_start, s.span_id)):
        for i, end in enumerate(lanes):
            if end <= sp.t_start:
                lanes[i] = sp.t_end
                out[sp.span_id] = i + 1
                break
        else:
            lanes.append(sp.t_end)
            out[sp.span_id] = len(lanes)
    return out


def to_chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    """Export a recording as Chrome trace-event JSON (the dict; dump it
    with :func:`write_chrome_trace`). Loadable in Perfetto
    (https://ui.perfetto.dev) and ``chrome://tracing``:

      * one PROCESS per track (``engine``, ``fs``, ``net``,
        ``net/<tier>``, ``svc``, ``qos``, ``stream``; ``host`` for the
        HEDM hot path) with a ``process_name`` metadata event;
      * root spans laid out on greedy non-overlapping THREAD lanes,
        children on their root's lane — Perfetto then renders the
        parent/child nesting by interval containment;
      * spans as ``ph:"X"`` complete events (``ts``/``dur`` in
        microseconds of the clock whoever stamped the spans used:
        simulated seconds for the simulator's, ``time.perf_counter()``
        for the HEDM hot path's), instants as ``ph:"i"``, gauge series as
        ``ph:"C"`` counter tracks under a ``metrics`` process.
    """
    tracks: List[str] = sorted({s.track for s in tracer.spans})
    pid_of = {track: i + 1 for i, track in enumerate(tracks)}
    events: List[Dict[str, Any]] = []
    for track in tracks:
        events.append({"ph": "M", "name": "process_name",
                       "pid": pid_of[track], "tid": 0,
                       "args": {"name": track}})

    # lane assignment per track, roots only; children inherit
    tid_of: Dict[int, int] = {}
    by_id = {s.span_id: s for s in tracer.spans}
    for track in tracks:
        roots = [s for s in tracer.spans
                 if s.track == track and
                 (s.parent is None or by_id[s.parent].track != track)]
        tid_of.update(_assign_lanes(roots))
    for sp in tracer.spans:            # record order = parents first
        if sp.span_id not in tid_of:
            tid_of[sp.span_id] = tid_of.get(sp.parent, 1)

    for sp in tracer.spans:
        args = {k: v for k, v in sp.attrs.items() if v is not None}
        args["span_id"] = sp.span_id
        if sp.parent is not None:
            args["parent"] = sp.parent
        base = {"name": sp.name, "cat": sp.track, "pid": pid_of[sp.track],
                "tid": tid_of[sp.span_id], "ts": sp.t_start * 1e6,
                "args": args}
        if sp.t_end == sp.t_start:
            events.append({**base, "ph": "i", "s": "t"})
        else:
            events.append({**base, "ph": "X", "dur": sp.duration * 1e6})

    gauges = getattr(tracer.metrics, "gauges", {})
    if gauges:
        mpid = len(tracks) + 1
        events.append({"ph": "M", "name": "process_name", "pid": mpid,
                       "tid": 0, "args": {"name": "metrics"}})
        for name in sorted(gauges):
            for t, v in gauges[name].series:
                events.append({"ph": "C", "name": name, "pid": mpid,
                               "tid": 0, "ts": t * 1e6, "args": {name: v}})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"spans": len(tracer.spans)}}


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    """Dump :func:`to_chrome_trace` JSON to `path`; returns `path`."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f)
    return path


_VALID_PHASES = {"X", "i", "M", "C"}


def validate_chrome_trace(trace: Dict[str, Any]) -> int:
    """Assert `trace` is structurally valid trace-event JSON (the subset
    this module emits); returns the event count. Used by the exporter
    tests and the CI telemetry smoke."""
    assert isinstance(trace, dict) and "traceEvents" in trace, (
        "trace must be a JSON object with a traceEvents list")
    events = trace["traceEvents"]
    assert isinstance(events, list) and events, "traceEvents empty"
    for ev in events:
        assert ev.get("ph") in _VALID_PHASES, f"bad phase in {ev!r}"
        assert isinstance(ev.get("pid"), int), f"bad pid in {ev!r}"
        assert isinstance(ev.get("tid"), int), f"bad tid in {ev!r}"
        if ev["ph"] in ("X", "i", "C"):
            assert isinstance(ev.get("ts"), (int, float)), f"no ts: {ev!r}"
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), (int, float)), f"no dur: {ev!r}"
            assert ev["dur"] >= 0, f"negative dur: {ev!r}"
        if ev["ph"] in ("X", "i"):
            assert isinstance(ev.get("name"), str), f"no name: {ev!r}"
    return len(events)


# -- flight recorder --------------------------------------------------------

def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


def flight_recorder(tracer: Tracer) -> str:
    """Plain-text post-mortem of a recording: per-stage critical-path
    breakdown (phase children of each ``stage.*`` span — they partition
    the stage's total by construction), per-tier wire-time/byte
    attribution from the collective tier spans, FS busy-vs-wait totals,
    and a metrics digest. Everything quoted is SIMULATED seconds."""
    lines: List[str] = []
    spans = tracer.spans
    lines.append("== flight recorder (simulated time) ==")
    lines.append(f"spans: {len(spans)}  "
                 f"tracks: {', '.join(sorted({s.track for s in spans}))}")

    kids: Dict[Optional[int], List[Span]] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)

    stage_roots = [s for s in spans if s.parent is None
                   and s.name.startswith(("stage.", "stream.frame"))]
    for root in stage_roots:
        total = root.duration
        hdr = ", ".join(f"{k}={v}" for k, v in sorted(root.attrs.items())
                        if not isinstance(v, dict))
        lines.append("")
        lines.append(f"{root.name} [{root.t_start:.6f} -> "
                     f"{root.t_end:.6f}]  total {total:.6f}s"
                     + (f"  ({hdr})" if hdr else ""))
        want = ("stream." if root.name == "stream.frame" else "phase.")
        phases = [c for c in kids.get(root.span_id, ())
                  if c.name.startswith(want)]
        attributed = 0.0
        best: Tuple[float, str] = (0.0, "-")
        for c in phases:
            share = c.duration / total if total > 0 else 0.0
            attributed += c.duration
            best = max(best, (c.duration, c.name))
            lines.append(f"  {c.name:<22s} {c.duration:12.6f}s "
                         f"{100 * share:6.1f}%")
        rest = total - attributed
        if abs(rest) > 1e-12 * max(1.0, abs(total)):
            lines.append(f"  {'(unattributed)':<22s} {rest:12.6f}s")
        if phases:
            lines.append(f"  critical path: {best[1]} "
                         f"({100 * best[0] / total if total else 0:.1f}%)")

    tier_time: Dict[str, float] = {}
    tier_nbytes: Dict[str, float] = {}
    for s in spans:
        if s.name.startswith("tier."):
            tier = s.name[len("tier."):]
            tier_time[tier] = tier_time.get(tier, 0.0) + s.duration
            tier_nbytes[tier] = tier_nbytes.get(tier, 0.0) \
                + s.attrs.get("nbytes", 0)
    if tier_time:
        lines.append("")
        lines.append("tier attribution (wire time per topology tier):")
        for tier in sorted(tier_time):
            dt, nb = tier_time[tier], tier_nbytes[tier]
            bw = nb / dt if dt > 0 else 0.0
            lines.append(f"  {tier:<12s} {dt:12.6f}s  "
                         f"{_fmt_bytes(nb):>10s}  {bw / 1e9:8.2f} GB/s")

    comp_c = sum(s.duration for s in spans if s.name == "comp.compress")
    comp_d = sum(s.duration for s in spans if s.name == "comp.decompress")
    counters = tracer.metrics.snapshot()["counters"]
    comp_payload = counters.get("comp.payload_bytes", 0)
    comp_wire = counters.get("comp.wire_bytes", 0)
    if comp_payload or comp_c or comp_d:
        wire_s = sum(tier_time.values())
        ratio = comp_payload / comp_wire if comp_wire else 1.0
        lines.append("")
        lines.append(
            f"compression: {_fmt_bytes(comp_payload)} payload -> "
            f"{_fmt_bytes(comp_wire)} wire ({ratio:.2f}x, "
            f"{_fmt_bytes(counters.get('comp.bytes_saved', 0))} saved), "
            f"codec {comp_c + comp_d:.6f}s "
            f"(compress {comp_c:.6f}s / decompress {comp_d:.6f}s) "
            f"vs wire {wire_s:.6f}s")

    wan_pulls = [s for s in spans if s.name == "wan.pull"]
    if wan_pulls:
        pull_s = sum(s.duration for s in wan_pulls)
        retry_s = sum(s.duration for s in spans
                      if s.name == "wan.retransmit")
        retries = sum(s.attrs.get("retries", 0) for s in spans
                      if s.name == "wan.retransmit")
        credit_s = sum(s.duration for s in spans if s.name == "wan.credit")
        drops = sum(1 for s in spans if s.name == "wan.drop")
        lines.append("")
        lines.append(f"WAN ingest: {len(wan_pulls)} pulls {pull_s:.6f}s, "
                     f"retransmit {retry_s:.6f}s ({retries:g} retries), "
                     f"credit-wait {credit_s:.6f}s, {drops} drops")

    fs_busy = sum(s.duration for s in spans
                  if s.track == "fs" and s.name != "fs.wait")
    fs_wait = sum(s.duration for s in spans if s.name == "fs.wait")
    if fs_busy or fs_wait:
        lines.append("")
        lines.append(f"shared FS: busy {fs_busy:.6f}s, "
                     f"contention wait {fs_wait:.6f}s")

    snap = tracer.metrics.snapshot()
    if snap["counters"] or snap["histograms"]:
        lines.append("")
        lines.append("metrics:")
        for name, val in snap["counters"].items():
            lines.append(f"  {name:<32s} {val:g}")
        for name, h in snap["histograms"].items():
            if h["count"]:
                lines.append(f"  {name:<32s} n={h['count']} "
                             f"p50={h['p50']:.6f}s p99={h['p99']:.6f}s")
    return "\n".join(lines) + "\n"
