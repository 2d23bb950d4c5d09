"""Cross-facility WAN ingest: detector -> wide-area tier -> compute pods.

The paper stages detector data through a shared parallel FS inside one
machine; the follow-on deployments (Welborn et al., streaming detector
data from a beamline into Perlmutter compute nodes across ESnet) move
the detector OUTSIDE the cluster entirely.  This module models that
cross-facility hop as a first-class subsystem on top of the existing
stack — nothing below it changes arithmetic:

  * **Topology** — the ``wan_beamline`` canned machine
    (`repro_torch.core.topology.WAN_BEAMLINE`): the whole pod is one "rack" on
    fast cluster links, so delivery collectives stay local, while the
    ingest hop crosses a ``wan`` tier with ~10 Gb/s of bandwidth and
    25 ms latency. WAN weather is a seeded
    `repro_torch.core.faults.FaultSchedule.wan_jitter` timeline of transient
    degradation windows scaling that tier.
  * **Pull-based flow control** — :class:`WanSession`: the detector owns
    a bounded DAQ frame buffer and may only push a frame across the WAN
    while it holds a *send credit*.  Consumers grant one credit back each
    time a frame is fully released from the node window, so the credit
    window caps unconsumed in-flight frames and the node cache can never
    wedge (the credit window is validated against the window budget).
    When the producer buffer overflows waiting for credits, the OLDEST
    frame is overwritten (DAQ ring-buffer semantics) and accounted in
    ``frames_dropped`` — never silently.  Everything is scheduled on the
    shared `repro_torch.core.events.EventLoop` timeline: emissions, sends,
    per-subscriber consumption, acks, credit grants.
  * **Publish/subscribe fan-out** — :class:`WanFanout`: N subscriber
    campaigns tap ONE WAN stream.  Each frame crosses the WAN once and
    fans out locally through the existing
    `repro_torch.core.streaming.StreamStager` scatter + ring-broadcast plans;
    per-subscriber cursors are the stager's multi-consumer acks, and a
    frame is retained until the SLOWEST subscriber passes it (the
    watermark — surfaced as ``StreamReport.watermark_frame`` /
    ``watermark_lag`` / ``consumer_lag``).
  * **Loss model** — seeded stop-and-wait retransmission on the WAN hop:
    each attempt re-serializes the frame
    (`repro_torch.core.collectives.CollectivePlanner.plan_point_to_point` with
    ``attempts=k``), so retransmits cost both time and ingest-tier
    bytes.  Zero loss draws nothing from the RNG and takes the exact
    lossless plan.
  * **Engine** — :func:`stage_wan`, registered as ``"wan"`` in
    `repro_torch.core.api.ENGINES` (typed config: ``WanStreamConfig``) so
    ``StagingClient.stage`` drives it like any other engine, with
    telemetry spans (``wan.pull``, ``wan.credit``, ``wan.retransmit``)
    riding the PR 8 tracer.

**Regression anchor**: with zero jitter, zero loss and a credit window
that never binds (the defaults), the WAN path issues exactly the same
``StreamStager.ingest`` calls in the same order as
`repro_torch.core.streaming.stage_stream` — byte- and time-exact, asserted in
``tests/test_wan.py`` and the ``--wan --quick`` bench smoke.

Units: simulated SECONDS and real BYTES throughout (see
`repro_torch.core.fabric`); replicas are zero-copy read-only views and stay
byte-exact.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import (Deque, Dict, List, Optional, Sequence, Tuple, Union)

import numpy as np

from repro_torch.core.collectives import CollectivePlanner
from repro_torch.core.compression import CompressionLike
from repro_torch.core.events import EventLoop
from repro_torch.core.fabric import Fabric
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.staging import StagingReport, _close_stage_span
from repro_torch.core.streaming import (DetectorSource, FrameRecord, StreamReport,
                                  StreamStager)
from repro_torch.core.topology import TopologyLike, resolve_topology


@dataclass
class WanReport:
    """Accounting for one WAN acquisition (all times simulated s).

    ``stream`` is the local fan-out's `repro_torch.core.streaming.StreamReport`
    (per-subscriber lag and the slowest-subscriber watermark live there);
    the fields here are the WAN-side story: what crossed the wide-area
    tier, what got dropped at the detector, what the credit protocol
    cost."""
    n_subscribers: int = 1
    n_frames: int = 0            # frames the detector emitted
    frames_delivered: int = 0    # frames that crossed the WAN and landed
    frames_dropped: int = 0      # frames overwritten in the DAQ buffer
    retransmits: int = 0         # extra WAN attempts under the loss model
    wan_bytes: int = 0           # ingest-tier wire bytes (incl. retries)
    wan_time: float = 0.0        # total WAN serialization time
    credit_stall_time: float = 0.0  # producer waited for credits (sum)
    credits_granted: int = 0     # credits returned by consumers
    buffer_peak: int = 0         # DAQ-buffer high-water mark (frames)
    makespan: float = 0.0        # last t_avail - t0 (delivery-limited)
    drain_makespan: float = 0.0  # last subscriber ack - t0
    stream: Optional[StreamReport] = None


class WanFanout(StreamStager):
    """Pub/sub fan-out of ONE WAN stream with a seeded loss model.

    The WAN crossing IS the stager's detector->leader point-to-point hop
    (charged to the topology's ingest tier), so this subclass only
    overrides the :meth:`StreamStager._pull_time` seam: a seeded
    geometric draw decides how many stop-and-wait attempts the frame
    needs, and the hop is planned with ``attempts=k`` — time and
    ingest-tier bytes scale together.  ``loss_rate=0`` draws NOTHING
    from the RNG and takes the parent's exact lossless plan (the
    ``stage_stream`` parity anchor).  Everything else — scatter,
    ring broadcast, window policy, multi-consumer acks — is inherited
    unchanged: the local fan-out is the existing delivery machinery.
    """

    def __init__(self, fabric: Fabric, window_bytes: int, *,
                 loss_rate: float = 0.0, loss_seed: int = 0, **kw):
        super().__init__(fabric, window_bytes, **kw)
        if not 0.0 <= loss_rate < 1.0:
            raise ValueError(
                f"loss_rate must be in [0, 1) — a rate of 1 never "
                f"delivers (that is a partition, not loss), got "
                f"{loss_rate}")
        self.loss_rate = loss_rate
        self._loss_rng = np.random.default_rng(loss_seed)
        self.retransmits = 0     # extra attempts beyond the first
        self.wan_time = 0.0      # total ingest-hop serialization
        self.wan_bytes = 0       # ingest-tier bytes incl. retries

    def _pull_time(self, nbytes: int, t: float) -> float:
        attempts = 1
        if self.loss_rate > 0.0:
            while self._loss_rng.random() < self.loss_rate:
                attempts += 1
        plan = self.fabric.net.point_to_point(nbytes, t=t,
                                              attempts=attempts)
        dt = plan.time
        self.wan_time += dt
        # wire bytes: retransmissions re-send the *compressed* frame, so
        # an elected codec shrinks every attempt (== attempts * nbytes
        # when no codec is active)
        self.wan_bytes += plan.total_bytes
        if attempts > 1:
            self.retransmits += attempts - 1
        tr = self.fabric.tracer
        if tr.enabled:
            # record only: dt was computed above, untraced
            sp = tr.span("wan.pull", t, t + dt, track="wan",
                         nbytes=nbytes, wire_bytes=plan.total_bytes,
                         attempts=attempts)
            if attempts > 1:
                # failed attempts occupy the leading (k-1)/k of the hop
                tr.span("wan.retransmit", t, t + dt * (attempts - 1)
                        / attempts, track="wan", parent=sp,
                        retries=attempts - 1)
                tr.metrics.counter("wan.retransmits").inc(attempts - 1)
            tr.metrics.counter("wan.pulls").inc()
            tr.metrics.histogram("wan.pull_s").observe(dt)
        return dt


class _Subscriber:
    """One consumer campaign's cursor: where its busy clock stands."""

    __slots__ = ("name", "consume_s", "busy", "consumed")

    def __init__(self, name: str, consume_s: float, t0: float):
        self.name = name
        self.consume_s = consume_s   # per-frame processing time (s)
        self.busy = t0               # this subscriber's serialization clock
        self.consumed = 0


class WanSession:
    """One cross-facility acquisition on the shared event timeline.

    Wires the three WAN pieces together: a :class:`DetectorSource`
    emitting frames on the far side of the WAN, a bounded producer
    buffer with credit-gated sends, and a :class:`WanFanout` delivering
    each admitted frame to every node-local store with N subscriber
    campaigns acking it.  The protocol, entirely event-driven on a
    `repro_torch.core.events.EventLoop`:

      1. *emit* — frame lands in the DAQ buffer; if the buffer exceeds
         ``buffer_frames`` the OLDEST waiting frame is overwritten
         (``frames_dropped``).
      2. *send* — while the buffer is non-empty and a credit is held:
         pop the oldest frame, spend a credit, and ingest it (the WAN
         pull + local fan-out). Time spent waiting for a credit is the
         frame's ``wan.credit`` span (``credit_stall_time``).
      3. *consume/ack* — each subscriber processes the frame
         ``consume_s`` after it is available (serialized per
         subscriber) and acks it: ``release(path, consumer=name)``.
      4. *credit grant* — once EVERY subscriber acked (the watermark
         passed the frame), one credit returns and blocked sends
         resume.

    Never-wedge guarantee: with an unpinned bounded window the number of
    unreleased resident frames can never exceed ``credit_window``, so
    ``credit_window * max_frame + pinned bytes <= window_bytes`` (checked
    at construction) means admission always fits after evicting released
    frames — the node cache cannot wedge, no matter the jitter.
    """

    def __init__(self, fabric: Fabric, source: DetectorSource, *,
                 window_bytes: Optional[int] = None,
                 credit_window: Optional[int] = None,
                 buffer_frames: Optional[int] = None,
                 subscribers: Union[int, Sequence[str]] = 1,
                 consume_hz: Union[None, float, Sequence[float]] = None,
                 loss_rate: float = 0.0, loss_seed: int = 0,
                 topology: TopologyLike = None,
                 compression: CompressionLike = None,
                 faults: Optional[FaultSchedule] = None,
                 pin_paths: Sequence[str] = (),
                 t0: float = 0.0, loop: Optional[EventLoop] = None):
        self.fabric = fabric
        self.t0 = t0
        self.loop = loop if loop is not None else EventLoop(t0=t0)
        self._faults = faults
        self._frames = [(fid, path, buf, t_emit)
                        for fid, path, buf, t_emit in source]
        sizes = [int(np.ascontiguousarray(buf).nbytes)
                 for _, _, buf, _ in self._frames]
        total = sum(sizes)
        max_frame = max(sizes, default=1)
        n_frames = len(self._frames)

        if isinstance(subscribers, int):
            if subscribers < 1:
                raise ValueError(
                    f"subscribers must be >= 1, got {subscribers}")
            names = [f"sub{i}" for i in range(subscribers)]
        else:
            names = [str(n) for n in subscribers]
            if not names:
                raise ValueError("subscribers must name at least one "
                                 "consumer campaign")
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate subscriber names: {names}")
        if consume_hz is None:
            rates: List[Optional[float]] = [None] * len(names)
        elif isinstance(consume_hz, (int, float)):
            rates = [float(consume_hz)] * len(names)
        else:
            rates = [float(r) for r in consume_hz]
            if len(rates) != len(names):
                raise ValueError(
                    f"consume_hz lists {len(rates)} rates for "
                    f"{len(names)} subscribers")
        for r in rates:
            if r is not None and r <= 0:
                raise ValueError(
                    f"consume_hz must be a positive per-subscriber "
                    f"processing rate (or None for instant acks), got {r}")
        self._subs = [_Subscriber(n, 0.0 if r is None else 1.0 / r, t0)
                      for n, r in zip(names, rates)]

        window = int(window_bytes) if window_bytes is not None \
            else max(total, 1)
        if credit_window is None:
            credit_window = max(1, min(n_frames or 1, window // max_frame))
        if credit_window < 1:
            raise ValueError(
                f"credit_window must be >= 1, got {credit_window}")
        pin_set = set(pin_paths)
        pinned_bytes = sum(sz for (_, p, _, _), sz
                           in zip(self._frames, sizes) if p in pin_set)
        if (window < total
                and credit_window * max_frame + pinned_bytes > window):
            raise ValueError(
                f"flow control cannot guarantee progress: "
                f"credit_window={credit_window} x max frame "
                f"{max_frame} B + {pinned_bytes} B pinned exceeds the "
                f"{window} B node window — shrink the credit window or "
                f"grow the window budget")
        if buffer_frames is not None and buffer_frames < 1:
            raise ValueError(
                f"buffer_frames must be >= 1 (or None for an unbounded "
                f"DAQ buffer), got {buffer_frames}")
        self._buffer_cap = buffer_frames
        self._credits = credit_window
        self.credit_window = credit_window
        self._pin_set = pin_set
        self._buffer: Deque[Tuple[int, str, np.ndarray, float]] = deque()

        self.stager = WanFanout(fabric, window, loss_rate=loss_rate,
                                loss_seed=loss_seed, t0=t0,
                                topology=topology, compression=compression)
        for sub in self._subs:
            self.stager.register_consumer(sub.name)
        self.report = WanReport(n_subscribers=len(self._subs))

    # -- event handlers -----------------------------------------------------
    def _on_emit(self, fid: int, path: str, buf: np.ndarray,
                 t_emit: float) -> None:
        t = self.loop.now
        self._buffer.append((fid, path, buf, t_emit))
        self.report.n_frames += 1
        self.report.buffer_peak = max(self.report.buffer_peak,
                                      len(self._buffer))
        if (self._buffer_cap is not None
                and len(self._buffer) > self._buffer_cap):
            # DAQ ring buffer: the oldest waiting frame is overwritten
            old_fid, old_path, _, old_emit = self._buffer.popleft()
            self.report.frames_dropped += 1
            tr = self.fabric.tracer
            if tr.enabled:
                tr.span("wan.drop", old_emit, t, track="wan",
                        frame_id=old_fid, path=old_path)
                tr.metrics.counter("wan.drops").inc()
        self._try_send(t)

    def _try_send(self, t: float) -> None:
        while self._buffer and self._credits > 0:
            fid, path, buf, t_emit = self._buffer.popleft()
            self._credits -= 1
            wait = t - t_emit
            if wait > 0:
                self.report.credit_stall_time += wait
                tr = self.fabric.tracer
                if tr.enabled:
                    tr.span("wan.credit", t_emit, t, track="wan",
                            frame_id=fid, path=path)
                    tr.metrics.histogram("wan.credit_wait_s").observe(wait)
            rec = self.stager.ingest(path, buf, t_emit, t_offer=t)
            if path in self._pin_set:
                self.stager.pin(path)
            self.report.frames_delivered += 1
            for sub in self._subs:
                done = max(rec.t_avail, sub.busy) + sub.consume_s
                sub.busy = done
                self.loop.schedule_after(
                    done - t, partial(self._on_ack, sub, path),
                    key=f"wan.sub.{sub.name}")

    def _on_ack(self, sub: _Subscriber, path: str) -> None:
        t = self.loop.now
        sub.consumed += 1
        self.stager.release(path, t, consumer=sub.name)
        if self.stager.fully_released(path):
            # the watermark passed this frame: one credit returns
            self._credits += 1
            self.report.credits_granted += 1
            tr = self.fabric.tracer
            if tr.enabled:
                tr.metrics.counter("wan.credits").inc()
            self._try_send(t)

    # -- driver -------------------------------------------------------------
    def run(self) -> WanReport:
        """Play the whole acquisition on the event loop; returns the
        :class:`WanReport` (local fan-out accounting in ``.stream``)."""
        with self.fabric.net.scoped_faults(self._faults):
            for fid, path, buf, t_emit in self._frames:
                self.loop.schedule(t_emit,
                                   partial(self._on_emit, fid, path, buf,
                                           t_emit),
                                   key="wan.detector")
            self.loop.run()
        srep = self.stager.finish()
        rep = self.report
        rep.stream = srep
        rep.retransmits = self.stager.retransmits
        rep.wan_time = self.stager.wan_time
        rep.wan_bytes = self.stager.wan_bytes
        rep.makespan = srep.ingest_makespan
        rep.drain_makespan = self.loop.now - self.t0
        return rep

    @property
    def records(self) -> List[FrameRecord]:
        return self.stager.records


def stage_wan(fabric: Fabric, paths: Sequence[str], t0: float = 0.0,
              rate_hz: Optional[float] = None,
              window_bytes: Optional[int] = None,
              pin_paths: Sequence[str] = (),
              topology: TopologyLike = None,
              credit_window: Optional[int] = None,
              buffer_frames: Optional[int] = None,
              subscribers: Union[int, Sequence[str]] = 1,
              consume_hz: Union[None, float, Sequence[float]] = None,
              loss_rate: float = 0.0, loss_seed: int = 0,
              compression: CompressionLike = None,
              jitter_seed: Optional[int] = None, jitter_windows: int = 0,
              jitter_window_s: Optional[float] = None,
              jitter_factors: Tuple[float, float] = (0.3, 0.9),
              ) -> Tuple[StagingReport, float]:
    """Cross-facility staging engine (``mode="wan"``).

    `paths` replay from the producer's buffers across the WAN ingest
    tier (the shared FS is never read back, ``fs_bytes == 0``) and fan
    out locally to every node-local store.  ``window_bytes`` defaults to
    the whole set; like ``stage_stream`` the unbounded window keeps
    every frame resident at the end (the engine pins the set at ingest —
    subscriber acks then only drive the credit protocol).  A bounded
    window turns the node cache into a sliding window governed by the
    slowest subscriber's watermark.  ``jitter_seed`` overlays a seeded
    `repro_torch.core.faults.FaultSchedule.wan_jitter` timeline of
    ``jitter_windows`` brownouts on the ingest tier, COMPOSED with
    whatever fault schedule the fabric already runs.  With the defaults
    (no jitter, no loss, credits never binding) the engine is byte- and
    time-exact vs ``stage_stream`` — the regression anchor.

    Returns ``(report, completion t)`` like every engine; the report's
    ``mode`` is ``"wan"``, ``n_chunks`` the delivered frame count, and
    the full :class:`WanReport` rides on ``report.wan``.
    """
    total = sum(fabric.fs.size(p) for p in paths)
    bounded = window_bytes is not None and window_bytes < total
    src = DetectorSource.replay_fs(fabric, paths, rate_hz=rate_hz, t0=t0)
    topo = (resolve_topology(topology) if topology is not None
            else fabric.net.topology)

    faults = None
    if jitter_seed is not None and jitter_windows > 0:
        # deterministic horizon estimate: acquisition span + every frame's
        # healthy WAN serialization, with slack — windows past delivery
        # are simply never consulted.  Planned (not executed): no bytes
        # are accounted by the estimate.
        sizes = [fabric.fs.size(p) for p in paths]
        planner = CollectivePlanner(topo, fabric.constants)
        xfer = sum(planner.plan_point_to_point(sz).time for sz in sizes)
        acq = (len(paths) / rate_hz) if rate_hz else 0.0
        horizon = t0 + acq + 4.0 * xfer + 1.0
        faults = FaultSchedule.wan_jitter(
            jitter_seed, horizon, tier=topo.ingest_tier.name,
            n_windows=jitter_windows, window=jitter_window_s,
            factor_range=jitter_factors)
        if not fabric.faults.trivial:
            # scoped_faults REPLACES the bound schedule, so compose the
            # jitter with the fabric's own timeline explicitly
            faults = FaultSchedule(list(fabric.faults.events)
                                   + list(faults.events))

    # unbounded window: the whole set stays resident (stage_stream
    # semantics) — pin everything at ingest so subscriber releases can
    # never evict; bounded: only the caller's pins are exempt
    pin_set = (set(pin_paths) | set(paths)) if not bounded \
        else set(pin_paths)

    with fabric.tracer.region("stage.wan", t0, track="engine") as tsp:
        session = WanSession(
            fabric, src, window_bytes=window_bytes or max(total, 1),
            credit_window=credit_window, buffer_frames=buffer_frames,
            subscribers=subscribers, consume_hz=consume_hz,
            loss_rate=loss_rate, loss_seed=loss_seed, topology=topology,
            compression=compression, faults=faults, pin_paths=pin_set, t0=t0)
        wrep = session.run()
        srep = wrep.stream

        rep = StagingReport(n_hosts=fabric.n_hosts,
                            total_bytes=srep.total_bytes, mode="wan")
        rep.stage_time = 0.0                   # no FS read phase at all
        rep.write_time = srep.total_bytes / fabric.constants.local_bw
        rep.comm_time = max(0.0, srep.ingest_makespan - rep.write_time)
        rep.fs_bytes = 0
        rep.net_bytes = srep.net_bytes
        rep.tier_bytes = dict(srep.tier_bytes)
        rep.comp = srep.comp
        rep.n_chunks = srep.n_frames
        rep.wan = wrep                        # full WAN-side accounting
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + srep.ingest_makespan
