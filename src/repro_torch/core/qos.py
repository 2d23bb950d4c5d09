"""QoS admission control + scheduling of concurrent analysis sessions.

The paper's facility setting is MULTI-TENANT: several beamline users
share one staging service, each expecting interactive turnaround. The
serial `repro_torch.core.datasvc.StagingService` already coalesces and queues
admissions, but its callers must issue operations in timestamp order —
one session at a time. This module puts the service on the shared
`repro_torch.core.events.EventLoop` so independent sessions genuinely overlap
in simulated time, and adds the policy layer the facility needs when
demand exceeds the node-memory budget:

  * admission control — a request whose dataset neither is resident nor
    fits the budget (even after evicting everything unleased) PARKS and
    is woken by actual lease-release events, instead of relying on the
    serial path's pre-recorded future release times;
  * scheduling — ``fifo`` admits strictly in arrival order (head-of-line
    blocking: nothing behind a parked head starts, the baseline);
    ``qos`` ranks parked requests by effective priority
    ``priority + aging_rate * (now - t_submit)`` (aging bounds
    starvation), breaks ties fair-share (sessions served least go
    first), and BACKFILLS — any admissible parked request may start;
  * preemptive eviction — under ``qos``, staging a new dataset evicts
    unleased residents lowest-priority-first (cost-ranked within a
    priority, priced at the CURRENT timeline state via
    `repro_torch.core.datasvc.predict_stage_time`), protecting high-priority
    tenants' warm datasets; ``fifo`` keeps the serial cheapest-first
    rule.

A single session with no contention takes exactly the serial code path
(`StagingService.acquire` at the arrival time, `_admit` passing straight
through), so zero-contention results are bit-exact with driving the
service directly. `benchmarks/bench_qos.py` puts a heavy-tailed
open-loop load through both policies and reports P50/P99 session latency
and goodput under overload.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.datasvc import (DatasetEntry, DatasetState, Lease,
                                StagingService, predict_stage_time)
from repro_torch.core.events import Event, EventLoop
from repro_torch.core.telemetry import exact_percentile

# states already counted against the budget: acquiring one of these
# costs no new memory (hit / coalesce / repair)
_OCCUPIED = (DatasetState.STAGING, DatasetState.RESIDENT,
             DatasetState.DEGRADED)


@dataclass(frozen=True)
class QoSPolicy:
    """Scheduling policy knobs.

    ``name`` selects the discipline: ``"fifo"`` (strict arrival order,
    the baseline) or ``"qos"`` (priority + aging + fair-share +
    backfill). ``aging_rate`` is priority points gained per simulated
    second parked — any positive rate bounds starvation, since a parked
    request's effective priority eventually tops every fixed one.
    ``preempt`` enables priority-ordered eviction of unleased residents;
    ``fair_share`` breaks rank ties toward the session served least."""
    name: str = "qos"
    aging_rate: float = 1.0
    preempt: bool = True
    fair_share: bool = True

    def __post_init__(self) -> None:
        if self.name not in ("fifo", "qos"):
            raise ValueError(f"unknown policy {self.name!r}; "
                             f"expected 'fifo' or 'qos'")
        if self.aging_rate < 0:
            raise ValueError("aging_rate must be >= 0")


FIFO = QoSPolicy(name="fifo", aging_rate=0.0, preempt=False,
                 fair_share=False)
QOS = QoSPolicy()


@dataclass
class SessionRequest:
    """One session's timed request for one dataset lease.

    Lifecycle: ``submit`` (t_submit) -> possibly parked -> ``t_admit``
    (scheduler starts it) -> ``t_ready`` (replicas usable; latency is
    ``t_ready - t_submit``) -> held for ``hold`` simulated seconds ->
    ``t_release``."""
    session_id: str
    dataset: str
    priority: int = 0
    hold: float = 0.0
    t_submit: float = 0.0
    seq: int = -1
    nbytes: int = 0
    t_admit: float = math.nan
    t_ready: float = math.nan
    t_release: float = math.nan
    park_reason: Optional[str] = None   # why the scheduler parked it (if it
    #                                     did): "budget" (not admissible) or
    #                                     "fifo_head_of_line" (blocked behind
    #                                     a parked head under strict FIFO)
    lease: Optional[Lease] = None
    on_complete: Optional[Callable[["SessionRequest"], None]] = field(
        default=None, repr=False)

    @property
    def latency(self) -> float:
        """Submit-to-ready simulated seconds (the session's wait for
        usable data — the interactivity metric)."""
        return self.t_ready - self.t_submit

    @property
    def parked_time(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def done(self) -> bool:
        return not math.isnan(self.t_release)


class QoSScheduler:
    """Event-driven multi-session front end to a :class:`StagingService`.

    :meth:`submit` schedules arrivals on the shared loop; :meth:`run`
    drains the timeline. Releases fire as timeline events and wake
    parked requests — the event-driven replacement for the serial
    path's "queue on a pre-recorded future release" branch (which
    cannot exist here: no release is known ahead of its event)."""

    def __init__(self, service: StagingService,
                 policy: Optional[QoSPolicy] = None,
                 loop: Optional[EventLoop] = None):
        self.service = service
        self.policy = policy if policy is not None else QOS
        self.loop = loop if loop is not None else EventLoop()
        self.pending: List[SessionRequest] = []
        self.completed: List[SessionRequest] = []
        self.preemptions = 0
        self._served: Dict[str, int] = {}       # session -> completed count
        self._ds_priority: Dict[str, int] = {}  # dataset -> residency priority
        self._seq = 0

    # -- submission ----------------------------------------------------------
    def submit(self, session_id: str, dataset: str, t: float, *,
               priority: int = 0, hold: float = 0.0,
               on_complete: Optional[Callable[["SessionRequest"], None]]
               = None) -> SessionRequest:
        """Schedule `session_id`'s request for `dataset` arriving at
        simulated time `t`; it will hold the lease for `hold` seconds
        past readiness. Returns the (not yet started) request record."""
        req = SessionRequest(session_id=session_id, dataset=dataset,
                             priority=priority, hold=hold, t_submit=t,
                             seq=self._seq, on_complete=on_complete)
        self._seq += 1
        self.loop.schedule(t, lambda: self._arrive(req),
                           key=f"session:{session_id}")
        return req

    def at(self, t: float, fn: Callable[[], None], *,
           key: Optional[str] = None, priority: int = 0) -> Event:
        """Schedule an arbitrary callback on the shared timeline (fault
        injections, resizes, out-of-band work)."""
        return self.loop.schedule(t, fn, key=key, priority=priority)

    def fail_host_at(self, host: int, t: float) -> Event:
        """Inject a host death at `t`, absorbed mid-timeline (before any
        same-instant session event — deaths do not queue behind work)."""
        return self.at(t, lambda: self.service.fail_host(host, t),
                       key="fault", priority=-2)

    def recover_host_at(self, host: int, t: float) -> Event:
        return self.at(t, lambda: self.service.recover_host(host, t),
                       key="fault", priority=-2)

    def resize_at(self, n_hosts: int, t: float) -> Event:
        """Elastically resize the campaign at `t` on the shared timeline."""
        return self.at(t, lambda: self.service.resize(n_hosts, t),
                       key="fault", priority=-2)

    # -- admission test ------------------------------------------------------
    def _freeable(self, now: float) -> List[DatasetEntry]:
        """Unleased residents evictable at `now` (what admission could
        reclaim)."""
        return [e for e in self.service.catalog
                if e.state in (DatasetState.RESIDENT, DatasetState.DEGRADED)
                and not e.leases and e.t_unleased <= now]

    def admissible(self, req: SessionRequest, now: float) -> bool:
        """True when starting `req` at `now` needs no future release:
        its dataset is already budget-resident (hit/coalesce/repair), or
        fits after evicting at most the currently unleased residents."""
        entry = self.service.catalog[req.dataset]
        if entry.state in _OCCUPIED:
            return True
        headroom = (self.service.budget_bytes
                    - self.service.catalog.resident_bytes
                    + sum(e.nbytes for e in self._freeable(now)))
        return entry.nbytes <= headroom

    # -- start / finish ------------------------------------------------------
    def _arrive(self, req: SessionRequest) -> None:
        now = self.loop.now
        req.nbytes = self.service.catalog[req.dataset].nbytes
        fits = self.admissible(req, now)
        if fits and (self.policy.name == "qos" or not self.pending):
            # fifo: an arrival may not overtake a parked head — it only
            # starts straight away when nobody is queued ahead of it
            self._start(req, now)
        else:
            req.park_reason = "budget" if not fits else "fifo_head_of_line"
            tr = self.service.fabric.tracer
            if tr.enabled:
                tr.instant("qos.park", now, track="qos",
                           session=req.session_id, dataset=req.dataset,
                           reason=req.park_reason)
                tr.metrics.counter(f"qos.park.{req.park_reason}").inc()
            self.pending.append(req)

    def _start(self, req: SessionRequest, now: float) -> None:
        entry = self.service.catalog[req.dataset]
        fresh = entry.state not in _OCCUPIED
        if fresh and self.policy.name == "qos" and self.policy.preempt:
            self._make_room(entry.nbytes, now)
        if fresh:
            self._ds_priority[req.dataset] = req.priority
        else:
            self._ds_priority[req.dataset] = max(
                self._ds_priority.get(req.dataset, req.priority),
                req.priority)
        req.t_admit = now
        req.lease = self.service.acquire(req.session_id, req.dataset, now)
        req.t_ready = req.lease.t_ready
        # the lease is held for `hold` seconds of analysis past readiness;
        # the release is a first-class timeline event (priority -1: at an
        # equal instant, memory frees before new arrivals ask for it)
        self.loop.schedule(req.t_ready + req.hold, lambda: self._finish(req),
                           priority=-1, key=f"session:{req.session_id}")

    def _make_room(self, need: int, now: float) -> None:
        """Preemptive eviction, lowest residency priority first (then
        cheapest to restage under the CURRENT timeline state, then name)
        — the qos policy's protection of high-priority warm datasets.
        Leaves any remaining pressure to the serial ``_admit`` rule."""
        cat = self.service.catalog
        while cat.resident_bytes + need > self.service.budget_bytes:
            victims = self._freeable(now)
            if not victims:
                return
            victim = min(victims, key=lambda e: (
                self._ds_priority.get(e.name, 0),
                predict_stage_time(self.service.fabric, e.nbytes,
                                   len(e.paths), t=now),
                e.name))
            self.service._evict(victim, now)
            self.preemptions += 1

    def _finish(self, req: SessionRequest) -> None:
        now = self.loop.now
        self.service.release(req.session_id, req.dataset, now)
        req.t_release = now
        self.completed.append(req)
        self._served[req.session_id] = (
            self._served.get(req.session_id, 0) + 1)
        tr = self.service.fabric.tracer
        if tr.enabled:
            # record only: every timestamp below was computed above, untraced
            sp = tr.span("qos.request", req.t_submit, now, track="qos",
                         session=req.session_id, dataset=req.dataset,
                         priority=req.priority, park_reason=req.park_reason)
            if req.t_admit > req.t_submit:
                tr.span("qos.parked", req.t_submit, req.t_admit, track="qos",
                        parent=sp, reason=req.park_reason)
            if req.t_ready > req.t_admit:
                tr.span("qos.service", req.t_admit, req.t_ready, track="qos",
                        parent=sp)
            if now > req.t_ready:
                tr.span("qos.hold", req.t_ready, now, track="qos", parent=sp)
            tr.metrics.histogram("qos.latency_s").observe(req.latency)
            tr.metrics.counter("qos.completed").inc()
        if req.on_complete is not None:
            req.on_complete(req)
        self._wake(now)

    # -- wake-up discipline --------------------------------------------------
    def _rank(self, req: SessionRequest, now: float):
        aged = req.priority + self.policy.aging_rate * (now - req.t_submit)
        share = (self._served.get(req.session_id, 0)
                 if self.policy.fair_share else 0)
        return (-aged, share, req.t_submit, req.seq)

    def _wake(self, now: float) -> None:
        if self.policy.name == "fifo":
            # strict arrival order: drain the admissible PREFIX only —
            # a parked head blocks everything behind it (head-of-line
            # blocking, the baseline's P99 failure mode under overload)
            while self.pending and self.admissible(self.pending[0], now):
                self._start(self.pending.pop(0), now)
            return
        # qos: repeatedly start the best-ranked admissible request;
        # backfill means a blocked leader does not idle the budget, and
        # aging means it cannot be overtaken forever
        while self.pending:
            for req in sorted(self.pending, key=lambda r: self._rank(r, now)):
                if self.admissible(req, now):
                    self.pending.remove(req)
                    self._start(req, now)
                    break
            else:
                return

    # -- drain ---------------------------------------------------------------
    def run(self, until: float = math.inf) -> float:
        """Drain the shared timeline (up to `until`). A full drain that
        leaves requests parked means no release can ever admit them —
        the event-driven analogue of the serial path's "wedged" error,
        raised just as loudly."""
        t_end = self.loop.run(until=until)
        if self.pending and not math.isfinite(until):
            starved = [(r.session_id, r.dataset) for r in self.pending]
            raise RuntimeError(
                f"scheduler drained with {len(self.pending)} request(s) "
                f"still parked (no release left to wake them): {starved}")
        return t_end

    # -- reporting -----------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """P50/P99 session latency, goodput, and counters over the
        completed requests (simulated time throughout)."""
        if not self.completed:
            return {"completed": 0, "parked": len(self.pending),
                    "p50_latency": math.nan, "p99_latency": math.nan,
                    "mean_latency": math.nan, "goodput_bytes_per_s": 0.0,
                    "makespan": 0.0, "preemptions": self.preemptions}
        lat = np.array([r.latency for r in self.completed])
        t0 = min(r.t_submit for r in self.completed)
        t1 = max(r.t_release for r in self.completed)
        makespan = t1 - t0
        total = float(sum(r.nbytes for r in self.completed))
        return {
            "completed": len(self.completed),
            "parked": len(self.pending),
            "p50_latency": exact_percentile(lat, 50),
            "p99_latency": exact_percentile(lat, 99),
            "mean_latency": float(lat.mean()),
            "goodput_bytes_per_s": total / makespan if makespan > 0 else 0.0,
            "makespan": makespan,
            "preemptions": self.preemptions,
        }
