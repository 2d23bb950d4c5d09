"""Multi-tenant dataset catalog + staging service (long-lived residency).

The paper's interactivity claim rests on data being "staged into and
cached in compute node memory for EXTENDED PERIODS, during which time
VARIOUS PROCESSING TASKS may efficiently access it" — i.e. on a
long-lived *service* managing resident datasets, not on any single
one-shot transfer (the same lesson the streaming follow-ons draw:
Welborn et al., Perlmutter detector streaming; Poeschel et al.,
openPMD/ADIOS2 pipelines). The one-shot engines live in
`repro_torch.core.staging`; this module is the service above them:

  * :class:`DataCatalog` — per-dataset lifecycle bookkeeping
    (``REGISTERED -> STAGING -> RESIDENT -> EVICTING -> GONE``, with
    ``GONE -> STAGING`` on transparent re-stage), lease counts held by
    concurrent analysis sessions, stage/coalesce/hit counters, and a
    transition history for every dataset.
  * :class:`StagingService` — admission control over a global per-node
    memory budget: requests for the same dataset COALESCE (two sessions
    asking for one dataset share one collective stage), unleased
    residents evict cheapest-to-restage-first under pressure, admissions
    QUEUE on future lease releases when nothing is evictable yet, and
    evicted datasets re-stage transparently on the next acquire. Staged
    files are lease-pinned in every node-local store (refcounted —
    `repro_torch.core.fabric.NodeLocalStore.pin`), so a dataset leased by any
    session can never be evicted under it.
  * write-back — the missing output path: session results become dirty
    node-local replicas (:meth:`StagingService.put_result`) and are
    flushed to the shared FS with the collective
    :func:`repro_torch.core.staging.stage_out` (disjoint 1/P stripe writes via
    ``SharedFilesystem.write_gather``; the naive every-host-writes
    baseline is kept for comparison).
  * :class:`AnalysisSession` — a tenant handle: leases, result writes,
    and session-tagged `repro_torch.core.manytask` tasks (``Task.session``).

Driving model: like the rest of the simulator, the service is driven by
callers passing explicit SIMULATED times ``t`` (seconds); it keeps no
clock of its own. Interleave calls from several sessions in any program
order — causality is carried by the time arguments, so a session
acquiring at a ``t`` inside another session's in-flight stage window
joins that stage (coalescing), and a release recorded with a future
timestamp is what a queued admission waits on. Replicas move REAL bytes
(zero-copy read-only views, byte-exact); see `repro_torch.core.fabric` for the
sim-vs-wall time discipline.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import staging as _staging
from repro_torch.core.api import ENGINES
from repro_torch.core.compression import CompressionLike, resolve_codec
from repro_torch.core.fabric import Fabric, FaultEvent, FaultKind, Host
from repro_torch.core.staging import (LostStripesError, ReplicaLossError,
                                ReplicaPlacement, StagingReport,
                                _coll_overhead, readonly_view, stage_out,
                                stage_out_naive)


class DatasetState(enum.Enum):
    """Dataset lifecycle. Legal transitions::

        REGISTERED -> STAGING -> RESIDENT -> EVICTING -> GONE -> STAGING
                                    |  ^
                                    v  | (repair: re_replicate)
                                 DEGRADED -> STAGING   (no live copy left)
                                    |
                                    v
                                 EVICTING              (give up residency)

    DEGRADED means residency LOST REDUNDANCY (a holder died, a grown host
    lacks its replica) but live leases keep working off the surviving
    replicas — it is not an error state, it is a repair-pending state.
    """
    REGISTERED = "registered"
    STAGING = "staging"
    RESIDENT = "resident"
    DEGRADED = "degraded"
    EVICTING = "evicting"
    GONE = "gone"


_LEGAL = {
    DatasetState.REGISTERED: {DatasetState.STAGING},
    DatasetState.STAGING: {DatasetState.RESIDENT},
    DatasetState.RESIDENT: {DatasetState.EVICTING, DatasetState.DEGRADED},
    DatasetState.DEGRADED: {DatasetState.RESIDENT, DatasetState.STAGING,
                            DatasetState.EVICTING},
    DatasetState.EVICTING: {DatasetState.GONE},
    DatasetState.GONE: {DatasetState.STAGING},
}


@dataclass
class Lease:
    """One session's hold on one resident dataset.

    ``t_request`` is when the session asked (simulated s); ``t_ready``
    when the replicas are usable on every node-local store — equal to
    ``t_request`` for a residency hit, later for a (joined) stage."""
    session_id: str
    dataset: str
    t_request: float
    t_ready: float


@dataclass
class DatasetEntry:
    """Catalog record for one dataset (a named set of shared-FS files)."""
    name: str
    paths: List[str]
    nbytes: int                      # total dataset bytes (per-node cost)
    state: DatasetState = DatasetState.REGISTERED
    t_ready: float = 0.0             # completion of the in-flight/last stage
    t_unleased: float = 0.0          # when the lease count last hit zero
    leases: Dict[str, int] = field(default_factory=dict)   # session -> holds
    stage_count: int = 0             # completed stagings (= residencies)
    acquires: int = 0
    hits: int = 0                    # served from residency
    coalesced: int = 0               # joined an in-flight stage
    repairs: int = 0                 # re_replicate operations on this entry
    # which hosts currently hold this dataset's replicas/stripes (full
    # replication: every host written at stage time; striped: the stripe
    # owners). Host death discards the victim; repair restores coverage.
    holders: Set[int] = field(default_factory=set)
    # striped R-way placement (stage_replicated engine); None = fully
    # replicated on every holder
    placement: Optional[ReplicaPlacement] = None
    last_report: Optional[StagingReport] = None
    history: List[Tuple[float, DatasetState]] = field(default_factory=list)

    def to_state(self, state: DatasetState, t: float) -> None:
        if state not in _LEGAL[self.state]:
            raise RuntimeError(f"illegal dataset transition "
                               f"{self.state.value} -> {state.value} "
                               f"({self.name!r} at t={t:.3f})")
        self.state = state
        self.history.append((t, state))

    @property
    def lease_count(self) -> int:
        return sum(self.leases.values())

    def state_at(self, t: float) -> DatasetState:
        """The state as observed at simulated time `t`: a dataset whose
        stage completes at ``t_ready > t`` is still STAGING then."""
        if self.state is DatasetState.RESIDENT and t < self.t_ready:
            return DatasetState.STAGING
        return self.state


class DataCatalog:
    """Name -> :class:`DatasetEntry` bookkeeping (no I/O of its own)."""

    def __init__(self) -> None:
        self._entries: Dict[str, DatasetEntry] = {}

    def add(self, entry: DatasetEntry) -> DatasetEntry:
        if entry.name in self._entries:
            raise ValueError(f"dataset {entry.name!r} already registered")
        self._entries[entry.name] = entry
        return entry

    def __getitem__(self, name: str) -> DatasetEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown dataset {name!r}; registered: "
                f"{sorted(self._entries)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self):
        return iter(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        """Bytes counted against the node budget: STAGING + RESIDENT +
        DEGRADED (a degraded dataset still occupies its surviving
        replicas' memory — losing redundancy does not free the budget)."""
        return sum(e.nbytes for e in self._entries.values()
                   if e.state in (DatasetState.STAGING,
                                  DatasetState.RESIDENT,
                                  DatasetState.DEGRADED))

    def states(self) -> Dict[str, str]:
        return {n: e.state.value for n, e in self._entries.items()}


@dataclass
class ServiceStats:
    """Service-wide accounting (all times simulated seconds)."""
    stages: int = 0              # collective stage operations actually run
    restages: int = 0            # of those, re-stages of evicted datasets
    coalesced: int = 0           # acquires that joined an in-flight stage
    hits: int = 0                # acquires served from residency
    evictions: int = 0
    queue_waits: int = 0         # admissions that waited on a lease release
    queue_wait_time: float = 0.0
    host_deaths: int = 0         # death events the catalog absorbed
    recoveries: int = 0          # recovery events absorbed
    degraded_events: int = 0     # RESIDENT -> DEGRADED transitions
    repairs: int = 0             # re_replicate operations (not re-stages)
    repaired_bytes: int = 0      # bytes moved by repair collectives
    repair_time: float = 0.0     # total repair collective time
    resizes: int = 0             # elastic grow/shrink operations
    stage_time: float = 0.0      # total stage engine time
    metadata_time: float = 0.0   # registration glob phase
    broadcast_time: float = 0.0  # registration manifest broadcasts (on_root)
    writeback_reports: List[StagingReport] = field(default_factory=list)

    @property
    def writeback_time(self) -> float:
        return sum(r.total_time for r in self.writeback_reports)


def predict_stage_time(fabric: Fabric, nbytes: int, n_files: int,
                       t: Optional[float] = None,
                       codec: CompressionLike = None) -> float:
    """Predicted simulated seconds to collectively stage a dataset of
    `nbytes` across `n_files` files — the eviction cost model (mirrors
    the ``stage_collective`` formula on an idle fabric, without touching
    any traffic counters). The replication phase is PLANNED through the
    fabric topology's `repro_torch.core.collectives` planner (pure cost query),
    so the prediction tracks whatever collective algorithm the fabric's
    machine model would actually pick.

    `t` is the simulated issue time the prediction is FOR: under a
    non-trivial fault schedule the comm phase is planned over the hosts
    live at `t` with that moment's degraded tier bandwidths — the
    candidate's CURRENT timeline state, which is what an eviction
    ranking at `t` must compare. ``t=None`` (or a trivial schedule)
    prices the healthy fabric, bit-exact with the pre-fault formula.

    `codec` (any `repro_torch.core.compression` spelling) prices the comm
    phase under the service engine's compression config: the planner
    runs the same per-tier compress-at-source election a real stage
    would, so eviction rankings stay truthful when staging ships
    compressed. ``None`` predicts the raw wire, bit-exact."""
    c = fabric.constants
    P = fabric.n_hosts
    active = resolve_codec(codec)
    t_read = (nbytes / c.fs_seq_bw + n_files * _coll_overhead(fabric)
              + c.fs_op_latency)
    stripe = max(1, (nbytes + P - 1) // P)
    if t is None or fabric.faults.trivial:
        t_comm = fabric.net.planner.plan_allgather(stripe, P,
                                                   codec=active).time
    else:
        planner, dead = fabric.net._fault_state(t, P)
        t_comm = planner.plan_allgather(stripe, P - dead, dead=dead,
                                        codec=active).time
    return t_read + t_comm + nbytes / c.local_bw


class StagingService:
    """Long-lived staging service over one :class:`~repro_torch.core.fabric.Fabric`.

    ``budget_bytes`` bounds the PER-NODE memory the catalog may hold
    resident (every staged dataset is fully replicated on every node, so
    per-node and aggregate-fraction budgets coincide). The staging engine
    used for every stage comes from the `repro_torch.core.api.ENGINES`
    registry: pass either a typed config via ``engine=`` (e.g.
    ``PipelinedConfig(chunk_bytes=...)``) or the legacy ``mode`` name
    ("collective"/"pipelined"/"naive") plus ``stage_kw`` keywords.

    Dirty write-back replicas (:meth:`put_result`) are small reduced
    results (the paper's 8 MB frame -> ~1 MB binary) and are tracked
    outside the dataset budget; :meth:`flush` frees them.
    """

    def __init__(self, fabric: Fabric, budget_bytes: int,
                 mode: str = "collective",
                 stage_kw: Optional[Dict] = None,
                 engine=None, registry=None):
        reg = registry if registry is not None else ENGINES
        if engine is not None:
            if mode != "collective" or stage_kw is not None:
                raise ValueError(
                    "pass either engine= (a typed config) or the legacy "
                    "mode=/stage_kw= arguments, not both — the loose "
                    "keywords would be silently discarded")
            entry = reg.entry_for(engine)
            # re-resolve with the batch constraint: a registered non-batch
            # engine (e.g. stream) gets the "not batch-capable" message,
            # not a misleading "unknown mode"
            entry = reg.entry(entry.name, batch_only=True)
            self._stage_fn = entry.stage_fn
            self._stage_kw = engine.to_kw()
        else:
            config = reg.config_for(mode, batch_only=True,
                                    **(stage_kw or {}))
            self._stage_fn = reg.stage_fn(mode)
            self._stage_kw = config.to_kw()
        # the engine's staging codec (None = raw), fed to every
        # predict_stage_time eviction ranking so the cost model prices
        # the wire the engine would actually use
        self._codec = resolve_codec(self._stage_kw.get("compression"))
        self.fabric = fabric
        self.budget_bytes = int(budget_bytes)
        self.catalog = DataCatalog()
        self.stats = ServiceStats()
        self._dirty: Dict[str, Dict[str, np.ndarray]] = {}  # session -> paths

    # -- registration -------------------------------------------------------
    def session(self, session_id: str) -> "AnalysisSession":
        return AnalysisSession(self, session_id)

    def register(self, name: str, patterns: Optional[Sequence[str]] = None,
                 paths: Optional[Sequence[str]] = None, t: float = 0.0
                 ) -> Tuple[DatasetEntry, float]:
        """Register dataset `name`, idempotently.

        Either `patterns` (fnmatch globs, resolved ONCE by the leader root
        and broadcast — charges metadata + broadcast time) or explicit
        `paths` (no metadata charge). Returns ``(entry, completion t)``;
        a re-registration returns the existing entry at `t` unchanged.
        """
        if name in self.catalog:
            return self.catalog[name], t
        if (patterns is None) == (paths is None):
            raise ValueError("register() needs exactly one of "
                             "patterns= or paths=")
        if patterns is not None:
            from repro_torch.core.iohook import resolve_manifest_timed
            files, t_done, bcast = resolve_manifest_timed(
                self.fabric, patterns, t)
            self.stats.metadata_time += t_done - t - bcast
            self.stats.broadcast_time += bcast
        else:
            files, t_done = list(paths), t
        if not files:
            raise ValueError(f"dataset {name!r} resolved to no files")
        nbytes = sum(self.fabric.fs.size(p) for p in files)
        if nbytes > self.budget_bytes:
            raise ValueError(
                f"dataset {name!r} ({nbytes} B) exceeds the service "
                f"budget ({self.budget_bytes} B) and could never stage")
        entry = DatasetEntry(name=name, paths=files, nbytes=nbytes)
        entry.history.append((t_done, DatasetState.REGISTERED))
        return self.catalog.add(entry), t_done

    # -- replica key / pin bookkeeping ---------------------------------------
    def _entry_keys(self, entry: DatasetEntry, t: float
                    ) -> Iterator[Tuple[Host, str]]:
        """``(host, store key)`` pairs of `entry`'s replicas on the hosts
        LIVE at `t` (the trivial schedule yields every host — the
        pre-fault path). Full replication: every path on every host;
        striped: each stripe's key on its owners."""
        fab = self.fabric
        hosts = fab.hosts if fab.faults.trivial else fab.live_hosts(t)
        if entry.placement is None:
            for host in hosts:
                for p in entry.paths:
                    yield host, p
        else:
            live = {h.host_id for h in hosts}
            n = len(fab.hosts)
            for i, own in entry.placement.owners.items():
                for o in own:
                    if o in live and o < n:
                        for p in entry.paths:
                            yield (fab.hosts[o],
                                   ReplicaPlacement.stripe_key(p, i))

    def _pin_once(self, entry: DatasetEntry, t: float) -> None:
        for host, key in self._entry_keys(entry, t):
            host.store.pin(key)

    def _unpin_once(self, entry: DatasetEntry, t: float) -> None:
        for host, key in self._entry_keys(entry, t):
            host.store.unpin(key)

    def _drop_replicas(self, entry: DatasetEntry) -> None:
        """Drop every replica key of `entry` from every store (any pins
        go with them — `NodeLocalStore.drop` semantics)."""
        if entry.placement is None:
            keys = list(entry.paths)
        else:
            keys = [ReplicaPlacement.stripe_key(p, i)
                    for i in entry.placement.owners for p in entry.paths]
        for host in self.fabric.hosts:
            for key in keys:
                host.store.drop(key)

    def _after_stage(self, entry: DatasetEntry, rep: StagingReport,
                     t_done: float) -> None:
        """Record who holds the fresh replicas (stage engines deliver to
        every live host; the replicated engine reports its placement)."""
        entry.placement = rep.placement
        if rep.placement is not None:
            entry.holders = set(rep.placement.hosts())
        else:
            fab = self.fabric
            entry.holders = (set(range(fab.n_hosts)) if fab.faults.trivial
                             else set(fab.live_ids(t_done)))

    def _trans(self, entry: DatasetEntry, state: DatasetState,
               t: float) -> None:
        """`DatasetEntry.to_state` plus telemetry: one instant event per
        lifecycle transition, so a trace shows WHEN each dataset moved
        through REGISTERED/STAGING/RESIDENT/DEGRADED/EVICTING/GONE (the
        validation and history bookkeeping are unchanged)."""
        entry.to_state(state, t)
        tr = self.fabric.tracer
        if tr.enabled:
            tr.instant(f"dataset.{state.value}", t, track="svc",
                       dataset=entry.name)
            tr.metrics.counter(f"svc.transition.{state.value}").inc()

    # -- lease lifecycle ----------------------------------------------------
    def acquire(self, session_id: str, name: str, t: float) -> Lease:
        """Lease dataset `name` for `session_id` at simulated time `t`.

        RESIDENT at `t`  -> lease immediately (``t_ready == t``).
        STAGING at `t`   -> coalesce: join the in-flight stage, share its
                            completion time. No second stage is run.
        DEGRADED at `t`  -> repair (:meth:`re_replicate`) and lease at the
                            repair's completion — never a wedge.
        REGISTERED/GONE  -> stage (transparent re-stage on miss), possibly
                            evicting unleased datasets or queueing on a
                            future lease release first.

        The dataset's replica keys are lease-pinned in the live node-local
        stores until the matching :meth:`release`.
        """
        entry = self.catalog[name]
        entry.acquires += 1
        t_admit = t
        if entry.state is DatasetState.RESIDENT:
            if t < entry.t_ready:            # the stage is still in flight
                entry.coalesced += 1
                self.stats.coalesced += 1
                outcome = "coalesced"
            else:
                entry.hits += 1
                self.stats.hits += 1
                outcome = "hit"
            t_ready = max(t, entry.t_ready)
        elif entry.state is DatasetState.DEGRADED:
            # acquire on a degraded dataset triggers repair, not a wedge;
            # counted as a repair (neither a hit nor a stage) so the
            # fault-free invariant acquires == stages+coalesced+hits
            # extends to ... + repairs under injected failures
            _, t_ready = self.re_replicate(name, t)
            outcome = "repair"
        else:                                # REGISTERED or GONE
            restage = entry.state is DatasetState.GONE
            outcome = "restage" if restage else "stage"
            t_admit = self._admit(entry, t)
            self._trans(entry, DatasetState.STAGING, t_admit)
            rep, t_done = self._stage_fn(self.fabric, entry.paths, t_admit,
                                         **self._stage_kw)
            entry.last_report = rep
            entry.t_ready = t_done
            entry.stage_count += 1
            self._trans(entry, DatasetState.RESIDENT, t_done)
            self._after_stage(entry, rep, t_done)
            self.stats.stages += 1
            self.stats.restages += int(restage)
            self.stats.stage_time += rep.total_time
            t_ready = t_done
        entry.leases[session_id] = entry.leases.get(session_id, 0) + 1
        self._pin_once(entry, t_ready)
        tr = self.fabric.tracer
        if tr.enabled:
            # coalesced-acquire attribution: the span covers [t, t_ready),
            # i.e. the tail of the in-flight stage this request joined
            sp = tr.span("svc.acquire", t, t_ready, track="svc",
                         dataset=name, session=session_id, outcome=outcome)
            if t_admit > t:
                tr.span("svc.queue_wait", t, t_admit, track="svc",
                        parent=sp, dataset=name)
            tr.metrics.counter(f"svc.acquire.{outcome}").inc()
            tr.metrics.histogram("svc.acquire_latency_s").observe(
                t_ready - t)
        return Lease(session_id=session_id, dataset=name,
                     t_request=t, t_ready=t_ready)

    def release(self, session_id: str, name: str, t: float) -> None:
        """Return one lease on `name` at simulated time `t`. When the last
        lease goes, the dataset becomes evictable from `t` on (queued
        admissions may be waiting on exactly this moment)."""
        entry = self.catalog[name]
        held = entry.leases.get(session_id, 0)
        if not held:
            raise RuntimeError(f"session {session_id!r} holds no lease on "
                               f"dataset {name!r}")
        if held == 1:
            del entry.leases[session_id]
        else:
            entry.leases[session_id] = held - 1
        self._unpin_once(entry, t)
        if not entry.leases:
            entry.t_unleased = max(entry.t_unleased, t)

    # -- admission / eviction -----------------------------------------------
    def _evict(self, entry: DatasetEntry, t: float) -> None:
        self._trans(entry, DatasetState.EVICTING, t)
        self._drop_replicas(entry)
        self._trans(entry, DatasetState.GONE, t)  # drop: free bookkeeping
        entry.holders = set()
        entry.placement = None
        self.stats.evictions += 1

    def _admit(self, entry: DatasetEntry, t: float) -> float:
        """Admission time for staging `entry` requested at `t`: evict
        unleased residents cheapest-to-restage first; if pressure remains,
        queue on the earliest already-recorded future lease release; if no
        release can ever free enough memory, fail loudly."""
        need = entry.nbytes
        t_admit = t
        while self.catalog.resident_bytes + need > self.budget_bytes:
            free = [e for e in self.catalog
                    if e.state in (DatasetState.RESIDENT,
                                   DatasetState.DEGRADED)
                    and not e.leases]
            now = [e for e in free if e.t_unleased <= t_admit]
            if now:
                # cost-aware: cheapest to bring back if needed again,
                # priced under the timeline state AT admission time
                victim = min(now, key=lambda e: (predict_stage_time(
                    self.fabric, e.nbytes, len(e.paths), t=t_admit,
                    codec=self._codec), e.name))
                self._evict(victim, t_admit)
                continue
            future = [e for e in free if e.t_unleased > t_admit]
            if not future:
                held = {e.name: sorted(e.leases) for e in self.catalog
                        if e.state in (DatasetState.RESIDENT,
                                       DatasetState.DEGRADED) and e.leases}
                raise RuntimeError(
                    f"staging service wedged admitting {entry.name!r} "
                    f"({need} B): budget {self.budget_bytes} B holds "
                    f"{self.catalog.resident_bytes} B, all leased: {held}")
            # queued admission: wait for the earliest release, then evict
            victim = min(future, key=lambda e: (e.t_unleased, e.name))
            self.stats.queue_wait_time += victim.t_unleased - t_admit
            t_admit = victim.t_unleased
            self._evict(victim, t_admit)
        if t_admit > t:
            self.stats.queue_waits += 1
        return t_admit

    # -- fault handling / self-healing ---------------------------------------
    def sync_faults(self, t: float) -> List[FaultEvent]:
        """Advance the fabric's fault clock to `t` and absorb the events
        into the catalog: a host death discards the victim from every
        dataset's holders and degrades affected residents; a recovery
        brings a BLANK host back, degrading fully-replicated residents
        (which must cover every live host) until repaired. Returns the
        events applied. Live leases are untouched either way — they keep
        reading the surviving replicas."""
        events = self.fabric.advance_faults(t)
        for ev in events:
            if ev.kind is FaultKind.HOST_DEATH:
                self._on_host_death(ev.host, ev.t)
            elif ev.kind is FaultKind.HOST_RECOVERY:
                self._on_host_recovery(ev.host, ev.t)
        return events

    def _on_host_death(self, host: int, t: float) -> None:
        self.stats.host_deaths += 1
        for entry in self.catalog:
            if host in entry.holders:
                entry.holders.discard(host)
                if entry.state is DatasetState.RESIDENT:
                    self._trans(entry, DatasetState.DEGRADED, t)
                    self.stats.degraded_events += 1

    def _on_host_recovery(self, host: int, t: float) -> None:
        self.stats.recoveries += 1
        for entry in self.catalog:
            # full replication promises a replica on EVERY live host; the
            # recovered host came back blank, so coverage is broken until
            # repair broadcasts it a copy. Striped placements only need
            # their R owners, which the recovered host is not — they stay
            # RESIDENT.
            if (entry.state is DatasetState.RESIDENT
                    and entry.placement is None
                    and host not in entry.holders):
                self._trans(entry, DatasetState.DEGRADED, t)
                self.stats.degraded_events += 1

    def fail_host(self, host: int, t: float) -> List[FaultEvent]:
        """Inject a host death at `t` and absorb it immediately."""
        self.fabric.faults.inject(
            FaultEvent(t, FaultKind.HOST_DEATH, host=host))
        return self.sync_faults(t)

    def recover_host(self, host: int, t: float) -> List[FaultEvent]:
        """Inject a host recovery (blank store) at `t` and absorb it."""
        self.fabric.faults.inject(
            FaultEvent(t, FaultKind.HOST_RECOVERY, host=host))
        return self.sync_faults(t)

    def re_replicate(self, name: str, t: float
                     ) -> Tuple[StagingReport, float]:
        """Repair dataset `name` back to RESIDENT at simulated time `t`.

        Striped datasets copy only the LOST stripes from surviving owners
        (`repro_torch.core.staging.re_replicate` — cost ~ lost/P of the
        dataset); fully replicated datasets broadcast complete replicas
        to the live hosts missing one (recovered-blank or grown). When no
        live copy survives at all, falls back to a full re-stage from the
        shared FS (DEGRADED -> STAGING -> RESIDENT). Live leases keep
        their pins throughout — repaired hosts are pinned up to the
        current lease count, so repair is lease-preserving.

        Returns ``(repair report, completion time)``. RESIDENT is a
        no-op; any other state is an error."""
        entry = self.catalog[name]
        if entry.state is DatasetState.RESIDENT:
            return (StagingReport(n_hosts=self.fabric.n_hosts,
                                  total_bytes=0, mode="re_replicate"),
                    max(t, entry.t_ready))
        if entry.state is not DatasetState.DEGRADED:
            raise RuntimeError(
                f"cannot repair dataset {name!r} in state "
                f"{entry.state.value} (repair applies to DEGRADED)")
        live = self.fabric.live_ids(t)
        count = entry.lease_count
        if entry.placement is not None:
            old = {i: set(own)
                   for i, own in entry.placement.owners.items()}
            try:
                rep, t_done = _staging.re_replicate(
                    self.fabric, entry.paths, entry.placement, t0=t,
                    live=live)
            except LostStripesError:
                return self._restage_degraded(entry, t)
            entry.holders = set(entry.placement.hosts())
            if count:
                # lease-preserving: freshly written owners take over the
                # dead owners' pins at the current lease depth
                for i, own in entry.placement.owners.items():
                    for o in set(own) - old[i]:
                        for p in entry.paths:
                            key = ReplicaPlacement.stripe_key(p, i)
                            for _ in range(count):
                                self.fabric.hosts[o].store.pin(key)
        else:
            alive = set(live)
            sources = sorted(entry.holders & alive)
            targets = sorted(alive - entry.holders)
            if not sources:
                return self._restage_degraded(entry, t)
            if targets:
                rep, t_done = _staging.re_replicate_full(
                    self.fabric, entry.paths, targets, t0=t,
                    sources=sources)
                if count:
                    for o in targets:
                        for p in entry.paths:
                            for _ in range(count):
                                self.fabric.hosts[o].store.pin(p)
            else:
                # every live host already holds a replica: the dead host
                # simply leaves the residency set — repaired around, no
                # bytes moved
                rep = StagingReport(n_hosts=len(live), total_bytes=0,
                                    mode="re_replicate")
                t_done = t
            entry.holders = alive
        self._trans(entry, DatasetState.RESIDENT, t_done)
        entry.t_ready = max(entry.t_ready, t_done)
        entry.repairs += 1
        self.stats.repairs += 1
        self.stats.repaired_bytes += rep.net_bytes
        self.stats.repair_time += rep.total_time
        return rep, t_done

    def _restage_degraded(self, entry: DatasetEntry, t: float
                          ) -> Tuple[StagingReport, float]:
        """No live copy survives: the only way back is the shared FS.
        The entry's bytes already count against the budget (DEGRADED
        occupies it), so no admission pass — straight to STAGING. Live
        leases are re-pinned onto the fresh replicas."""
        count = entry.lease_count
        self._drop_replicas(entry)          # stale stripes + pins go
        self._trans(entry, DatasetState.STAGING, t)
        rep, t_done = self._stage_fn(self.fabric, entry.paths, t,
                                     **self._stage_kw)
        entry.last_report = rep
        entry.t_ready = t_done
        entry.stage_count += 1
        self._trans(entry, DatasetState.RESIDENT, t_done)
        self._after_stage(entry, rep, t_done)
        self.stats.stages += 1
        self.stats.restages += 1
        self.stats.stage_time += rep.total_time
        for _ in range(count):
            self._pin_once(entry, t_done)
        return rep, t_done

    # -- elasticity ----------------------------------------------------------
    def resize(self, n_hosts: int, t: float) -> List[int]:
        """Elastically grow or shrink the campaign to `n_hosts` hosts at
        simulated time `t` (`repro_torch.core.fabric.Fabric.resize`).

        Growing appends BLANK hosts: fully replicated residents degrade
        (the new hosts lack replicas) until repaired; striped placements
        keep their stripe geometry and stay RESIDENT. Shrinking removes
        the highest-id hosts and their replicas: striped residents that
        lose an owner degrade; fully replicated residents stay RESIDENT
        (every surviving host still holds a copy). Returns the affected
        host ids."""
        grow = n_hosts > self.fabric.n_hosts
        changed = self.fabric.resize(n_hosts)
        self.stats.resizes += 1
        if grow:
            for entry in self.catalog:
                if (entry.state is DatasetState.RESIDENT
                        and entry.placement is None):
                    self._trans(entry, DatasetState.DEGRADED, t)
                    self.stats.degraded_events += 1
        else:
            removed = set(changed)
            for entry in self.catalog:
                entry.holders -= removed
                if (entry.state is DatasetState.RESIDENT
                        and entry.placement is not None
                        and any(o in removed
                                for own in entry.placement.owners.values()
                                for o in own)):
                    self._trans(entry, DatasetState.DEGRADED, t)
                    self.stats.degraded_events += 1
        return changed

    # -- write-back ---------------------------------------------------------
    def put_result(self, session_id: str, name: str, data: np.ndarray,
                   t: float) -> Tuple[str, float]:
        """Install a session result as a DIRTY node-local replica.

        Results are produced replicated (every host ran the same reduction
        over the same staged replicas), so one shared read-only view lands
        on every node-local store, charged at ``local_bw``; the buffer is
        remembered for :meth:`flush`. Returns ``(result path, completion
        t)``. Result replicas are pinned until flushed and tracked outside
        the dataset budget (reduced outputs are small — paper §VI-A)."""
        path = f"results/{session_id}/{name}.bin"
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        view = readonly_view(buf)
        t_done = t
        for host in self.fabric.hosts:
            t_done = max(t_done, host.store.write(path, view, t))
            host.store.pin(path)
        self._dirty.setdefault(session_id, {})[path] = buf
        return path, t_done

    def flush(self, session_id: str, t: float, collective: bool = True
              ) -> Tuple[StagingReport, float]:
        """Flush the session's dirty results to the shared FS.

        ``collective=True`` uses :func:`repro_torch.core.staging.stage_out`
        (disjoint 1/P stripe writes, the ``MPI_File_write_all`` mirror);
        ``False`` the naive every-host-writes-everything baseline. The
        flushed node-local replicas are dropped (their memory returns to
        the nodes). Returns ``(report, completion t)``; flushing with
        nothing dirty returns an empty report at `t`."""
        outputs = self._dirty.pop(session_id, {})
        if not outputs:
            return (StagingReport(n_hosts=self.fabric.n_hosts, total_bytes=0,
                                  mode="stage_out"), t)
        fn = stage_out if collective else stage_out_naive
        rep, t_done = fn(self.fabric, outputs, t)
        for host in self.fabric.hosts:
            for path in outputs:
                host.store.drop(path)
        self.stats.writeback_reports.append(rep)
        return rep, t_done

    @property
    def dirty_bytes(self) -> int:
        return sum(b.size for bufs in self._dirty.values()
                   for b in bufs.values())


@dataclass
class AnalysisSession:
    """A tenant of the staging service: its leases, results, and tasks.

    Thin sugar over the service with the session id filled in, plus
    :meth:`tag` for session-tagged many-task work (the scheduler then
    reports per-session accounting in ``EngineStats.sessions``).

    A context manager: ``__exit__`` calls :meth:`close`, releasing every
    lease this session still holds — even when the body raised — so a
    direct ``datasvc`` user can no longer leak leases and wedge later
    admissions. The release time is caller-supplied (``close(t=...)``)
    or defaults to the last simulated time the session observed
    (floored per dataset at its ``t_ready``: a lease cannot be returned
    before its replicas exist)."""
    service: StagingService
    session_id: str
    _t_last: float = field(default=0.0, repr=False, compare=False)

    def note(self, t: float) -> float:
        """Record `t` as the latest simulated time this session observed
        (the default :meth:`close` release time). Returns `t`."""
        if t > self._t_last:
            self._t_last = t
        return t

    def acquire(self, name: str, t: float) -> Lease:
        lease = self.service.acquire(self.session_id, name, t)
        self.note(lease.t_ready)
        return lease

    def release(self, name: str, t: float) -> None:
        self.service.release(self.session_id, name, self.note(t))

    def put_result(self, name: str, data: np.ndarray, t: float
                   ) -> Tuple[str, float]:
        path, t_done = self.service.put_result(self.session_id, name, data, t)
        return path, self.note(t_done)

    def flush(self, t: float, collective: bool = True
              ) -> Tuple[StagingReport, float]:
        rep, t_done = self.service.flush(self.session_id, t,
                                         collective=collective)
        return rep, self.note(t_done)

    def tag(self, task):
        """Stamp a `repro_torch.core.manytask.Task` with this session's id."""
        task.session = self.session_id
        return task

    def held(self) -> Dict[str, int]:
        """Dataset name -> lease count this session currently holds."""
        return {e.name: e.leases[self.session_id]
                for e in self.service.catalog
                if self.session_id in e.leases}

    def close(self, t: Optional[float] = None) -> None:
        """Release every lease this session still holds, at simulated
        time `t` (default: the last time this session observed), floored
        per dataset at its ``t_ready``. Idempotent."""
        t_close = self._t_last if t is None else self.note(t)
        for name, count in self.held().items():
            t_ds = max(t_close, self.service.catalog[name].t_ready)
            for _ in range(count):
                self.service.release(self.session_id, name, t_ds)

    def __enter__(self) -> "AnalysisSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
