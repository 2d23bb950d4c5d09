"""Simulated cluster fabric: shared filesystem, interconnect, node-local tiers.

The container is a single CPU process, so multi-host behaviour is reproduced
with a discrete-event model that moves REAL bytes (staging results are
byte-exact and testable) while accounting SIMULATED time against bandwidth
constants. Two calibrations ship:

  * ``BGQ``  — constants fit to the paper's measured aggregates (GPFS peak
    240 GB/s; ~22 GB/s effective for uncoordinated replicated reads — the
    naive path measured in Fig. 11; ~150 GB/s for coordinated disjoint-stripe
    collective reads; 5D-torus links).
  * ``TPU_POD`` — v5e-flavored: per-host NIC to object store, 50 GB/s/link
    ICI intra-pod, DCN across pods.

The key physical distinction the paper exploits:
  naive   — every node reads the FULL dataset from shared storage
            (aggregate bytes = P x size, uncoordinated -> congested rate)
  staged  — nodes read DISJOINT 1/P stripes (aggregate = 1 x size at
            sequential rate) and replicate over the interconnect.

Units, everywhere in this module: times are SIMULATED seconds (an
accounting clock advanced against the bandwidth constants — never wall
clock; only benchmark harnesses measure wall time), sizes are bytes,
bandwidths bytes/second, latencies seconds. Methods that model an I/O or
network operation take the caller's current simulated time ``t`` and
return the operation's completion time on the same clock.
"""
from __future__ import annotations

import fnmatch
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.collectives import CollectivePlan, CollectivePlanner
from repro_torch.core.compression import (Codec, CompressionLike, CompressionStats,
                                    resolve_codec)
from repro_torch.core.faults import FaultEvent, FaultKind, FaultSchedule
from repro_torch.core.telemetry import NULL_TRACER, TracerLike
from repro_torch.core.topology import FLAT, Topology, TopologyLike, resolve_topology


@dataclass
class FabricConstants:
    """Calibration constants for one simulated machine (all bandwidths in
    bytes/s, all latencies in seconds of simulated time)."""
    name: str
    fs_seq_bw: float          # coordinated (disjoint, striped) read bw, bytes/s
    fs_rand_bw: float         # uncoordinated/replicated read bw, bytes/s
    fs_md_latency: float      # metadata op latency (glob/stat), s
    fs_op_latency: float      # per-read-request latency, s
    coll_latency_base: float  # per-file collective-read sync overhead, s
    coll_latency_log: float   # + this * log2(P) (MPI collective scaling), s
    link_bw: float            # per-host interconnect link bw, bytes/s
    link_latency: float       # per-message latency, s
    local_bw: float           # node-local store WRITE bw, bytes/s
    local_read_bw: float      # per-process node-local READ bw, bytes/s


# Calibrated to the paper's measurements (§VI-B, Figs. 10/11):
#   naive 8192-node input = 210 s for 577 MB/node  -> 22.5 GB/s congested GPFS
#   staged Staging+Write  = ~36 s for 736 files    -> ~48 ms/file collective
#     overhead at P=8192  = base 5 ms + 3.3 ms * log2(8192)
#   Read phase 10.8 s for 577 MB                   -> 53.4 MB/s per-process
#     RAM-disk read (BG/Q /tmp is an I/O-node service)
BGQ = FabricConstants(
    name="bgq",
    fs_seq_bw=150e9, fs_rand_bw=22.5e9,
    fs_md_latency=1e-3, fs_op_latency=5e-3,
    coll_latency_base=5e-3, coll_latency_log=3.3e-3,
    link_bw=2e9, link_latency=2.5e-6,
    local_bw=4e9, local_read_bw=53.4e6,
)

# v5e-pod flavored: object store over per-host NICs, ICI links, host RAM tier
TPU_POD = FabricConstants(
    name="tpu_pod",
    fs_seq_bw=200e9, fs_rand_bw=30e9,
    fs_md_latency=5e-4, fs_op_latency=1e-3,
    coll_latency_base=1e-3, coll_latency_log=2e-4,
    link_bw=50e9, link_latency=1e-6,
    local_bw=100e9, local_read_bw=10e9,
)


def pin_ref(pins: Dict[str, int], path: str) -> None:
    """Add one pin reference to `path` in the refcount map `pins` — the
    shared idiom behind :meth:`NodeLocalStore.pin`, ``StreamStager.pin``
    and ``TaskInputCache.pin`` (one implementation, one semantics)."""
    pins[path] = pins.get(path, 0) + 1


def unpin_ref(pins: Dict[str, int], path: str) -> bool:
    """Drop one pin reference on `path`; returns True if the caller held
    one (False = no-op — `path` was not pinned in `pins`). The entry
    leaves the map when the last holder unpins."""
    count = pins.get(path, 0)
    if count == 0:
        return False
    if count == 1:
        del pins[path]
    else:
        pins[path] = count - 1
    return True


@dataclass
class SharedFilesystem:
    """Bandwidth-accounted shared parallel filesystem (GPFS stand-in)."""
    constants: FabricConstants
    files: Dict[str, np.ndarray] = field(default_factory=dict)
    busy_until: float = 0.0           # shared-resource serialization point
    busy_time: float = 0.0            # total seconds of bandwidth occupancy
    wait_time: float = 0.0            # total seconds requests queued behind
    #                                   earlier traffic (the contention signal
    #                                   concurrent sessions produce)
    bytes_read: int = 0
    read_requests: int = 0
    bytes_written: int = 0            # time-accounted writes (write-back path)
    write_requests: int = 0
    metadata_ops: int = 0
    tracer: TracerLike = NULL_TRACER  # shared via Fabric.attach_tracer

    def _occupy(self, t: float, seconds: float, op: str = "io") -> float:
        """Claim `seconds` of the shared busy stream for a request issued
        at `t`; returns the start time (``max(t, busy_until)``). All
        occupancy/wait accounting funnels through here — and so does all
        FS telemetry: one ``fs.<op>`` busy span per request plus an
        ``fs.wait`` span when it queued behind earlier traffic."""
        start = max(t, self.busy_until)
        self.wait_time += start - t
        self.busy_until = start + seconds
        self.busy_time += seconds
        tr = self.tracer
        if tr.enabled:
            if start > t:
                tr.span("fs.wait", t, start, track="fs", op=op)
                tr.metrics.counter("fs.contention_waits").inc()
                tr.metrics.histogram("fs.wait_s").observe(start - t)
            tr.span(f"fs.{op}", start, start + seconds, track="fs")
        return start

    def put(self, path: str, data: np.ndarray) -> None:
        """Install `data` (any dtype, flattened to uint8) at `path`.
        Producer-side writes are not time-accounted — the model charges
        reads, which is where the paper's contention lives."""
        self.files[path] = np.ascontiguousarray(data).view(np.uint8).ravel()

    def size(self, path: str) -> int:
        """File size in bytes (no metadata latency charged)."""
        return int(self.files[path].size)

    def glob(self, pattern: str, t: float) -> Tuple[List[str], float]:
        """Resolve `pattern` (fnmatch) at simulated time `t`.

        Returns ``(sorted matches, completion time)``; charges one
        ``fs_md_latency`` scaled by directory size per scan, serialized on
        the shared-FS busy stream like any other request."""
        self.metadata_ops += 1
        names = sorted(n for n in self.files if fnmatch.fnmatch(n, pattern))
        self._occupy(t, self.constants.fs_md_latency * (1 + len(names) / 64),
                     op="metadata")
        return names, self.busy_until

    def read(self, path: str, offset: int, size: int, t: float,
             coordinated: bool) -> Tuple[np.ndarray, float]:
        """Read `size` bytes at `offset` from `path`, issued at simulated
        time `t`. Returns ``(zero-copy view of the bytes, completion t)``.

        `coordinated` selects the bandwidth regime: disjoint-stripe
        collective reads stream at ``fs_seq_bw``; uncoordinated
        full-replica reads contend at ``fs_rand_bw``.

        The FS is a shared resource: bandwidth serializes (busy_until),
        request latencies overlap (charged to the caller's completion time
        only) — concurrent requests from many hosts each pay one latency.
        """
        bw = (self.constants.fs_seq_bw if coordinated
              else self.constants.fs_rand_bw)
        self._occupy(t, size / bw, op="read")
        t_done = self.busy_until + self.constants.fs_op_latency
        self.bytes_read += size
        self.read_requests += 1
        return self.files[path][offset:offset + size], t_done

    def read_striped(self, path: str, stripes: List[Tuple[int, int]],
                     t: float, coordinated: bool = True
                     ) -> Tuple[np.ndarray, float]:
        """Batched form of P concurrent disjoint-stripe reads issued at `t`.

        Time-model equivalent to calling :meth:`read` once per stripe (the FS
        serializes bandwidth; per-request latencies overlap, so completion is
        last-byte time + one latency) but with O(1) Python cost — the staging
        hot path at P=1024+ hosts. Returns a zero-copy view spanning the
        stripes' covered byte range. An EMPTY stripe list (degenerate P
        slicing) is a true no-op: nothing read, no latency charged, the
        busy stream untouched.
        """
        if not stripes:
            return self.files[path][:0], t
        total = sum(sz for _, sz in stripes)
        bw = (self.constants.fs_seq_bw if coordinated
              else self.constants.fs_rand_bw)
        self._occupy(t, total / bw, op="read")
        t_done = self.busy_until + self.constants.fs_op_latency
        self.bytes_read += total
        self.read_requests += len(stripes)
        lo = min((off for off, _ in stripes), default=0)
        hi = max((off + sz for off, sz in stripes), default=0)
        return self.files[path][lo:hi], t_done

    def write(self, path: str, data: np.ndarray, t: float,
              coordinated: bool = False) -> float:
        """Time-accounted write of `data` (any dtype, flattened to uint8)
        to `path`, issued at simulated time `t`. Returns the completion
        time. Unlike :meth:`put` (the un-accounted producer-side install),
        this is the WRITE-BACK path: analysis results flushed to the
        shared FS pay bandwidth and latency like any read.

        `coordinated` selects the regime exactly as for reads: disjoint
        collective stripes stream at ``fs_seq_bw``; uncoordinated
        full-replica writes contend at ``fs_rand_bw``. Bandwidth
        serializes on the shared busy stream; the per-request latency
        overlaps (charged to this caller's completion only).
        """
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        bw = (self.constants.fs_seq_bw if coordinated
              else self.constants.fs_rand_bw)
        self._occupy(t, buf.size / bw, op="write")
        t_done = self.busy_until + self.constants.fs_op_latency
        self.files[path] = buf
        self.bytes_written += buf.size
        self.write_requests += 1
        return t_done

    def write_gather(self, path: str, data: np.ndarray,
                     stripes: List[Tuple[int, int]], t: float,
                     coordinated: bool = True) -> float:
        """Batched form of P concurrent disjoint-stripe writes issued at
        `t` — the data-gather + write half of a two-phase
        ``MPI_File_write_all`` (the write-back mirror of
        :meth:`read_striped`). Time-model equivalent to one :meth:`write`
        per stripe (bandwidth serializes, per-request latencies overlap)
        at O(1) Python cost; the file's final content is installed whole.
        Returns the completion time of the last stripe. An EMPTY stripe
        list (degenerate P slicing) is a true no-op: nothing written or
        installed, no latency charged, the busy stream untouched.
        """
        if not stripes:
            return t
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        total = sum(sz for _, sz in stripes)
        bw = (self.constants.fs_seq_bw if coordinated
              else self.constants.fs_rand_bw)
        self._occupy(t, total / bw, op="write")
        t_done = self.busy_until + self.constants.fs_op_latency
        self.files[path] = buf
        self.bytes_written += total
        self.write_requests += len(stripes)
        return t_done


@dataclass
class Interconnect:
    """Topology-aware interconnect: executes planned collectives.

    The algorithms live in `repro_torch.core.collectives.CollectivePlanner`,
    bound to this fabric's `repro_torch.core.topology.Topology` (default:
    :data:`~repro_torch.core.topology.FLAT`, which pins the legacy ring
    algorithms and inherits the calibration's link constants — bit-for-bit
    the pre-topology accounting). Methods return the DURATION (simulated
    s) of one collective/message and account the wire traffic in
    ``bytes_moved`` (total) and ``tier_bytes`` (per topology tier);
    callers place the duration on their own timeline (collectives from
    disjoint host groups may overlap, so there is no global busy stream
    here).

    ``faults`` is the fabric's `repro_torch.core.faults.FaultSchedule`; when it
    is non-trivial, collectives issued at simulated time ``t`` (the new
    optional ``t=`` argument; default ``now``, the fault clock advanced by
    ``Fabric.advance_faults``) are planned over the LIVE host set with
    ring/tree re-routing latency for the dead, under per-tier degraded
    bandwidth. A trivial (empty) schedule takes the exact pre-fault code
    path — bit-exact zero-fault accounting.

    ``codec`` is the bound compression codec (`repro_torch.core.compression`):
    every collective planned here passes it to the planner, which elects
    compress-at-source per tier. ``None`` (the default) is the identity —
    the exact pre-compression code path. ``bytes_moved``/``tier_bytes``
    always count WIRE bytes; ``comp`` accumulates the payload-vs-wire
    split over plans that elected at least one tier."""
    constants: FabricConstants
    topology: Topology = FLAT
    bytes_moved: int = 0
    tier_bytes: Dict[str, int] = field(default_factory=dict)
    faults: Optional[FaultSchedule] = None
    now: float = 0.0                  # fault clock (advance_faults)
    tracer: TracerLike = NULL_TRACER  # shared via Fabric.attach_tracer
    codec: Optional[Codec] = None     # bound via scoped_codec / configs
    comp: CompressionStats = field(default_factory=CompressionStats)

    def __post_init__(self) -> None:
        self._planner = CollectivePlanner(self.topology, self.constants)

    # -- topology binding ---------------------------------------------------
    @property
    def planner(self) -> CollectivePlanner:
        """The collective planner bound to the current topology — use its
        ``plan_*`` methods for PURE cost queries (no traffic accounted).
        Rebuilt whenever ``topology`` changes, so assigning the field
        directly is as good as :meth:`set_topology`."""
        if self._planner.topology is not self.topology:
            self._planner = CollectivePlanner(self.topology, self.constants)
        return self._planner

    def set_topology(self, topology: TopologyLike) -> None:
        """Rebind the interconnect to `topology` (any loose spelling —
        name, config, or instance). Traffic counters are kept; tier names
        from the previous topology remain in ``tier_bytes``."""
        self.topology = resolve_topology(topology)

    @contextmanager
    def scoped_topology(self, topology: TopologyLike) -> Iterator[None]:
        """Temporarily rebind to `topology` for one staging operation
        (how a per-call ``TopologyConfig`` on an engine config takes
        effect); ``None`` keeps the current binding — a no-op."""
        if topology is None:
            yield
            return
        prev = self.topology
        self.set_topology(topology)
        try:
            yield
        finally:
            self.topology = prev

    # -- compression binding ------------------------------------------------
    @contextmanager
    def scoped_codec(self, compression: CompressionLike) -> Iterator[None]:
        """Temporarily bind a codec for one staging operation (how a
        per-call ``CompressionConfig`` on an engine config takes effect).
        Accepts any loose spelling (name, config, codec); ``None`` keeps
        the current binding — a no-op, the bit-exact identity path."""
        if compression is None:
            yield
            return
        prev = self.codec
        self.codec = resolve_codec(compression)
        try:
            yield
        finally:
            self.codec = prev

    def comp_snapshot(self) -> CompressionStats:
        """Copy of the codec accounting (pair with :meth:`comp_delta`)."""
        return self.comp.copy()

    def comp_delta(self, snapshot: CompressionStats) -> CompressionStats:
        """Codec accounting accumulated since `snapshot`."""
        return self.comp.delta(snapshot)

    # -- fault awareness ----------------------------------------------------
    @contextmanager
    def scoped_faults(self, faults: Optional[FaultSchedule]
                      ) -> Iterator[None]:
        """Temporarily bind `faults` for one staging operation (how a
        per-call ``FaultConfig`` on an engine config takes effect);
        ``None`` keeps the current binding — a no-op."""
        if faults is None:
            yield
            return
        prev = self.faults
        self.faults = faults
        try:
            yield
        finally:
            self.faults = prev

    def _fault_state(self, t: Optional[float], n_hosts: int
                     ) -> Tuple[CollectivePlanner, int]:
        """``(planner, dead)`` for a collective over `n_hosts` issued at
        `t`: the planner carries any degraded tier scales active at `t`
        and `dead` counts schedule members to re-route around. The
        trivial schedule returns the bound planner untouched — the exact
        pre-fault path."""
        sched = self.faults
        if sched is None or sched.trivial:
            return self.planner, 0
        tq = self.now if t is None else t
        dead = min(sched.n_dead(tq, n_hosts), max(n_hosts - 1, 0))
        factors = sched.tier_factors(self.topology.tier_names(), tq)
        planner = self.planner
        if factors:
            planner = CollectivePlanner(self.topology.degraded(factors),
                                        self.constants)
        return planner, dead

    # -- execution: plan + account ------------------------------------------
    def execute(self, plan: CollectivePlan) -> float:
        """Account `plan`'s wire traffic and return its duration."""
        for tier, nbytes in plan.tier_bytes.items():
            self.tier_bytes[tier] = self.tier_bytes.get(tier, 0) + nbytes
        self.bytes_moved += plan.total_bytes
        if plan.compressed_tiers:
            self.comp.plans += 1
            self.comp.payload_bytes += plan.payload_bytes
            self.comp.wire_bytes += plan.total_bytes
            self.comp.compress_time += plan.compress_time
            self.comp.decompress_time += plan.decompress_time
        return plan.time

    def _execute_traced(self, plan: CollectivePlan,
                        t: Optional[float]) -> float:
        """:meth:`execute` plus telemetry: one ``collective.<op>`` span
        over ``[t, t + duration)`` with per-tier child spans partitioning
        the interval proportional to each tier's wire bytes, a per-tier
        bandwidth-utilization gauge series, and a duration histogram
        observation. The recorded times are the ones :meth:`execute`
        already computed — tracing never changes the arithmetic."""
        dt = self.execute(plan)
        tr = self.tracer
        if tr.enabled:
            t0 = self.now if t is None else t
            sp = tr.span(f"collective.{plan.op}", t0, t0 + dt, track="net",
                         algorithm=plan.algorithm, nbytes=plan.nbytes,
                         n_hosts=plan.n_hosts, rerouted=plan.rerouted,
                         wire_bytes=plan.total_bytes, codec=plan.codec)
            # codec edges bracket the wire interval: compress at the
            # sending edge before the first byte, decompress at the
            # receiving edge after the last (both 0.0 without a codec —
            # the tier partition below is then exactly the legacy one)
            t_wire = t0 + plan.compress_time
            wire_dt = dt - plan.compress_time - plan.decompress_time
            if plan.compressed_tiers:
                if plan.compress_time > 0:
                    tr.span("comp.compress", t0, t_wire, track="net",
                            parent=sp, codec=plan.codec,
                            payload_bytes=plan.payload_bytes)
                if plan.decompress_time > 0:
                    tr.span("comp.decompress", t0 + dt - plan.decompress_time,
                            t0 + dt, track="net", parent=sp,
                            codec=plan.codec,
                            payload_bytes=plan.payload_bytes)
                tr.metrics.counter("comp.plans").inc()
                tr.metrics.counter("comp.payload_bytes").inc(
                    plan.payload_bytes)
                tr.metrics.counter("comp.wire_bytes").inc(plan.total_bytes)
                tr.metrics.counter("comp.bytes_saved").inc(plan.bytes_saved)
            total = plan.total_bytes
            if wire_dt > 0 and total > 0:
                tcur = t_wire
                for tier in sorted(plan.tier_bytes):
                    nb = plan.tier_bytes[tier]
                    share = wire_dt * (nb / total)
                    tr.span(f"tier.{tier}", tcur, tcur + share,
                            track=f"net/{tier}", parent=sp, nbytes=nb)
                    gauge = tr.metrics.gauge(f"net.bw.{tier}")
                    gauge.record(tcur, nb / share if share > 0 else 0.0)
                    gauge.record(tcur + share, 0.0)
                    tcur += share
            tr.metrics.histogram("collective.duration_s").observe(dt)
            tr.metrics.counter(f"collective.{plan.op}").inc()
        return dt

    def tier_snapshot(self) -> Dict[str, int]:
        """Copy of the per-tier counters (pair with :meth:`tier_delta`)."""
        return dict(self.tier_bytes)

    def tier_delta(self, snapshot: Dict[str, int]) -> Dict[str, int]:
        """Per-tier bytes moved since `snapshot` (zero deltas dropped)."""
        return {k: v - snapshot.get(k, 0) for k, v in self.tier_bytes.items()
                if v - snapshot.get(k, 0)}

    def broadcast(self, nbytes: int, n_hosts: int,
                  algorithm: Optional[str] = None,
                  t: Optional[float] = None) -> float:
        """Duration (s) of a one-root broadcast of `nbytes` to `n_hosts`
        hosts, planned over the bound topology (algorithm selected by the
        cost model unless pinned or given). `t` is the issue time consulted
        against the fault schedule (default: the fault clock ``now``)."""
        planner, dead = self._fault_state(t, n_hosts)
        return self._execute_traced(
            planner.plan_broadcast(nbytes, n_hosts - dead, algorithm,
                                   dead=dead, codec=self.codec), t)

    def allgather(self, shard_bytes: int, n_hosts: int,
                  algorithm: Optional[str] = None,
                  t: Optional[float] = None) -> float:
        """Duration (s) of an all-gather where each of `n_hosts` hosts
        contributes `shard_bytes`, planned over the bound topology (dead
        hosts at issue time `t` are re-routed around)."""
        planner, dead = self._fault_state(t, n_hosts)
        return self._execute_traced(
            planner.plan_allgather(shard_bytes, n_hosts - dead, algorithm,
                                   dead=dead, codec=self.codec), t)

    def scatter(self, total_bytes: int, n_hosts: int,
                algorithm: Optional[str] = None,
                t: Optional[float] = None) -> float:
        """Duration (s) of a root scatter of `total_bytes` into 1/P
        shards, planned over the bound topology (dead hosts at issue time
        `t` are re-routed around)."""
        planner, dead = self._fault_state(t, n_hosts)
        return self._execute_traced(
            planner.plan_scatter(total_bytes, n_hosts - dead, algorithm,
                                 dead=dead, codec=self.codec), t)

    def replichain(self, stripe_bytes: int, n_hosts: int, replication: int,
                   t: Optional[float] = None) -> float:
        """Duration (s) of R-way chained stripe replication (the comm
        phase of ``stage_replicated``); degraded tiers at `t` apply."""
        planner, _ = self._fault_state(t, n_hosts)
        return self._execute_traced(
            planner.plan_replichain(stripe_bytes, n_hosts, replication,
                                    codec=self.codec), t)

    def repair(self, transfers: List[Tuple[int, int, int]], n_hosts: int,
               t: Optional[float] = None) -> float:
        """Duration (s) of an explicit point-to-point repair schedule
        (``[(src, dst, nbytes), ...]``; see
        `repro_torch.core.collectives.CollectivePlanner.plan_repair`)."""
        planner, _ = self._fault_state(t, n_hosts)
        return self._execute_traced(planner.plan_repair(transfers, n_hosts),
                                    t)

    def point_to_point(self, nbytes: int, t: Optional[float] = None,
                       attempts: int = 1) -> CollectivePlan:
        """Execute one `nbytes` off-machine ingest message and return the
        EXECUTED plan (duration in ``.time``, wire bytes in
        ``.tier_bytes``/``.total_bytes``) — the form
        `repro_torch.core.wan.WanFanout` needs, since with a bound codec the
        retransmitted wire bytes are the COMPRESSED size, not
        ``attempts * nbytes``."""
        planner, _ = self._fault_state(t, 1)
        plan = planner.plan_point_to_point(nbytes, attempts=attempts,
                                           codec=self.codec)
        self._execute_traced(plan, t)
        return plan

    def point_to_point_time(self, nbytes: int, t: Optional[float] = None,
                            attempts: int = 1) -> float:
        """Duration (s) of one `nbytes` off-machine message (the
        detector->leader ingest hop in `repro_torch.core.streaming`), charged
        to the topology's ingest tier (degraded at `t` if scheduled).
        `attempts` > 1 replays the hop that many times — the WAN
        retransmission model (`repro_torch.core.wan`); time and ingest-tier
        bytes scale together."""
        return self.point_to_point(nbytes, t=t, attempts=attempts).time

    # -- deprecated aliases (pre-topology names) ----------------------------
    def ring_allgather_time(self, shard_bytes: int, n_hosts: int) -> float:
        """Deprecated alias of :meth:`allgather` (the algorithm is now
        planned, not hardwired to the ring)."""
        warnings.warn(
            "Interconnect.ring_allgather_time is a deprecated pre-topology "
            "alias; call Interconnect.allgather, which routes through the "
            "CollectivePlanner (see docs/architecture.md)",
            DeprecationWarning, stacklevel=2)
        return self.allgather(shard_bytes, n_hosts)

    def broadcast_time(self, nbytes: int, n_hosts: int) -> float:
        """Deprecated alias of :meth:`broadcast`."""
        warnings.warn(
            "Interconnect.broadcast_time is a deprecated pre-topology "
            "alias; call Interconnect.broadcast, which routes through the "
            "CollectivePlanner (see docs/architecture.md)",
            DeprecationWarning, stacklevel=2)
        return self.broadcast(nbytes, n_hosts)


@dataclass
class NodeLocalStore:
    """Node-local storage tier (BG/Q RAM disk /tmp; TPU host RAM).

    Holds zero-copy read-only views delivered by the staging/streaming
    engines. Writes are charged at ``local_bw`` bytes/s of simulated time;
    reads are charged by the CONSUMER (``ManyTaskEngine._input_time`` /
    ``TaskInputCache``) at ``local_read_bw``, so :meth:`read` itself only
    counts hits/misses."""
    host_id: int
    constants: FabricConstants
    data: Dict[str, np.ndarray] = field(default_factory=dict)
    bytes_written: int = 0
    hits: int = 0
    misses: int = 0
    # pin REFCOUNTS: several holders (I/O-hook directives, stream pins,
    # dataset-service leases) may pin the same path; it stays exempt from
    # eviction until every holder unpins. Membership tests (`p in pinned`)
    # behave as the former set.
    pinned: Dict[str, int] = field(default_factory=dict)

    def write(self, path: str, data: np.ndarray, t: float) -> float:
        """Store `data` (uint8 buffer/view) at `path`, starting at
        simulated time `t`; returns the write completion time
        (``t + bytes / local_bw``)."""
        self.data[path] = data
        self.bytes_written += data.size
        return t + data.size / self.constants.local_bw

    def write_many(self, replicas: Dict[str, np.ndarray], t: float) -> float:
        """Bulk replica delivery (one dict merge, no per-file Python loop).
        Same time/byte accounting as sequential :meth:`write` calls — writes
        to one node-local store serialize on its bandwidth."""
        self.data.update(replicas)
        nbytes = sum(v.size for v in replicas.values())
        self.bytes_written += nbytes
        return t + nbytes / self.constants.local_bw

    def read(self, path: str) -> Optional[np.ndarray]:
        """The stored buffer, or None on miss. No time is charged here —
        see the class docstring for who pays ``local_read_bw``.

        A hit TOUCHES the entry (moved to most-recently-used), so
        :meth:`evict_lru` sees true access recency, not insertion order —
        a hot-but-old entry is no longer the first eviction victim."""
        if path in self.data:
            self.hits += 1
            val = self.data.pop(path)   # re-insert: dict order = LRU order
            self.data[path] = val
            return val
        self.misses += 1
        return None

    def pin(self, path: str) -> None:
        """Exempt `path` from eviction (human-in-the-loop reuse, §VI-B).
        Pins are refcounted: each :meth:`pin` needs a matching
        :meth:`unpin` before the entry becomes evictable again."""
        pin_ref(self.pinned, path)

    def unpin(self, path: str) -> None:
        """Drop one pin reference on `path` (lease release); the entry
        becomes evictable once the last holder unpins. Unpinning a path
        that is not pinned is a no-op (the holder may have been evicted
        through `drop`, which clears pins)."""
        unpin_ref(self.pinned, path)

    def drop(self, path: str) -> None:
        """Evict `path` if present. Pure bookkeeping — eviction frees
        memory, it is not an I/O, so no simulated time is charged. Any
        pin refs go with the entry (a forced drop must not leave stale
        pins that would shield a later re-staged copy)."""
        self.data.pop(path, None)
        self.pinned.pop(path, None)

    def wipe(self) -> None:
        """Lose EVERYTHING — the host died (`repro_torch.core.faults`). All
        resident data and every pin ref go at once; counters survive
        (they describe history, not state). No simulated time charged:
        node RAM vanishes, it is not drained."""
        self.data.clear()
        self.pinned.clear()

    def evict_lru(self, budget_bytes: int) -> None:
        """Drop unpinned entries in true LRU order (reads re-insert at
        the MRU end — see :meth:`read`) until resident bytes fit
        `budget_bytes`. No simulated time charged."""
        total = sum(v.size for v in self.data.values())
        for path in list(self.data):
            if total <= budget_bytes:
                break
            if path in self.pinned:
                continue
            total -= self.data[path].size
            del self.data[path]


@dataclass
class Host:
    host_id: int
    n_ranks: int
    store: NodeLocalStore

    def leader_rank(self) -> int:
        """The paper's leader communicator: exactly one I/O rank per host."""
        return self.host_id * self.n_ranks


class Fabric:
    """A simulated cluster: P hosts x R ranks, shared FS, interconnect.

    `topology` shapes the interconnect (any loose spelling — a
    `repro_torch.core.topology.Topology`, a ``TopologyConfig``, or a canned
    name like ``"bgq_torus"``); the default ``None`` is the FLAT
    backward-compat machine.

    `faults` is the fabric's fault timeline (`repro_torch.core.faults`); the
    default is the TRIVIAL empty schedule, which keeps every code path
    bit-exact with the pre-fault model. State-changing events (a host
    death wipes its node-local store) apply when the simulation clock is
    advanced past them via :meth:`advance_faults`; timing effects
    (degraded tiers, dead-host re-routing) apply per-collective at the
    issue time passed to the `Interconnect` methods."""

    def __init__(self, n_hosts: int, ranks_per_host: int = 16,
                 constants: FabricConstants = BGQ,
                 topology: TopologyLike = None,
                 faults: Optional[FaultSchedule] = None):
        self.constants = constants
        self.fs = SharedFilesystem(constants)
        self.net = Interconnect(constants,
                                topology=resolve_topology(topology),
                                faults=(faults if faults is not None
                                        else FaultSchedule()))
        self.hosts = [Host(i, ranks_per_host,
                           NodeLocalStore(i, constants))
                      for i in range(n_hosts)]
        self._ranks_per_host = ranks_per_host
        self._faults_applied: set = set()
        self.tracer: TracerLike = NULL_TRACER

    def attach_tracer(self, tracer: TracerLike) -> TracerLike:
        """Bind `tracer` to the fabric and every layer that records into
        it (shared FS, interconnect) — how ``StagingClient(trace=...)``
        and the benchmarks turn telemetry on. Pass
        :data:`~repro_torch.core.telemetry.NULL_TRACER` to turn it back off;
        either way the simulated-time arithmetic is untouched."""
        self.tracer = tracer
        self.fs.tracer = tracer
        self.net.tracer = tracer
        return tracer

    @property
    def faults(self) -> FaultSchedule:
        """The fault timeline in effect — the `Interconnect` binding, so
        a per-stage ``scoped_faults`` overlay is visible to everything
        that asks the fabric (live-host selection in the staging engines,
        catalog transitions), not just to collective timing."""
        return self.net.faults

    @faults.setter
    def faults(self, sched: FaultSchedule) -> None:
        self.net.faults = sched

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def n_ranks(self) -> int:
        return sum(h.n_ranks for h in self.hosts)

    def leader_hosts(self) -> List[Host]:
        return self.hosts

    # -- fault injection ----------------------------------------------------
    def advance_faults(self, t: float) -> List[FaultEvent]:
        """Advance the fault clock to simulated time `t`, applying every
        not-yet-applied event at or before `t` in timeline order (a host
        death wipes that host's node-local store, pins included; a
        recovery brings the host back BLANK). Returns the events applied
        by THIS call — `repro_torch.core.datasvc.StagingService.sync_faults`
        turns them into catalog transitions."""
        applied: List[FaultEvent] = []
        for ev in self.faults.events:
            if ev.t > t:
                break
            key = (ev.t, ev.kind, ev.host, ev.tier, ev.t_end, ev.factor)
            if key in self._faults_applied:
                continue
            self._faults_applied.add(key)
            if (ev.kind is FaultKind.HOST_DEATH
                    and ev.host < len(self.hosts)):
                self.hosts[ev.host].store.wipe()
            applied.append(ev)
        self.net.now = max(self.net.now, t)
        return applied

    def kill_host(self, host: int, t: float) -> FaultEvent:
        """Inject a host death at simulated time `t` and apply it now."""
        ev = self.faults.inject(FaultEvent(t, FaultKind.HOST_DEATH,
                                           host=host))
        self.advance_faults(t)
        return ev

    def recover_host(self, host: int, t: float) -> FaultEvent:
        """Inject a host recovery (blank store) at `t` and apply it."""
        ev = self.faults.inject(FaultEvent(t, FaultKind.HOST_RECOVERY,
                                           host=host))
        self.advance_faults(t)
        return ev

    def degrade_tier(self, tier: str, t: float, t_end: float,
                     factor: float) -> FaultEvent:
        """Inject a link-tier degradation window ``[t, t_end)`` running at
        ``factor`` of healthy bandwidth."""
        ev = self.faults.inject(FaultEvent(t, FaultKind.LINK_DEGRADE,
                                           tier=tier, t_end=t_end,
                                           factor=factor))
        self.advance_faults(self.net.now)
        return ev

    def dead_ids(self, t: Optional[float] = None) -> List[int]:
        """Host ids dead at `t` (default: the fault clock ``now``)."""
        tq = self.net.now if t is None else t
        return sorted(h for h in self.faults.dead_hosts(tq)
                      if h < len(self.hosts))

    def live_ids(self, t: Optional[float] = None) -> List[int]:
        """Host ids alive at `t` (default: the fault clock ``now``)."""
        dead = set(self.dead_ids(t))
        return [h.host_id for h in self.hosts if h.host_id not in dead]

    def live_hosts(self, t: Optional[float] = None) -> List[Host]:
        """The :class:`Host` objects alive at `t`."""
        dead = set(self.dead_ids(t))
        return [h for h in self.hosts if h.host_id not in dead]

    # -- elasticity ---------------------------------------------------------
    def resize(self, n_hosts: int) -> List[int]:
        """Elastically grow or shrink the fabric to `n_hosts` hosts
        mid-campaign. Growing appends BLANK hosts (ids continue the
        sequence); shrinking removes the highest-id hosts and their
        node-local replicas with them. Returns the affected host ids.
        The catalog-level consequences (grown hosts lack replicas;
        shrunk hosts take redundancy with them) are handled by
        `repro_torch.core.datasvc.StagingService.resize`."""
        if n_hosts < 1:
            raise ValueError(f"cannot resize to {n_hosts} hosts")
        old = len(self.hosts)
        if n_hosts > old:
            self.hosts.extend(
                Host(i, self._ranks_per_host,
                     NodeLocalStore(i, self.constants))
                for i in range(old, n_hosts))
            return list(range(old, n_hosts))
        removed = list(range(n_hosts, old))
        del self.hosts[n_hosts:]
        return removed
