"""Collective data staging — the paper's key contribution, both fabrics.

Host-level (``stage_collective`` / ``stage_pipelined`` / ``stage_naive``):
the MPI-IO ``MPI_File_read_all`` two-phase pattern over the simulated fabric.
Leaders read disjoint 1/P stripes (aggregate FS traffic = 1x the dataset, at
the coordinated sequential rate), then a planned all-gather (algorithm
selected by the fabric topology's `repro_torch.core.collectives` planner — the
legacy ring on the FLAT machine) replicates stripes to every node-local
store. The naive baseline has every host read the full dataset
uncoordinated — the paper's measured 21 GB/s vs 101 GB/s regime. Every
engine takes ``topology=`` (any `repro_torch.core.topology` spelling) to rebind
the machine model for that call; reports carry per-tier wire traffic.
``stage_pipelined`` chunks the two phases and overlaps stripe reads with
all-gather segments (double-buffered two-phase I/O), hiding most of the FS
read time behind the interconnect.

Replica delivery is zero-copy: a staged file's stripes are contiguous, so
the assembled replica IS the source buffer — every ``NodeLocalStore``
receives one shared read-only view instead of P concatenated copies. The
simulated-time accounting (per-host write bandwidth) is unchanged; only the
real memory traffic of the simulator goes away.

Device-level (``device_replicate`` / ``device_shard`` / ``staged_restore``):
the same algorithm over a ``torch.distributed`` ``DeviceMesh`` (NCCL on the
card, gloo on the CPU). Each rank contributes its 1/P shard; one
``all_gather_into_tensor`` over the axis's group replicates it; held to
the reference on a gloo group of 4 ranks.

All modes byte-exact: tests assert staged replicas equal the source.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.compression import CompressionLike, CompressionStats
from repro_torch.core.fabric import Fabric
from repro_torch.core.topology import TopologyLike
from repro_torch.distributed.sharding import placements


@dataclass
class StagingReport:
    """Timing/traffic accounting for one staging operation (one dataset)."""
    n_hosts: int
    total_bytes: int              # dataset bytes (pre-replication)
    stage_time: float = 0.0       # FS read phase (simulated s)
    comm_time: float = 0.0        # interconnect replication phase (exposed)
    write_time: float = 0.0       # node-local write phase
    broadcast_time: float = 0.0   # leader metadata-broadcast (on_root) phase
    fs_bytes: int = 0             # bytes actually read from shared FS
    fs_write_bytes: int = 0       # bytes written BACK to shared FS (stage_out)
    net_bytes: int = 0            # WIRE bytes moved on the interconnect
    # interconnect WIRE bytes per topology tier (e.g. {"torus": ...,
    # "optical": ...}; FLAT reports everything under "link") — sums to
    # net_bytes. With an active codec the wire count on elected tiers is
    # the COMPRESSED traffic; `comp` carries the payload-vs-wire split
    # (total_bytes/delivered bytes stay logical — payload — quantities).
    tier_bytes: Dict[str, int] = field(default_factory=dict)
    mode: str = "collective"      # collective|pipelined|naive|stream|stage_out
    n_chunks: int = 0             # pipelined: total all-gather segments
    overlap_saved: float = 0.0    # pipelined: phase time hidden by overlap
    # replicated engine / repair collectives: where the stripes live
    placement: Optional["ReplicaPlacement"] = None
    # codec accounting over the plans this stage executed (zero when no
    # codec was bound or no tier elected compression)
    comp: CompressionStats = field(default_factory=CompressionStats)

    @property
    def total_time(self) -> float:
        return (self.stage_time + self.comm_time + self.write_time
                + self.broadcast_time)

    @property
    def delivered_bandwidth(self) -> float:
        """Aggregate delivery rate: replicated bytes / time (Fig. 10 metric)."""
        if self.total_time == 0:
            return 0.0
        return self.n_hosts * self.total_bytes / self.total_time


def _stripes(total: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous (offset, size) stripes covering [0, total)."""
    base, rem = divmod(total, parts)
    out, off = [], 0
    for i in range(parts):
        sz = base + (1 if i < rem else 0)
        out.append((off, sz))
        off += sz
    return out


class ReplicaLossError(RuntimeError):
    """Repair cannot proceed from surviving replicas alone (a full
    re-stage from the shared FS is the only way back to RESIDENT)."""


class LostStripesError(ReplicaLossError):
    """Every owner of at least one stripe is dead — the striped dataset
    has no complete copy left on the nodes."""


@dataclass
class ReplicaPlacement:
    """Which hosts own which stripe of a striped, R-way replicated
    dataset (the ``stage_replicated`` engine).

    Stripe ``i`` of every file lives on ``owners[i]`` under the store key
    :meth:`stripe_key`. The default layout is chained declustering
    (:meth:`chained`): stripe ``i`` on hosts ``i .. i+R-1`` (mod P), so
    any single host death leaves R-1 surviving owners per affected
    stripe. Mutable on purpose — ``re_replicate`` reassigns ownership
    when it copies a lost stripe to a new host."""
    replication: int
    owners: Dict[int, Tuple[int, ...]]    # stripe index -> owner hosts

    @classmethod
    def chained(cls, hosts: Sequence[int], replication: int
                ) -> "ReplicaPlacement":
        """Chained-declustering layout over `hosts` (one stripe each)."""
        L = len(hosts)
        if not 1 <= replication <= L:
            raise ValueError(
                f"replication must be in [1, n_hosts={L}], "
                f"got {replication}")
        return cls(replication=replication,
                   owners={i: tuple(hosts[(i + r) % L]
                                    for r in range(replication))
                           for i in range(L)})

    @staticmethod
    def stripe_key(path: str, stripe: int) -> str:
        """Node-local store key of one stripe of `path`."""
        return f"{path}::s{stripe}"

    @property
    def n_stripes(self) -> int:
        return len(self.owners)

    def hosts(self) -> Tuple[int, ...]:
        """Every host owning at least one stripe, sorted."""
        return tuple(sorted({o for own in self.owners.values()
                             for o in own}))

    def stripes_on(self, host: int) -> List[int]:
        return [i for i, own in self.owners.items() if host in own]

    def lost(self, live: Sequence[int]) -> List[int]:
        """Stripes with NO surviving owner among `live` (unrepairable
        from node memory)."""
        alive = set(live)
        return [i for i, own in sorted(self.owners.items())
                if not any(o in alive for o in own)]

    def degraded(self, live: Sequence[int]) -> List[int]:
        """Stripes that lost at least one (but not every) owner."""
        alive = set(live)
        return [i for i, own in sorted(self.owners.items())
                if any(o not in alive for o in own)
                and any(o in alive for o in own)]

    def covered_by(self, holders: Sequence[int]) -> bool:
        """True when every stripe has ALL its owners in `holders` —
        full R-way redundancy intact."""
        hold = set(holders)
        return all(all(o in hold for o in own)
                   for own in self.owners.values())


def readonly_view(data: np.ndarray) -> np.ndarray:
    """Zero-copy read-only view of ``data`` — the replica-delivery discipline.

    Every consumer (node-local store, streamed-frame cache) receives a view
    of ONE shared buffer instead of a copy; the write guard keeps a store
    from mutating the source through it. Shared by the batch staging engines
    here and the streaming ingest path (`repro_torch.core.streaming`).
    """
    view = data.view()
    view.setflags(write=False)
    return view


def _replica_view(fabric: Fabric, path: str) -> np.ndarray:
    """The assembled replica of a staged file, zero-copy.

    The P stripes of a file are contiguous and cover it exactly, so the
    reassembled replica is byte-identical to the source buffer: hand out one
    read-only view instead of materialising P (or even 1) concatenated
    copies. Read-only so a store cannot mutate the shared FS through it.
    """
    return readonly_view(fabric.fs.files[path])


def _deliver_replicas(fabric: Fabric, paths: Sequence[str],
                      t: Optional[float] = None) -> float:
    """Write one shared replica view per file to every LIVE node-local
    store (`t` is the delivery time consulted against the fault schedule;
    the trivial schedule delivers to every host — the pre-fault path).

    Hosts write in parallel (max across hosts); a host's files serialize on
    its local-store bandwidth (times ACCUMULATE across files — the seed took
    a max, undercounting multi-file staging).
    """
    replicas = {p: _replica_view(fabric, p) for p in paths}
    hosts = (fabric.hosts if fabric.faults.trivial
             else fabric.live_hosts(t))
    t_write = 0.0
    for host in hosts:
        t_write = max(t_write, host.store.write_many(replicas, 0.0))
    return t_write


# ---------------------------------------------------------------------------
# host-level staging (fabric)
# ---------------------------------------------------------------------------

def _coll_overhead(fabric: Fabric) -> float:
    """Per-file MPI_File_read_all sync overhead; grows ~log2(P)."""
    c = fabric.constants
    return c.coll_latency_base + c.coll_latency_log * max(
        0.0, math.log2(max(fabric.n_hosts, 2)))


def _close_stage_span(fabric: Fabric, sp, rep: StagingReport,
                      t0: float) -> None:
    """Finalize the engine-level telemetry span opened around one staging
    operation: sequential phase children partition ``[t0, t0+total_time)``
    exactly per the report's accounting identity (stage/comm/write/
    broadcast — so the flight recorder's critical-path breakdown sums to
    ``total_time`` by construction), report fields become span
    attributes, and the stage duration lands in the shared histogram.
    No-op on the disabled tracer; never changes the report."""
    tr = fabric.tracer
    if not tr.enabled:
        return
    read_phase = ("fs_write" if rep.mode.startswith("stage_out")
                  else "fs_read")
    t = t0
    for phase, dt in ((read_phase, rep.stage_time),
                      ("comm", rep.comm_time),
                      ("deliver", rep.write_time),
                      ("broadcast", rep.broadcast_time)):
        if dt > 0:
            tr.span(f"phase.{phase}", t, t + dt, track="engine", parent=sp)
        t += dt
    sp.t_end = t
    sp.attrs.update(n_hosts=rep.n_hosts, total_bytes=rep.total_bytes,
                    fs_bytes=rep.fs_bytes, fs_write_bytes=rep.fs_write_bytes,
                    net_bytes=rep.net_bytes, tier_bytes=dict(rep.tier_bytes))
    if rep.mode == "pipelined":
        sp.attrs.update(n_chunks=rep.n_chunks,
                        overlap_saved=rep.overlap_saved)
    tr.metrics.histogram("stage.total_s").observe(rep.total_time)
    tr.metrics.counter(f"stage.{rep.mode}").inc()


def stage_collective(fabric: Fabric, paths: Sequence[str], t0: float = 0.0,
                     topology: TopologyLike = None,
                     compression: CompressionLike = None
                     ) -> Tuple[StagingReport, float]:
    """MPI_File_read_all-style staging of `paths` to every node-local store.

    Phase 1 (Staging): leaders read disjoint stripes — coordinated.
    Phase 2 (Write):   planned all-gather + local write -> full replica per
    node (the algorithm comes from the fabric topology's collective
    planner; `topology` rebinds it for this call; `compression` binds a
    codec the planner may elect per tier). Returns (report, completion
    time).
    """
    with fabric.net.scoped_topology(topology), \
            fabric.net.scoped_codec(compression), \
            fabric.tracer.region("stage.collective", t0,
                                 track="engine") as tsp:
        P_ = fabric.n_hosts
        fs0 = fabric.fs.bytes_read
        net0 = fabric.net.bytes_moved
        tier0 = fabric.net.tier_snapshot()
        comp0 = fabric.net.comp_snapshot()
        total = sum(fabric.fs.size(p) for p in paths)
        rep = StagingReport(n_hosts=P_, total_bytes=total, mode="collective")

        coll_overhead = _coll_overhead(fabric)
        t_read_done = t0
        for path in paths:
            size = fabric.fs.size(path)
            # stripes are issued concurrently; FS serializes bandwidth only
            _, t_file = fabric.fs.read_striped(path, _stripes(size, P_), t0,
                                               coordinated=True)
            t_read_done = max(t_read_done, t_file) + coll_overhead
        rep.stage_time = t_read_done - t0

        # phase 2: all-gather of the (max) stripe, all hosts in parallel
        stripe_bytes = max(1, (total + P_ - 1) // P_)
        rep.comm_time = fabric.net.allgather(stripe_bytes, P_,
                                             t=t_read_done)

        rep.write_time = _deliver_replicas(fabric, paths,
                                           t=t_read_done + rep.comm_time)
        rep.fs_bytes = fabric.fs.bytes_read - fs0
        rep.net_bytes = fabric.net.bytes_moved - net0
        rep.tier_bytes = fabric.net.tier_delta(tier0)
        rep.comp = fabric.net.comp_delta(comp0)
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + rep.total_time


def stage_pipelined(fabric: Fabric, paths: Sequence[str], t0: float = 0.0,
                    chunk_bytes: int = 8 << 20,
                    topology: TopologyLike = None,
                    compression: CompressionLike = None
                    ) -> Tuple[StagingReport, float]:
    """Two-phase collective staging with chunked read/all-gather overlap.

    Each file's striped read is split into segments of ~``chunk_bytes`` per
    host; the all-gather of segment k (algorithm planned over the fabric
    topology, or `topology` for this call) runs while the leaders read
    segment k+1 (double-buffered two-phase I/O). The critical path is

        t_comm[k] = max(t_comm[k-1], t_read[k]) + allgather(seg_k)

    so all but the first segment's FS time hides behind the interconnect
    (or vice versa, whichever is slower). ``overlap_saved`` reports the
    serial-phase time hidden. Delivered replicas and FS byte accounting are
    identical to ``stage_collective``; ``net_bytes`` can exceed it by up to
    P * n_chunks bytes of per-segment ceil-rounding in the stripe sizes.
    """
    with fabric.net.scoped_topology(topology), \
            fabric.net.scoped_codec(compression), \
            fabric.tracer.region("stage.pipelined", t0,
                                 track="engine") as tsp:
        P_ = fabric.n_hosts
        fs0 = fabric.fs.bytes_read
        net0 = fabric.net.bytes_moved
        tier0 = fabric.net.tier_snapshot()
        comp0 = fabric.net.comp_snapshot()
        total = sum(fabric.fs.size(p) for p in paths)
        rep = StagingReport(n_hosts=P_, total_bytes=total, mode="pipelined")

        coll_overhead = _coll_overhead(fabric)
        t_read_done = t0     # leader read stream completion (incl. sync)
        t_comm = t0          # all-gather stream
        comm_total = 0.0
        for path in paths:
            size = fabric.fs.size(path)
            per_host = max(1, (size + P_ - 1) // P_)
            n_seg = max(1, (per_host + chunk_bytes - 1) // chunk_bytes)
            t_seg = t0
            for off, seg in _stripes(size, n_seg):   # file-range segments
                # all reads issue at t0: fs.busy_until serializes the
                # bandwidth and per-request latencies overlap, exactly as
                # in stage_collective — per-file sync overheads accumulate
                # in t_read_done OUTSIDE the busy stream, so stage_time
                # matches the collective engine for the same paths
                _, t_seg = fabric.fs.read_striped(
                    path, [(off + o, s) for o, s in _stripes(seg, P_)],
                    t0, coordinated=True)
                seg_stripe = max(1, (seg + P_ - 1) // P_)
                dt = fabric.net.allgather(seg_stripe, P_,
                                          t=max(t_comm, t_seg))
                comm_total += dt
                t_comm = max(t_comm, t_seg) + dt     # gather rides behind
                rep.n_chunks += 1
            t_read_done = max(t_read_done, t_seg) + coll_overhead
        rep.stage_time = t_read_done - t0
        rep.comm_time = max(0.0, t_comm - t_read_done)   # exposed (unhidden)
        rep.overlap_saved = comm_total - rep.comm_time

        rep.write_time = _deliver_replicas(fabric, paths, t=t_comm)
        rep.fs_bytes = fabric.fs.bytes_read - fs0
        rep.net_bytes = fabric.net.bytes_moved - net0
        rep.tier_bytes = fabric.net.tier_delta(tier0)
        rep.comp = fabric.net.comp_delta(comp0)
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + rep.total_time


def stage_naive(fabric: Fabric, paths: Sequence[str], t0: float = 0.0,
                topology: TopologyLike = None,
                compression: CompressionLike = None
                ) -> Tuple[StagingReport, float]:
    """Baseline: every host independently reads each full file from the
    shared FS (uncoordinated — the congested regime), then writes locally.
    `topology` and `compression` are accepted for engine-protocol
    uniformity only: the naive path never touches the interconnect, so no
    collective is planned, nothing can elect a codec, and the report's
    tier accounting stays empty."""
    del topology, compression       # no collective to plan on this path
    with fabric.tracer.region("stage.naive", t0, track="engine") as tsp:
        P_ = fabric.n_hosts
        fs0 = fabric.fs.bytes_read
        total = sum(fabric.fs.size(p) for p in paths)
        rep = StagingReport(n_hosts=P_, total_bytes=total, mode="naive")
        t_done = t0
        for path in paths:
            size = fabric.fs.size(path)
            for host in fabric.hosts:
                # concurrent uncoordinated reads: bandwidth serializes on
                # the shared FS, per-request latency overlaps across hosts
                data, t_r = fabric.fs.read(path, 0, size, t0,
                                           coordinated=False)
                # fs.read returns a view of the source buffer: same
                # read-only guard as the collective paths, so no store can
                # mutate the FS
                replica = data.view()
                replica.setflags(write=False)
                host.store.write(path, replica, 0.0)
                t_done = max(t_done, t_r)
        rep.stage_time = t_done - t0
        rep.write_time = total / fabric.constants.local_bw
        rep.fs_bytes = fabric.fs.bytes_read - fs0
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + rep.total_time


# ---------------------------------------------------------------------------
# replica-aware staging + repair collectives (fault tolerance)
# ---------------------------------------------------------------------------

def stage_replicated(fabric: Fabric, paths: Sequence[str], t0: float = 0.0,
                     replication: int = 2, topology: TopologyLike = None,
                     compression: CompressionLike = None
                     ) -> Tuple[StagingReport, float]:
    """R-way stripe-replicated staging: the fault-tolerant middle ground
    between ``stage_collective`` (R=P, every host a full replica) and
    bare striping (R=1, any death loses data).

    Phase 1 is the identical coordinated disjoint-stripe read (aggregate
    FS traffic = 1x the dataset). Phase 2 replaces the all-gather with
    R-1 rounds of chained stripe forwarding
    (:meth:`~repro_torch.core.collectives.CollectivePlanner.plan_replichain`):
    stripe ``i`` ends up on hosts ``i .. i+R-1`` (mod P) under the store
    key ``path::s{i}`` — interconnect traffic is (R-1)/(P-1) of the full
    all-gather, node memory R/P of a full replica per host. The returned
    report carries the :class:`ReplicaPlacement`; ``re_replicate`` uses
    it to restore redundancy after a host death at a cost proportional to
    the LOST stripes, not the dataset.

    Hosts dead at `t0` (non-trivial fault schedule only) are excluded
    from the stripe geometry entirely."""
    with fabric.net.scoped_topology(topology), \
            fabric.net.scoped_codec(compression), \
            fabric.tracer.region("stage.replicated", t0, track="engine",
                                 replication=replication) as tsp:
        live = (list(range(fabric.n_hosts)) if fabric.faults.trivial
                else fabric.live_ids(t0))
        L = len(live)
        fs0 = fabric.fs.bytes_read
        net0 = fabric.net.bytes_moved
        tier0 = fabric.net.tier_snapshot()
        comp0 = fabric.net.comp_snapshot()
        total = sum(fabric.fs.size(p) for p in paths)
        rep = StagingReport(n_hosts=L, total_bytes=total, mode="replicated",
                            placement=ReplicaPlacement.chained(live,
                                                               replication))

        coll_overhead = _coll_overhead(fabric)
        t_read_done = t0
        for path in paths:
            size = fabric.fs.size(path)
            _, t_file = fabric.fs.read_striped(path, _stripes(size, L), t0,
                                               coordinated=True)
            t_read_done = max(t_read_done, t_file) + coll_overhead
        rep.stage_time = t_read_done - t0

        stripe_bytes = max(1, (total + L - 1) // L)
        rep.comm_time = fabric.net.replichain(stripe_bytes, L, replication,
                                              t=t_read_done)

        # deliver each stripe view to its R owners; a host's writes
        # serialize on its local-store bandwidth, hosts run in parallel
        t_host: Dict[int, float] = {}
        for path in paths:
            size = fabric.fs.size(path)
            for i, (off, sz) in enumerate(_stripes(size, L)):
                view = readonly_view(fabric.fs.files[path][off:off + sz])
                key = ReplicaPlacement.stripe_key(path, i)
                for o in rep.placement.owners[i]:
                    t_host[o] = fabric.hosts[o].store.write(
                        key, view, t_host.get(o, 0.0))
        rep.write_time = max(t_host.values(), default=0.0)

        rep.fs_bytes = fabric.fs.bytes_read - fs0
        rep.net_bytes = fabric.net.bytes_moved - net0
        rep.tier_bytes = fabric.net.tier_delta(tier0)
        rep.comp = fabric.net.comp_delta(comp0)
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + rep.total_time


def re_replicate(fabric: Fabric, paths: Sequence[str],
                 placement: ReplicaPlacement, t0: float = 0.0,
                 live: Optional[Sequence[int]] = None,
                 topology: TopologyLike = None
                 ) -> Tuple[StagingReport, float]:
    """Restore R-way redundancy of a striped dataset after host loss.

    For every stripe with dead owners, a surviving owner sends the stripe
    to a replacement live host (explicit point-to-point schedule via
    :meth:`~repro_torch.core.collectives.CollectivePlanner.plan_repair`; the
    shared FS is never touched). Cost is proportional to the LOST
    stripes — roughly ``lost/P`` of the dataset per dead owner slot —
    which is what makes repair beat a full re-stage at large P.
    `placement` is updated in place (ownership moves to the replacement
    hosts). Raises :class:`LostStripesError` when some stripe has no
    surviving owner (caller must fall back to a full re-stage)."""
    with fabric.net.scoped_topology(topology), \
            fabric.tracer.region("stage.re_replicate", t0,
                                 track="engine") as tsp:
        if live is None:
            live = fabric.live_ids(t0)
        alive = set(live)
        lost = placement.lost(live)
        if lost:
            raise LostStripesError(
                f"stripes {lost} have no surviving owner among live hosts "
                f"{sorted(alive)}; repair impossible — full re-stage "
                f"required")
        net0 = fabric.net.bytes_moved
        tier0 = fabric.net.tier_snapshot()
        L = placement.n_stripes
        # per-stripe byte size summed over files (one repair transfer
        # per replaced owner slot covers every file's stripe i)
        stripe_sizes = [0] * L
        views: List[List[Tuple[str, np.ndarray]]] = [[] for _ in range(L)]
        for path in paths:
            size = fabric.fs.size(path)
            for i, (off, sz) in enumerate(_stripes(size, L)):
                stripe_sizes[i] += sz
                views[i].append(
                    (ReplicaPlacement.stripe_key(path, i),
                     readonly_view(fabric.fs.files[path][off:off + sz])))
        transfers: List[Tuple[int, int, int]] = []
        t_host: Dict[int, float] = {}
        repaired = 0
        for i in sorted(placement.owners):
            owners = placement.owners[i]
            survivors = [o for o in owners if o in alive]
            n_dead = len(owners) - len(survivors)
            if not n_dead:
                continue
            new_owners = list(survivors)
            for j in range(n_dead):
                cands = [h for h in live if h not in new_owners]
                if not cands:
                    break            # fewer live hosts than R: degrade R
                dst = cands[(i + j) % len(cands)]
                src = survivors[j % len(survivors)]
                transfers.append((src, dst, stripe_sizes[i]))
                repaired += stripe_sizes[i]
                for key, view in views[i]:
                    t_host[dst] = fabric.hosts[dst].store.write(
                        key, view, t_host.get(dst, 0.0))
                new_owners.append(dst)
            placement.owners[i] = tuple(new_owners)
        rep = StagingReport(n_hosts=len(live), total_bytes=repaired,
                            mode="re_replicate", placement=placement)
        rep.comm_time = fabric.net.repair(transfers, fabric.n_hosts, t=t0)
        rep.write_time = max(t_host.values(), default=0.0)
        rep.net_bytes = fabric.net.bytes_moved - net0
        rep.tier_bytes = fabric.net.tier_delta(tier0)
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + rep.total_time


def re_replicate_full(fabric: Fabric, paths: Sequence[str],
                      targets: Sequence[int], t0: float = 0.0,
                      sources: Optional[Sequence[int]] = None,
                      topology: TopologyLike = None
                      ) -> Tuple[StagingReport, float]:
    """Restore FULL replicas on `targets` (hosts missing the dataset —
    recovered-blank or newly grown) from surviving holders, without
    touching the shared FS.

    `sources` defaults to the hosts whose node-local stores hold every
    path. Targets round-robin across sources; each target receives the
    whole dataset in one point-to-point schedule (receiver NICs
    serialize). Raises :class:`ReplicaLossError` when no complete live
    copy exists (full re-stage required)."""
    with fabric.net.scoped_topology(topology), \
            fabric.tracer.region("stage.re_replicate_full", t0,
                                 track="engine") as tsp:
        want = set(targets)
        if sources is None:
            sources = [h.host_id for h in fabric.hosts
                       if h.host_id not in want
                       and all(p in h.store.data for p in paths)]
        if not sources:
            raise ReplicaLossError(
                f"no live host holds a complete replica of {list(paths)}; "
                f"repair impossible — full re-stage required")
        net0 = fabric.net.bytes_moved
        tier0 = fabric.net.tier_snapshot()
        total = sum(fabric.fs.size(p) for p in paths)
        replicas = {p: _replica_view(fabric, p) for p in paths}
        transfers = [(sources[k % len(sources)], dst, total)
                     for k, dst in enumerate(sorted(want))]
        rep = StagingReport(n_hosts=len(want), total_bytes=total,
                            mode="re_replicate")
        rep.comm_time = fabric.net.repair(transfers, fabric.n_hosts, t=t0)
        t_write = 0.0
        for dst in sorted(want):
            t_write = max(t_write,
                          fabric.hosts[dst].store.write_many(replicas, 0.0))
        rep.write_time = t_write
        rep.net_bytes = fabric.net.bytes_moved - net0
        rep.tier_bytes = fabric.net.tier_delta(tier0)
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + rep.total_time


# ---------------------------------------------------------------------------
# write-back: staging OUT — dirty results flushed to the shared FS
# ---------------------------------------------------------------------------

def _as_uint8(outputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {p: np.ascontiguousarray(d).view(np.uint8).ravel()
            for p, d in outputs.items()}


def stage_out(fabric: Fabric, outputs: Dict[str, np.ndarray],
              t0: float = 0.0, topology: TopologyLike = None,
              compression: CompressionLike = None
              ) -> Tuple[StagingReport, float]:
    """Collective write-back: ``MPI_File_write_all`` over the fabric.

    `outputs` maps shared-FS destination paths to result buffers (any
    dtype; flattened to uint8). Each file is written as P disjoint 1/P
    stripes by the leader group through
    :meth:`repro_torch.core.fabric.SharedFilesystem.write_gather` — aggregate
    FS traffic is 1x the result bytes at the coordinated sequential rate,
    plus the per-file collective sync overhead, exactly mirroring
    ``stage_collective`` on the read side. Analysis results are
    REPLICATED on the nodes (every host holds the full buffer), so the
    data-gather half of the two-phase write moves no interconnect bytes —
    each leader already owns its stripe.

    Returns ``(report, completion time)``; the report's ``stage_time`` is
    the FS write phase and ``fs_write_bytes`` the bytes landed.
    `topology` and `compression` are accepted for engine-protocol
    uniformity only: each leader already owns its stripe, so no
    collective is planned (nothing can elect a codec) and the tier
    accounting stays empty.
    """
    del topology, compression       # no collective to plan on this path
    with fabric.tracer.region("stage.stage_out", t0, track="engine") as tsp:
        P_ = fabric.n_hosts
        w0 = fabric.fs.bytes_written
        bufs = _as_uint8(outputs)
        total = sum(b.size for b in bufs.values())
        rep = StagingReport(n_hosts=P_, total_bytes=total, mode="stage_out")

        coll_overhead = _coll_overhead(fabric)
        t_done = t0
        for path, buf in bufs.items():
            # stripes issue concurrently; the FS serializes bandwidth only
            t_file = fabric.fs.write_gather(path, buf,
                                            _stripes(buf.size, P_),
                                            t0, coordinated=True)
            t_done = max(t_done, t_file) + coll_overhead
        rep.stage_time = t_done - t0
        rep.fs_write_bytes = fabric.fs.bytes_written - w0
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + rep.total_time


def stage_out_naive(fabric: Fabric, outputs: Dict[str, np.ndarray],
                    t0: float = 0.0, topology: TopologyLike = None,
                    compression: CompressionLike = None
                    ) -> Tuple[StagingReport, float]:
    """Baseline write-back: every host writes each FULL result file to the
    shared FS, uncoordinated (the congested regime — P x the bytes at
    ``fs_rand_bw``). Final file contents are identical to ``stage_out``;
    only the traffic and time differ, which is the comparison the
    write-back benchmark measures. `topology` and `compression` are
    accepted for engine-protocol uniformity (no interconnect traffic
    either way)."""
    del topology, compression       # no collective to plan on this path
    with fabric.tracer.region("stage.stage_out_naive", t0,
                              track="engine") as tsp:
        P_ = fabric.n_hosts
        w0 = fabric.fs.bytes_written
        bufs = _as_uint8(outputs)
        total = sum(b.size for b in bufs.values())
        rep = StagingReport(n_hosts=P_, total_bytes=total,
                            mode="stage_out_naive")
        t_done = t0
        for path, buf in bufs.items():
            for _ in range(P_):
                # concurrent uncoordinated writes: bandwidth serializes on
                # the shared FS, per-request latency overlaps across hosts
                t_w = fabric.fs.write(path, buf, t0, coordinated=False)
                t_done = max(t_done, t_w)
        rep.stage_time = t_done - t0
        rep.fs_write_bytes = fabric.fs.bytes_written - w0
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + rep.total_time


# The mode -> engine mapping lives in the pluggable registry
# `repro_torch.core.api.ENGINES` (this module's engines register there under
# "collective"/"pipelined"/"naive"; the streaming engine under "stream").
# The I/O hook, the StagingClient, the dataset service and the HEDM
# runners all resolve engines through it — new engines register once with
# a typed config instead of editing per-consumer tables.


# ---------------------------------------------------------------------------
# device-level staging (torch.distributed mesh) — shard + all-gather
# ---------------------------------------------------------------------------

def device_replicate(mesh, x: torch.Tensor, axis: str = "data"
                     ) -> torch.Tensor:
    """Replicate a tensor across `axis` given each participant holds 1/P of
    it.

    Input: this rank's shard of the leading dim (the same shape on every
    rank). Output: the full tensor, on every rank of the axis, on the
    mesh's device. This is the staging all-gather: read-shards once,
    replicate over the interconnect — instead of every participant
    fetching the full buffer from storage.
    """
    x = x.to(mesh.device_type).contiguous()
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.get_group(axis))
    return out


def device_shard(mesh, x, spec) -> DTensor:
    """Lay out a host buffer onto the mesh with the given spec (a
    `repro_torch.distributed.sharding.P`): the 'distribute' half of
    staging, for non-replicated targets."""
    return distribute_tensor(torch.as_tensor(x), mesh,
                             placements(spec, mesh))


def staged_restore(mesh, shards: Dict[int, np.ndarray],
                   axis: str = "data") -> torch.Tensor:
    """Checkpoint-restore staging: the shards (numpy arrays or tensors, 1/P
    of the array each, along the leading dim) are concatenated in key
    order, as the reference does; the ranks of `axis` own consecutive equal
    runs of them. Each rank copies its own onto its device, then one
    all-gather assembles the replicated full array. With one rank on the
    axis, every shard is that rank's."""
    order = sorted(shards)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if len(order) % n:
        raise ValueError(f"{len(order)} shards do not split evenly over "
                         f"the {n} ranks of axis {axis!r}")
    k = len(order) // n
    r = mesh.get_local_rank(axis)
    mine = [torch.as_tensor(shards[i]) for i in order[r * k:(r + 1) * k]]
    local = torch.empty((sum(s.shape[0] for s in mine),)
                        + tuple(mine[0].shape[1:]), dtype=mine[0].dtype,
                        device=mesh.device_type)
    row = 0
    for s in mine:
        local[row:row + s.shape[0]].copy_(s)
        row += s.shape[0]
    return device_replicate(mesh, local, axis)
