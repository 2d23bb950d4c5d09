"""Streaming detector ingestion — frames land in node memory as produced.

The paper stages complete on-disk datasets into compute-node memory
(`repro_torch.core.staging`); the follow-on literature (Welborn et al.,
"Streaming Detector Data Directly into Perlmutter Compute Nodes";
Poeschel et al., openPMD + ADIOS2 streaming pipelines) shows the next win
is skipping the shared-FS round trip entirely: the detector pushes each
frame over the fabric into node-local memory while acquisition is still
in flight, and analysis tasks become eligible the moment their frame
lands instead of when the scan closes.

Pieces:

  * :class:`DetectorSource` — a simulated detector emitting frames at a
    configurable ``rate_hz``; wraps an in-memory frame stack or replays
    files already resident on the shared FS.
  * :class:`StreamStager` — per-frame delivery: scatter each frame to its
    owning leader host (round-robin over hosts, the streaming analogue of
    the leader communicator), then a pipelined ring broadcast to every
    node-local store. Delivery reuses the zero-copy replica discipline of
    ``staging.py`` (:func:`repro_torch.core.staging.readonly_view`): every store
    holds a read-only view of the single emitted buffer, so delivery is
    byte-exact with no per-host copies. The stager maintains a
    **sliding-window node-local cache**: a per-node byte budget with
    watermark-based eviction of consumed frames, pinning, and
    **backpressure** — when consumers fall behind and the window holds
    only unconsumed/pinned frames, admission of the next frame stalls
    until a consumer release frees space (the DAQ-buffer stall of a real
    streaming deployment).
  * :func:`stage_stream` — a one-shot staging engine registered as
    ``"stream"`` in `repro_torch.core.api.ENGINES` (typed config:
    ``StreamConfig``; selectable via ``StagingClient.stage`` or the
    legacy ``run_io_hook(..., mode="stream")`` shim): the dataset is
    ingested from the source stream and never read back from the shared
    FS (``fs_bytes == 0``).
  * :class:`StreamScenario` — a simulator scenario bundling fabric +
    acquisition parameters (hosts, frame geometry, rate, consumer window),
    used by the examples, benchmarks and tests.

Units: all simulated times are SECONDS, all sizes BYTES, rates in frames
per simulated second. Frames move REAL bytes; only the clock is modeled.
Frame futures: a delivered frame's :class:`FrameRecord` carries
``t_avail``; ``Task.not_before`` / ``Dataflow.frame_task`` turn that into
scheduler eligibility (see `repro_torch.core.manytask` / `repro_torch.core.dataflow`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compression import CompressionLike, CompressionStats
from repro_torch.core.fabric import (BGQ, Fabric, FabricConstants, pin_ref,
                               unpin_ref)
from repro_torch.core.staging import (StagingReport, _close_stage_span,
                                readonly_view)
from repro_torch.core.topology import TopologyLike, resolve_topology


@dataclass
class FrameRecord:
    """Delivery record for one streamed frame — the *frame future*.

    ``t_emit``  simulated s the detector finished producing the frame;
    ``t_avail`` simulated s the frame became resident on EVERY node-local
    store (feed this to ``Task.not_before``); ``stalled`` is the
    backpressure wait charged to this frame's admission (s).
    """
    frame_id: int
    path: str
    nbytes: int
    owner_host: int
    t_emit: float
    t_avail: float
    stalled: float = 0.0


@dataclass
class StreamReport:
    """Accounting for one streamed acquisition (all times simulated s)."""
    n_hosts: int
    n_frames: int = 0
    total_bytes: int = 0           # emitted frame bytes (pre-replication)
    acquisition_span: float = 0.0  # last t_emit - t0 (detector-limited)
    ingest_makespan: float = 0.0   # last t_avail - t0 (delivery-limited)
    mean_latency: float = 0.0      # mean(t_avail - t_emit) per frame
    stall_time: float = 0.0        # total backpressure wait across frames
    evictions: int = 0             # frames dropped from the sliding window
    peak_resident_bytes: int = 0   # high-water mark of the node window
    degraded_deliveries: int = 0   # frames delivered around dead hosts
    net_bytes: int = 0             # interconnect WIRE traffic (pull+broadcast)
    # interconnect WIRE bytes per topology tier (sums to net_bytes; the
    # compressed count on codec-elected tiers — `comp` has the split,
    # while total_bytes stays the logical/payload frame count)
    tier_bytes: Dict[str, int] = field(default_factory=dict)
    # codec accounting over this stream's executed plans
    comp: CompressionStats = field(default_factory=CompressionStats)
    # multi-consumer pub/sub accounting (registered consumers only;
    # empty / -1 / 0 for single-consumer streams):
    #   consumer_lag    per-consumer mean ack lag behind t_avail (s)
    #   watermark_frame highest frame id fully released by EVERY consumer
    #   watermark_lag   mean extra retention the slowest consumer adds
    #                   per fully-released frame (max ack - min ack, s)
    consumer_lag: Dict[str, float] = field(default_factory=dict)
    watermark_frame: int = -1
    watermark_lag: float = 0.0
    mode: str = "stream"


class DetectorSource:
    """Simulated detector: yields ``(frame_id, path, uint8 buffer, t_emit)``.

    ``rate_hz`` is the acquisition rate in frames per simulated second;
    frame ``i`` finishes exposure at ``t0 + (i + 1) / rate_hz``.
    ``rate_hz=None`` means the whole set is already available at ``t0``
    (replay mode — the degenerate case equivalent to batch input).
    """

    def __init__(self, buffers: Sequence[Tuple[str, np.ndarray]],
                 rate_hz: Optional[float] = None, t0: float = 0.0):
        self.buffers = list(buffers)
        self.rate_hz = rate_hz
        self.t0 = t0

    @classmethod
    def from_frames(cls, frames: np.ndarray, rate_hz: Optional[float] = None,
                    t0: float = 0.0, prefix: str = "scan") -> "DetectorSource":
        """Wrap a (F, H, W) frame stack; paths match ``stream_to_fs`` naming
        so batch and streaming runs of the same scan share file names."""
        bufs = [(f"{prefix}/frame_{i:05d}.bin",
                 np.ascontiguousarray(frames[i]).view(np.uint8).ravel())
                for i in range(len(frames))]
        return cls(bufs, rate_hz=rate_hz, t0=t0)

    @classmethod
    def replay_fs(cls, fabric: Fabric, paths: Sequence[str],
                  rate_hz: Optional[float] = None, t0: float = 0.0
                  ) -> "DetectorSource":
        """Replay files resident on the shared FS as a stream. The source
        taps the producer's buffer directly (detector -> compute push), so
        no FS read time or ``fs.bytes_read`` is charged."""
        return cls([(p, fabric.fs.files[p]) for p in paths],
                   rate_hz=rate_hz, t0=t0)

    def __len__(self) -> int:
        return len(self.buffers)

    def __iter__(self) -> Iterator[Tuple[int, str, np.ndarray, float]]:
        for i, (path, buf) in enumerate(self.buffers):
            t_emit = (self.t0 if self.rate_hz is None
                      else self.t0 + (i + 1) / self.rate_hz)
            yield i, path, buf, t_emit


class StreamStager:
    """Scatter + ring-broadcast delivery with a sliding-window node cache.

    Per frame: the detector link sends the frame to its owning leader host
    (``frame_id % P``, serialized on the NIC), the leader ring-broadcasts
    it to all hosts (serialized on the broadcast ring, *pipelined behind*
    the scatter — frame k+1's scatter overlaps frame k's broadcast, the
    streaming analogue of ``stage_pipelined``), and every node-local store
    writes one shared read-only view (zero-copy, byte-exact).

    Window policy (per-node budget ``window_bytes``):

      * admission above ``high_watermark * window_bytes`` evicts frames
        that are *released* (consumed) and unpinned, oldest-first, down to
        ``low_watermark * window_bytes``;
      * if the frame still does not fit, admission **stalls** until future
        consumer releases free enough space (backpressure; accumulated in
        ``stall_time``), and raises ``RuntimeError`` if no release can
        ever make it fit (window wedged by pinned/unconsumed frames).

    Incremental driver protocol::

        stager = StreamStager(fabric, window_bytes=...)
        for fid, path, buf, t_emit in source:
            rec = stager.ingest(path, buf, t_emit)
            ... consume; when done with a frame: stager.release(path, t)
        report = stager.finish()
    """

    def __init__(self, fabric: Fabric, window_bytes: int,
                 high_watermark: float = 0.9, low_watermark: float = 0.5,
                 t0: float = 0.0, topology: TopologyLike = None,
                 compression: CompressionLike = None):
        if not 0.0 < low_watermark <= high_watermark <= 1.0:
            raise ValueError("need 0 < low_watermark <= high_watermark <= 1")
        self.fabric = fabric
        self.window_bytes = int(window_bytes)
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        self.t0 = t0
        # per-stager machine-model override: every delivery collective is
        # planned under this topology (None -> whatever the fabric runs)
        self._topology = (None if topology is None
                          else resolve_topology(topology))
        # per-stager codec: elected per tier by the planner on the ingest
        # hop and delivery broadcast (None -> the fabric binding, which
        # defaults to the bit-exact uncompressed path)
        self._compression = compression
        self.records: List[FrameRecord] = []
        self.stall_time = 0.0
        self.evictions = 0
        self.peak_resident = 0
        self.degraded_deliveries = 0    # frames that skipped dead hosts
        self._resident: Dict[str, int] = {}     # path -> bytes, arrival order
        self._released: Dict[str, float] = {}   # path -> simulated release t
        self._pinned: Dict[str, int] = {}       # path -> pin refcount
        self._consumers: set = set()            # registered shared consumers
        self._acks: Dict[str, Dict[str, float]] = {}  # path -> consumer -> t
        self._avail: Dict[str, float] = {}      # path -> t_avail (lag base)
        self._frame_of: Dict[str, int] = {}     # path -> frame id (watermark)
        self._lag_sum: Dict[str, float] = {}    # consumer -> sum ack lag
        self._lag_n: Dict[str, int] = {}        # consumer -> acked frames
        self._watermark_frame = -1              # highest fully-released fid
        self._watermark_extra = 0.0             # sum(max ack - min ack)
        self._full_releases = 0                 # frames acked by everyone
        self._nic_busy = t0                     # detector link serialization
        self._bcast_busy = t0                   # broadcast ring serialization
        self._net0 = fabric.net.bytes_moved
        self._tier0 = fabric.net.tier_snapshot()
        self._comp0 = fabric.net.comp_snapshot()

    # -- window bookkeeping -------------------------------------------------
    def _resident_bytes(self) -> int:
        return sum(self._resident.values())

    def _delivery_hosts(self, t: float) -> List["object"]:
        """The hosts a frame lands on: all of them on a healthy fabric
        (the exact pre-fault path), the LIVE set at simulated time `t`
        under a non-trivial fault schedule — a dead host's store receives
        nothing (degraded ingest: acquisition keeps running, the dead
        node just misses frames until it recovers and re-acquires)."""
        if self.fabric.faults.trivial:
            return self.fabric.hosts
        return self.fabric.live_hosts(t)

    def _pinned_anywhere(self, path: str) -> bool:
        """Pinned by this stager OR by any other holder in the node-local
        stores (e.g. a dataset-service lease on the same paths) — window
        eviction must respect foreign pins, not just its own. Store pins
        are symmetric across LIVE hosts (a dead host's pins were wiped
        with its store), so the first live host is representative."""
        hosts = self._delivery_hosts(self.fabric.net.now)
        return (path in self._pinned
                or (bool(hosts) and path in hosts[0].store.pinned))

    def _evictable(self, path: str, t: float) -> bool:
        return (not self._pinned_anywhere(path)
                and self._released.get(path, float("inf")) <= t)

    def _drop(self, path: str) -> None:
        del self._resident[path]
        self._released.pop(path, None)
        self._acks.pop(path, None)
        for host in self.fabric.hosts:
            host.store.drop(path)
        self.evictions += 1

    def _evict_down_to(self, target_bytes: float, t: float) -> None:
        for path in list(self._resident):       # insertion order = arrival
            if self._resident_bytes() <= target_bytes:
                break
            if self._evictable(path, t):
                self._drop(path)

    def _admit(self, nbytes: int, t_arrive: float) -> float:
        """Admission time for a frame of `nbytes` arriving at `t_arrive`:
        watermark eviction first, then backpressure on future releases."""
        t = t_arrive
        high = self.high_watermark * self.window_bytes
        if self._resident_bytes() + nbytes > high:
            self._evict_down_to(self.low_watermark * self.window_bytes, t)
        if self._resident_bytes() + nbytes <= self.window_bytes:
            return t
        # backpressure: advance to consumer releases, oldest release first
        pending = sorted((rt, p) for p, rt in self._released.items()
                         if p in self._resident
                         and not self._pinned_anywhere(p) and rt > t)
        for rt, path in pending:
            t = rt
            self._drop(path)
            if self._resident_bytes() + nbytes <= self.window_bytes:
                return t
        raise RuntimeError(
            f"stream window wedged: frame of {nbytes} B cannot fit in "
            f"{self.window_bytes} B window holding "
            f"{self._resident_bytes()} B of pinned/unconsumed frames")

    # -- public API ---------------------------------------------------------
    def _pull_time(self, nbytes: int, t: float) -> float:
        """Duration of THIS frame's detector->leader ingest hop, issued at
        `t`. The seam subclasses override to put a different wire model on
        the hop — `repro_torch.core.wan.WanFanout` adds seeded loss/retransmits
        here — without touching any other delivery arithmetic. The default
        is exactly the lossless point-to-point plan."""
        return self.fabric.net.point_to_point_time(nbytes, t=t)

    def ingest(self, path: str, data: np.ndarray, t_emit: float,
               t_offer: Optional[float] = None) -> FrameRecord:
        """Deliver one frame to every node-local store.

        `data` is the emitted frame (any dtype; flattened to uint8);
        `t_emit` the simulated second the detector finished producing it.
        `t_offer` is when the frame is OFFERED to the fabric — ``None``
        means at emission, the push model; a flow-controlled producer
        (`repro_torch.core.wan`) offers later, once it holds a send credit, and
        the frame's latency is still measured from `t_emit`.
        Returns the frame's :class:`FrameRecord` (its future).
        """
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        view = readonly_view(buf)
        nbytes = int(buf.size)
        net = self.fabric.net
        c = self.fabric.constants

        t_arrive = max(t_emit if t_offer is None else t_offer,
                       self._nic_busy)
        t_admit = self._admit(nbytes, t_arrive)
        stalled = t_admit - t_arrive
        self.stall_time += stalled

        owner = len(self.records) % self.fabric.n_hosts
        with net.scoped_topology(self._topology), \
                net.scoped_codec(self._compression):
            # issue times feed the fault schedule: a degraded ingest tier
            # or a dead host at THIS frame's delivery slows/reroutes it
            self._nic_busy = t_admit + self._pull_time(nbytes, t_admit)
            t_bc = max(self._nic_busy, self._bcast_busy)
            self._bcast_busy = t_bc + net.broadcast(nbytes,
                                                    self.fabric.n_hosts,
                                                    t=t_bc)
        t_avail = self._bcast_busy + nbytes / c.local_bw

        targets = self._delivery_hosts(t_bc)
        self.degraded_deliveries += int(len(targets) < self.fabric.n_hosts)
        for host in targets:
            host.store.write(path, view, 0.0)
        self._resident[path] = nbytes
        self.peak_resident = max(self.peak_resident, self._resident_bytes())

        rec = FrameRecord(frame_id=len(self.records), path=path,
                          nbytes=nbytes, owner_host=owner, t_emit=t_emit,
                          t_avail=t_avail, stalled=stalled)
        self.records.append(rec)
        self._avail[path] = t_avail
        self._frame_of[path] = rec.frame_id

        tr = self.fabric.tracer
        if tr.enabled:
            # record only: every time below was computed above, untraced
            with tr.region("stream.frame", t_arrive, track="stream",
                           frame_id=rec.frame_id, path=path, nbytes=nbytes,
                           owner_host=owner) as sp:
                if stalled > 0:
                    tr.span("stream.stall", t_arrive, t_admit,
                            reason="window_backpressure")
                    tr.metrics.counter("stream.stalls").inc()
                tr.span("stream.scatter", t_admit, self._nic_busy)
                tr.span("stream.broadcast", t_bc, self._bcast_busy)
                tr.span("stream.local_write", self._bcast_busy, t_avail)
                sp.t_end = t_avail
            tr.metrics.counter("stream.frames").inc()
            tr.metrics.histogram("stream.frame_latency_s").observe(
                t_avail - t_emit)
            tr.metrics.gauge("stream.resident_bytes").record(
                t_admit, self._resident_bytes())
        return rec

    def register_consumer(self, consumer: str) -> None:
        """Declare a named consumer SHARING this window (e.g. two analysis
        sessions reducing the same acquisition). Once any consumer is
        registered, a frame only becomes evictable when EVERY registered
        consumer has released it — at the LATEST ack time, so the slowest
        session is what backpressures the detector. With no registered
        consumers, :meth:`release` keeps its single-consumer semantics."""
        self._consumers.add(consumer)

    def release(self, path: str, t: float,
                consumer: Optional[str] = None) -> None:
        """Consumer ack: `path` becomes evictable at simulated time `t`.

        With `consumer` (a name from :meth:`register_consumer`), the ack
        is per-consumer; the frame's release time is the max ack once all
        registered consumers have acked."""
        if consumer is None:
            self._released[path] = t
            return
        if consumer not in self._consumers:
            raise ValueError(
                f"unknown consumer {consumer!r}; registered: "
                f"{sorted(self._consumers)} (register_consumer first)")
        acks = self._acks.setdefault(path, {})
        acks[consumer] = t
        if set(acks) == self._consumers:
            t_rel = max(acks.values())
            self._released[path] = t_rel
            # pub/sub accounting: per-consumer ack lag behind delivery and
            # the retention the slowest consumer adds (watermark cost)
            avail = self._avail.get(path)
            if avail is not None:
                for name, ta in acks.items():
                    self._lag_sum[name] = (self._lag_sum.get(name, 0.0)
                                           + (ta - avail))
                    self._lag_n[name] = self._lag_n.get(name, 0) + 1
                self._watermark_extra += t_rel - min(acks.values())
                self._full_releases += 1
                self._watermark_frame = max(self._watermark_frame,
                                            self._frame_of.get(path, -1))

    def fully_released(self, path: str) -> bool:
        """True once `path` is evictable — released directly, or acked by
        EVERY registered consumer (the pub/sub watermark has passed it)."""
        return path in self._released

    def pin(self, path: str) -> None:
        """Exempt `path` from window eviction (it keeps counting against
        the budget); also pins it in every node-local store. Pins are
        refcounted (lease-aware): several holders — the I/O-hook pin
        directive, dataset-service leases — may pin the same frame, and
        it stays exempt until every one calls :meth:`unpin`. Only LIVE
        hosts take the store pin — a dead host holds no replica to
        shield, and a stranded refcount would survive its recovery."""
        pin_ref(self._pinned, path)
        for host in self._delivery_hosts(self.fabric.net.now):
            host.store.pin(path)

    def unpin(self, path: str) -> None:
        """Drop one pin reference on `path` (and the matching node-local
        store pin); after the last holder unpins, the frame is evictable
        again the moment it is also released. No-op when this stager
        holds no pin — other holders' store pins are never touched."""
        if unpin_ref(self._pinned, path):
            for host in self.fabric.hosts:
                host.store.unpin(path)

    def finish(self) -> StreamReport:
        """Close the stream and return the acquisition's accounting."""
        rep = StreamReport(n_hosts=self.fabric.n_hosts,
                           n_frames=len(self.records))
        if self.records:
            rep.total_bytes = sum(r.nbytes for r in self.records)
            rep.acquisition_span = max(r.t_emit for r in self.records) - self.t0
            rep.ingest_makespan = max(r.t_avail for r in self.records) - self.t0
            rep.mean_latency = float(np.mean(
                [r.t_avail - r.t_emit for r in self.records]))
        rep.stall_time = self.stall_time
        rep.evictions = self.evictions
        rep.peak_resident_bytes = self.peak_resident
        rep.degraded_deliveries = self.degraded_deliveries
        rep.net_bytes = self.fabric.net.bytes_moved - self._net0
        rep.tier_bytes = self.fabric.net.tier_delta(self._tier0)
        rep.comp = self.fabric.net.comp_delta(self._comp0)
        rep.consumer_lag = {
            name: self._lag_sum[name] / self._lag_n[name]
            for name in sorted(self._lag_sum)}
        rep.watermark_frame = self._watermark_frame
        if self._full_releases:
            rep.watermark_lag = self._watermark_extra / self._full_releases
        return rep

    def stage(self, source: DetectorSource, release_on_delivery: bool = False
              ) -> Tuple[StreamReport, List[FrameRecord]]:
        """Convenience: ingest a whole source with no external consumer.

        By default frames are never released, so everything stays resident
        (requires the window to hold the whole set). With
        ``release_on_delivery`` each frame is released the moment it lands:
        the window behaves as a pure sliding cache — once full, the oldest
        unpinned frames evict — which permits ``window_bytes`` smaller than
        the set (only the most recent frames remain resident at the end).
        """
        records = []
        for _, path, buf, t_emit in source:
            rec = self.ingest(path, buf, t_emit)
            if release_on_delivery:
                self.release(path, rec.t_avail)
            records.append(rec)
        return self.finish(), records


def stage_stream(fabric: Fabric, paths: Sequence[str], t0: float = 0.0,
                 rate_hz: Optional[float] = None,
                 window_bytes: Optional[int] = None,
                 pin_paths: Sequence[str] = (),
                 topology: TopologyLike = None,
                 compression: CompressionLike = None
                 ) -> Tuple[StagingReport, float]:
    """I/O-hook-compatible streaming engine (``mode="stream"``).

    Ingests `paths` from the producer stream straight into every node-local
    store — the shared FS is never read back (``fs_bytes == 0``), which is
    the whole point of streaming ingestion. `rate_hz=None` replays the set
    as fast as the fabric delivers it. ``window_bytes`` defaults to the
    whole set (every file ends resident, matching the batch engines); a
    smaller budget turns the node cache into a sliding window — frames are
    released as they land and the oldest unpinned ones evict, leaving only
    the most recent ``window_bytes`` resident. ``pin_paths`` are pinned AT
    INGEST (the I/O-hook pin directive): exempt from window eviction, so a
    bounded window too small for its pinned set fails loudly ("wedged")
    rather than silently evicting files the spec promised to keep.
    Returns ``(report, completion t)`` like the batch engines; the
    report's ``n_chunks`` is the frame count.
    """
    total = sum(fabric.fs.size(p) for p in paths)
    bounded = window_bytes is not None and window_bytes < total
    src = DetectorSource.replay_fs(fabric, paths, rate_hz=rate_hz, t0=t0)
    with fabric.tracer.region("stage.stream", t0, track="engine") as tsp:
        stager = StreamStager(fabric,
                              window_bytes=window_bytes or max(total, 1),
                              t0=t0, topology=topology,
                              compression=compression)
        pin_set = set(pin_paths)
        for _, path, buf, t_emit in src:
            rec = stager.ingest(path, buf, t_emit)
            if path in pin_set:
                stager.pin(path)
            elif bounded:
                stager.release(path, rec.t_avail)
        srep = stager.finish()

        rep = StagingReport(n_hosts=fabric.n_hosts, total_bytes=total,
                            mode="stream")
        rep.stage_time = 0.0                   # no FS read phase at all
        rep.write_time = total / fabric.constants.local_bw
        rep.comm_time = max(0.0, srep.ingest_makespan - rep.write_time)
        rep.fs_bytes = 0
        rep.net_bytes = srep.net_bytes
        rep.tier_bytes = dict(srep.tier_bytes)
        rep.comp = srep.comp
        rep.n_chunks = srep.n_frames
        _close_stage_span(fabric, tsp, rep, t0)
        return rep, t0 + srep.ingest_makespan


@dataclass
class StreamScenario:
    """One simulated acquisition: fabric + detector + consumer window.

    ``rate_hz`` in frames per simulated second; ``window_frames`` is the
    consumer's reduce batch; ``cache_frames`` bounds the per-node sliding
    window (``None`` -> the whole scan fits, no eviction/backpressure).
    """
    n_hosts: int = 64
    n_frames: int = 48
    frame_size: int = 128          # square detector, pixels per side
    n_spots: int = 6
    rate_hz: float = 10.0
    window_frames: int = 8
    cache_frames: Optional[int] = None
    seed: int = 0
    constants: FabricConstants = field(default_factory=lambda: BGQ)

    @property
    def frame_bytes(self) -> int:
        return self.frame_size * self.frame_size * 4      # float32 pixels

    @property
    def window_bytes(self) -> int:
        return (self.cache_frames or self.n_frames) * self.frame_bytes

    def make_fabric(self) -> Fabric:
        return Fabric(n_hosts=self.n_hosts, constants=self.constants)

    def make_frames(self) -> Tuple[np.ndarray, np.ndarray]:
        """Synthetic (frames, dark) for this scenario's detector geometry."""
        from repro_torch.hedm.pipeline import simulate_detector_frames
        return simulate_detector_frames(self.n_frames, size=self.frame_size,
                                        n_spots=self.n_spots, seed=self.seed)

    def make_source(self, frames: np.ndarray) -> DetectorSource:
        return DetectorSource.from_frames(frames, rate_hz=self.rate_hz)
