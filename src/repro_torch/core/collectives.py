"""Collective planner: explicit algorithms over a hierarchical topology.

The pre-topology ``Interconnect`` hardcoded ONE algorithm per collective
(pipelined ring broadcast, ring all-gather) on ONE link class. This module
makes the choice explicit: a :class:`CollectivePlanner` bound to a
`repro_torch.core.topology.Topology` plans each collective as a named algorithm,
selects by message size and host count via the cost model (unless the
topology pins an algorithm — :data:`~repro_torch.core.topology.FLAT` pins the
legacy rings as a numeric regression anchor), and accounts the wire bytes
PER TIER, which is what a flat model cannot express.

Algorithms:

  broadcast   ``pipelined_ring``    — the legacy ring: the buffer streams
                                      once at the bottleneck tier plus
                                      (P-2) one-segment pipeline fills.
              ``binomial_tree``     — ceil(log2 P) doubling rounds; the
                                      first ceil(log2 R) rounds cross
                                      racks. Wins for small messages.
              ``scatter_allgather`` — van de Geijn: binomial scatter of
                                      1/P shards, then a ring all-gather.
              ``hierarchical``      — inter-rack binomial tree among rack
                                      leaders + parallel intra-rack
                                      pipelined rings. Collapses to the
                                      flat ring on a single rack.
  allgather   ``ring``              — the legacy P-1 step ring.
              ``hierarchical``      — intra-rack ring, leader ring of
                                      rack blocks, intra-rack broadcast
                                      of the foreign blocks.
  scatter     ``binomial``          — halving rounds down a binomial tree.
              ``hierarchical``      — inter-rack binomial of rack blocks,
                                      then intra-rack binomial.

Planning is PURE (no counters touched): ``plan_*`` returns a
:class:`CollectivePlan` with the duration and per-tier byte map;
`repro_torch.core.fabric.Interconnect` executes plans and accumulates traffic.
All durations are SIMULATED seconds (`repro_torch.core.fabric`), sizes bytes.

**Compression-aware planning** (``codec=`` on every ``plan_*``): the
planner elects compress-at-source PER TIER — tier ``T`` ships the
compressed representation iff

    n/Cc + n/Cd + compressed_size(n)/bw_T  <  n/bw_T

(per-transfer link latencies appear on both sides and cancel), where
``Cc``/``Cd`` are the codec's compress/decompress throughputs and
``bw_T`` the single-transfer tier bandwidth *including degradation*
(`repro_torch.core.faults` tier factors shift the decision).  On elected
tiers every transfer's wire size is ``compressed_size(payload)``; the
codec edges are charged ONCE per plan (compress at the sending edge,
decompress at the receiving edge — parallel edges overlap).  The plan
then reports wire bytes in ``tier_bytes`` and the logical traffic in
``payload_tier_bytes``.  ``codec=None`` (or an identity codec) is the
bit-exact pre-compression path — the regression anchor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.compression import Codec
from repro_torch.core.topology import LinkTier, Topology

TierBytes = Dict[str, int]


class LinkPartitionedError(RuntimeError):
    """A plan would cross a tier degraded to factor 0 (a partition)."""


@dataclass
class CollectivePlan:
    """One planned collective: the algorithm picked, its modeled duration
    and the wire traffic it will put on each topology tier.

    ``nbytes`` is the op's payload parameter (broadcast: message bytes;
    allgather: per-host shard bytes; scatter: total bytes at the root).

    ``tier_bytes`` is always WIRE traffic (what crosses each link);
    when a codec elected one or more tiers, ``payload_tier_bytes``
    carries the logical traffic the same plan would move raw, and
    ``time`` includes the once-per-plan codec edge charges.  Without an
    election the two byte maps are the same quantity and
    ``payload_tier_bytes`` stays ``None``.
    """
    op: str
    algorithm: str
    nbytes: int
    n_hosts: int
    time: float
    tier_bytes: TierBytes = field(default_factory=dict)
    rerouted: int = 0       # dead hosts the schedule was repaired around
    codec: str = "none"                       # codec the plan was made with
    compressed_tiers: Tuple[str, ...] = ()    # tiers shipping compressed
    payload_tier_bytes: Optional[TierBytes] = None
    compress_time: float = 0.0                # sending-edge codec charge
    decompress_time: float = 0.0              # receiving-edge codec charge

    @property
    def total_bytes(self) -> int:
        """Wire bytes summed over tiers (the legacy ``bytes_moved``)."""
        return sum(self.tier_bytes.values())

    @property
    def payload_bytes(self) -> int:
        """Logical bytes the plan delivers over the wire traffic."""
        per_tier = (self.payload_tier_bytes
                    if self.payload_tier_bytes is not None
                    else self.tier_bytes)
        return sum(per_tier.values())

    @property
    def bytes_saved(self) -> int:
        """Wire bytes compression removed (0 without an election)."""
        return self.payload_bytes - self.total_bytes

    @property
    def codec_time(self) -> float:
        """Seconds the plan spends in the codec (vs on the wire)."""
        return self.compress_time + self.decompress_time


def _add(bytes_: TierBytes, tier: LinkTier, nbytes: int) -> None:
    if nbytes:
        bytes_[tier.name] = bytes_.get(tier.name, 0) + int(nbytes)


class CollectivePlanner:
    """Plans broadcast/allgather/scatter over one topology + calibration.

    `topology` is the machine shape; `constants` any object with
    ``link_bw``/``link_latency`` (a `repro_torch.core.fabric.FabricConstants`)
    that tiers with unset bandwidth/latency inherit — how :data:`FLAT`
    reproduces every calibration's legacy numbers exactly.
    """

    def __init__(self, topology: Topology, constants) -> None:
        self.topology = topology
        self.constants = constants
        # active-codec state for the algorithm bodies, set (with
        # try/finally) only around a plan whose election is non-empty —
        # the raw path never consults a codec, so it stays bit-exact
        self._codec: Optional[Codec] = None
        self._elected: FrozenSet[str] = frozenset()

    # -- tier primitives ----------------------------------------------------
    def _bw(self, tier: LinkTier, concurrent: int = 1) -> float:
        """Effective per-transfer bandwidth: the link rate, shared under
        the tier's bisection cap when `concurrent` transfers cross it.

        A degraded tier (``scale < 1``, see `repro_torch.core.faults`) delivers
        the scaled rate; the healthy scale of exactly 1.0 skips the
        multiplication so zero-fault plans stay bit-exact."""
        bw = tier.bw if tier.bw is not None else self.constants.link_bw
        cap = tier.bisection_cap
        if tier.scale != 1.0:
            if tier.scale == 0.0:
                raise LinkPartitionedError(
                    f"link tier {tier.name!r} is partitioned (scale 0); "
                    f"no plan can cross it")
            bw *= tier.scale
            if cap is not None:
                cap *= tier.scale
        if cap is not None:
            bw = min(bw, cap / max(concurrent, 1))
        return bw

    def _lat(self, tier: LinkTier) -> float:
        return (tier.latency if tier.latency is not None
                else self.constants.link_latency)

    def _wire(self, tier: LinkTier, nbytes: int) -> int:
        """Bytes an `nbytes`-payload transfer puts on `tier`: the codec's
        compressed size on elected tiers, the payload itself otherwise.
        Applied PER TRANSFER (each message is compressed independently),
        so byte maps and step times stay consistent."""
        if self._codec is not None and tier.name in self._elected:
            return self._codec.compressed_size(nbytes)
        return nbytes

    def _xfer(self, tier: LinkTier, nbytes: int, concurrent: int = 1
              ) -> float:
        """Duration of `concurrent` simultaneous `nbytes`-payload
        transfers across `tier` (they overlap; the cap shares
        bandwidth). Wire size per transfer via :meth:`_wire`."""
        return self._wire(tier, nbytes) / self._bw(tier, concurrent) \
            + self._lat(tier)

    # -- compression election -----------------------------------------------
    def compression_wins(self, tier: LinkTier, codec: Optional[Codec],
                         nbytes: int) -> bool:
        """The closed-form per-tier decision: ship compressed on `tier`
        iff compress + decompress + compressed wire time beats raw wire
        time for one `nbytes` transfer —

            n/Cc + n/Cd + compressed_size(n)/bw_T  <  n/bw_T

        (the per-transfer latency appears on both sides and cancels).
        ``bw_T`` includes fault degradation, so a browned-out tier can
        flip the decision toward compression.  A partitioned tier is
        never elected (no plan can cross it anyway)."""
        if codec is None or codec.is_identity or nbytes <= 0:
            return False
        w = codec.compressed_size(nbytes)
        if w >= nbytes:
            return False
        try:
            bw = self._bw(tier, 1)
        except LinkPartitionedError:
            return False
        return (codec.compress_time(nbytes) + codec.decompress_time(nbytes)
                + w / bw < nbytes / bw)

    def compression_election(self, codec: Optional[Codec], nbytes: int
                             ) -> FrozenSet[str]:
        """Names of the topology tiers where :meth:`compression_wins`
        for an `nbytes` payload (the op's payload parameter — one
        decision per plan, applied to every transfer on the tier)."""
        if codec is None or codec.is_identity or nbytes <= 0:
            return frozenset()
        tiers = [self.topology.intra]
        if self.topology.inter is not None:
            tiers.append(self.topology.inter)
        return frozenset(t.name for t in tiers
                         if self.compression_wins(t, codec, nbytes))

    # -- shared building blocks ---------------------------------------------
    def _ring_bcast_piece(self, nbytes: int, m: int, tier: LinkTier,
                          concurrent: int = 1) -> float:
        """Pipelined ring broadcast of `nbytes` over `m` hosts all on one
        `tier`: stream once + (m-2) one-segment pipeline fills."""
        if m <= 1:
            return 0.0
        wire = self._wire(tier, nbytes)
        seg = min(wire, self.topology.seg_bytes)
        step = seg / self._bw(tier, concurrent) + self._lat(tier)
        return (wire / self._bw(tier, concurrent) + (m - 2) * step
                + self._lat(tier))

    def _tree_rounds(self, m: int) -> int:
        return int(math.ceil(math.log2(m))) if m > 1 else 0

    def _binomial_piece(self, m: int, size_of_round: Callable[[int], int],
                        tier_of_round: Callable[[int], Tuple[LinkTier, int]]
                        ) -> Tuple[float, TierBytes]:
        """Generic binomial schedule over `m` participants: round ``j``
        has ``min(2^j, m - 2^j)`` transfers of ``size_of_round(j)`` bytes
        on ``tier_of_round(j) -> (tier, crossing concurrency)``."""
        time, bytes_ = 0.0, {}
        for j in range(self._tree_rounds(m)):
            transfers = min(1 << j, m - (1 << j))
            size = size_of_round(j)
            tier, conc = tier_of_round(j)
            time += self._xfer(tier, size, concurrent=min(transfers, conc))
            _add(bytes_, tier, transfers * self._wire(tier, size))
        return time, bytes_

    def _round_tiers(self, m: int, inter_rounds: int
                     ) -> Callable[[int], Tuple[LinkTier, int]]:
        """Round -> tier map: the first `inter_rounds` rounds (largest
        strides) cross racks, the rest stay intra-rack."""
        topo = self.topology

        def tier_of(j: int) -> Tuple[LinkTier, int]:
            if j < inter_rounds and topo.inter is not None:
                return topo.inter, 1 << j
            return topo.intra, 1
        return tier_of

    # -- broadcast algorithms -----------------------------------------------
    def _bcast_pipelined_ring(self, nbytes: int, P: int
                              ) -> Tuple[float, TierBytes]:
        """The legacy ring generalized: rack-major host order, so P-1 hops
        of which R-1 cross racks; the pipeline rate is set by the slowest
        step (FLAT: exactly the pre-topology formula)."""
        topo = self.topology
        R, _ = topo.racks(P)
        crossings = R - 1
        candidates: List[Tuple[LinkTier, int]] = [(topo.intra, 1)]
        if crossings and topo.inter is not None:
            candidates.append((topo.inter, crossings))

        def seg_step(tc: Tuple[LinkTier, int]) -> float:
            seg = min(self._wire(tc[0], nbytes), topo.seg_bytes)
            return seg / self._bw(tc[0], tc[1]) + self._lat(tc[0])

        tier, conc = max(candidates, key=seg_step)
        wire = self._wire(tier, nbytes)
        seg = min(wire, topo.seg_bytes)
        step = seg / self._bw(tier, conc) + self._lat(tier)
        time = (wire / self._bw(tier, conc) + (P - 2) * step
                + self._lat(tier))
        bytes_: TierBytes = {}
        _add(bytes_, topo.intra,
             (P - 1 - crossings) * self._wire(topo.intra, nbytes))
        if crossings and topo.inter is not None:
            _add(bytes_, topo.inter,
                 crossings * self._wire(topo.inter, nbytes))
        return time, bytes_

    def _bcast_binomial_tree(self, nbytes: int, P: int
                             ) -> Tuple[float, TierBytes]:
        R, _ = self.topology.racks(P)
        inter_rounds = self._tree_rounds(R)
        return self._binomial_piece(P, lambda j: nbytes,
                                    self._round_tiers(P, inter_rounds))

    def _bcast_scatter_allgather(self, nbytes: int, P: int
                                 ) -> Tuple[float, TierBytes]:
        shard = -(-nbytes // P)
        t_sc, b_sc = self._scatter_binomial(nbytes, P)
        t_ag, b_ag = self._allgather_ring(shard, P)
        for k, v in b_ag.items():
            b_sc[k] = b_sc.get(k, 0) + v
        return t_sc + t_ag, b_sc

    def _bcast_hierarchical(self, nbytes: int, P: int
                            ) -> Tuple[float, TierBytes]:
        """Inter-rack binomial tree among rack leaders, then parallel
        intra-rack pipelined rings. Single rack: exactly the flat ring."""
        topo = self.topology
        R, H = topo.racks(P)
        if R <= 1 or topo.inter is None:
            return self._bcast_pipelined_ring(nbytes, P)
        t_tree, bytes_ = self._binomial_piece(
            R, lambda j: nbytes, lambda j: (topo.inter, 1 << j))
        t_ring = self._ring_bcast_piece(nbytes, H, topo.intra)
        _add(bytes_, topo.intra, (P - R) * nbytes)
        return t_tree + t_ring, bytes_

    # -- allgather algorithms -----------------------------------------------
    def _allgather_ring(self, shard: int, P: int) -> Tuple[float, TierBytes]:
        """The legacy ring: P-1 steps, every host forwarding one shard;
        with R racks, R of the P ring edges cross racks every step."""
        topo = self.topology
        R, _ = topo.racks(P)
        crossings = R if R > 1 else 0
        candidates: List[Tuple[LinkTier, int]] = [(topo.intra, 1)]
        if crossings and topo.inter is not None:
            candidates.append((topo.inter, crossings))
        step = max(self._xfer(t, shard, concurrent=c) for t, c in candidates)
        time = (P - 1) * step
        bytes_: TierBytes = {}
        _add(bytes_, topo.intra,
             (P - crossings) * (P - 1) * self._wire(topo.intra, shard))
        if crossings and topo.inter is not None:
            _add(bytes_, topo.inter,
                 crossings * (P - 1) * self._wire(topo.inter, shard))
        return time, bytes_

    def _allgather_hierarchical(self, shard: int, P: int
                                ) -> Tuple[float, TierBytes]:
        """Intra-rack ring all-gather, leader ring of rack blocks, then
        intra-rack broadcast of the foreign blocks. Single rack: the
        flat ring."""
        topo = self.topology
        R, H = topo.racks(P)
        if R <= 1 or topo.inter is None:
            return self._allgather_ring(shard, P)
        sizes = [H] * (P // H) + ([P % H] if P % H else [])
        bytes_: TierBytes = {}
        # phase 1: ring all-gather of `shard` inside every rack (parallel)
        t1 = (H - 1) * self._xfer(topo.intra, shard)
        _add(bytes_, topo.intra,
             sum(h * (h - 1) for h in sizes) * self._wire(topo.intra, shard))
        # phase 2: leader ring of rack blocks (every block crosses R-1x)
        t2 = (R - 1) * self._xfer(topo.inter, H * shard, concurrent=R)
        _add(bytes_, topo.inter,
             (R - 1) * sum(self._wire(topo.inter, h * shard) for h in sizes))
        # phase 3: broadcast the (P - h) foreign shards inside each rack;
        # the shortest rack receives the most, so it bounds the phase
        t3 = max(self._ring_bcast_piece((P - h) * shard, h, topo.intra)
                 for h in set(sizes))
        _add(bytes_, topo.intra,
             sum((h - 1) * self._wire(topo.intra, (P - h) * shard)
                 for h in sizes))
        return t1 + t2 + t3, bytes_

    # -- scatter algorithms --------------------------------------------------
    def _scatter_binomial(self, nbytes: int, P: int
                          ) -> Tuple[float, TierBytes]:
        """Halving rounds: round j moves ceil(n / 2^(j+1)) per transfer —
        total (P-1)/P of the buffer through the root's link."""
        R, _ = self.topology.racks(P)
        inter_rounds = self._tree_rounds(R)
        return self._binomial_piece(
            P, lambda j: -(-nbytes // (1 << (j + 1))),
            self._round_tiers(P, inter_rounds))

    def _scatter_hierarchical(self, nbytes: int, P: int
                              ) -> Tuple[float, TierBytes]:
        topo = self.topology
        R, H = topo.racks(P)
        if R <= 1 or topo.inter is None:
            return self._scatter_binomial(nbytes, P)
        t1, b1 = self._binomial_piece(
            R, lambda j: -(-nbytes // (1 << (j + 1))),
            lambda j: (topo.inter, 1 << j))
        block = -(-nbytes // R)
        t2, b2 = self._binomial_piece(
            H, lambda j: -(-block // (1 << (j + 1))),
            lambda j: (topo.intra, 1))
        for k, v in b2.items():
            b1[k] = b1.get(k, 0) + v * R          # every rack scatters
        return t1 + t2, b1

    # -- planning entrypoints -----------------------------------------------
    _ALGORITHMS: Dict[str, Dict[str, str]] = {
        "broadcast": {"pipelined_ring": "_bcast_pipelined_ring",
                      "binomial_tree": "_bcast_binomial_tree",
                      "scatter_allgather": "_bcast_scatter_allgather",
                      "hierarchical": "_bcast_hierarchical"},
        "allgather": {"ring": "_allgather_ring",
                      "hierarchical": "_allgather_hierarchical"},
        "scatter": {"binomial": "_scatter_binomial",
                    "hierarchical": "_scatter_hierarchical"},
    }

    def algorithms(self, op: str) -> List[str]:
        """The algorithm names this planner knows for `op`."""
        return list(self._ALGORITHMS[op])

    def _codec_charges(self, op: str, codec: Codec, nbytes: int,
                       n_hosts: int) -> Tuple[float, float]:
        """Once-per-plan codec edge charges ``(compress, decompress)``.

        Compress happens at the sending edge(s), decompress at the
        receiving edge(s); edges working in parallel overlap, so each
        side charges its serialized per-edge payload:

          broadcast  — root compresses `n`, every receiver decompresses
                       `n` in parallel.
          allgather  — every host compresses its own shard in parallel,
                       then decompresses the P-1 foreign shards.
          scatter    — the root compresses the full buffer, every
                       receiver decompresses its 1/P shard in parallel.

        The charges depend only on the op and payload — NOT on the
        algorithm — so adding them after best-by-wire-time selection
        preserves the algorithm ordering."""
        if op == "broadcast":
            return codec.compress_time(nbytes), codec.decompress_time(nbytes)
        if op == "allgather":
            return (codec.compress_time(nbytes),
                    (n_hosts - 1) * codec.decompress_time(nbytes))
        if op == "scatter":
            shard = -(-nbytes // n_hosts)
            return codec.compress_time(nbytes), codec.decompress_time(shard)
        raise ValueError(f"no codec charge model for op {op!r}")

    def _plan(self, op: str, nbytes: int, n_hosts: int,
              algorithm: Optional[str], dead: int = 0,
              codec: Optional[Codec] = None) -> CollectivePlan:
        if nbytes < 0:
            raise ValueError(f"{op} payload must be >= 0 bytes, "
                             f"got {nbytes}")
        if op not in self._ALGORITHMS:
            raise ValueError(f"unknown collective {op!r}; planner knows: "
                             f"{', '.join(self._ALGORITHMS)}")
        if dead < 0:
            raise ValueError(f"dead host count must be >= 0, got {dead}")
        if n_hosts <= 1:
            # a single host (or none) moves nothing — every algorithm
            # degenerates to the empty plan
            return CollectivePlan(op=op, algorithm=algorithm or "none",
                                  nbytes=nbytes, n_hosts=n_hosts, time=0.0,
                                  rerouted=dead,
                                  codec=codec.name if codec else "none")
        if algorithm is None:
            algorithm = self.topology.pinned_algorithms.get(op)
        table = self._ALGORITHMS[op]
        if algorithm is not None:
            if algorithm not in table:
                raise ValueError(
                    f"unknown {op} algorithm {algorithm!r}; available: "
                    f"{', '.join(table)}")
            names = [algorithm]
        else:
            names = list(table)
        elected = self.compression_election(codec, nbytes)
        active = codec if elected else None
        best: Optional[CollectivePlan] = None
        if active is not None:
            self._codec, self._elected = active, elected
        try:
            for name in names:
                time, bytes_ = getattr(self, table[name])(nbytes, n_hosts)
                plan = CollectivePlan(op=op, algorithm=name, nbytes=nbytes,
                                      n_hosts=n_hosts, time=time,
                                      tier_bytes=bytes_)
                if best is None or plan.time < best.time:
                    best = plan
        finally:
            if active is not None:
                self._codec, self._elected = None, frozenset()
        # only tiers that actually carry bytes in this plan pay (or win)
        # anything: an elected-but-idle tier (e.g. the wan tier under a
        # single-rack fan-out broadcast) must not charge codec time
        used = (frozenset(t for t, b in best.tier_bytes.items() if b)
                & elected) if active is not None else frozenset()
        if used:
            # the same algorithm run raw gives the logical (payload)
            # traffic the wire bytes stand in for
            _, payload = getattr(self, table[best.algorithm])(nbytes,
                                                              n_hosts)
            best.payload_tier_bytes = payload
            best.compress_time, best.decompress_time = self._codec_charges(
                op, active, nbytes, n_hosts)
            best.time += best.compress_time + best.decompress_time
            best.codec = active.name
            best.compressed_tiers = tuple(sorted(used))
        elif codec is not None:
            best.codec = codec.name    # requested but no tier elected: raw
        if dead:
            # re-routing cost of repairing the ring/tree schedule around
            # the dead hosts: each skip splices one extra intra-tier hop
            # into the schedule's critical path (the payload itself is
            # already planned over the LIVE host count only)
            best.time += dead * self._lat(self.topology.intra)
            best.rerouted = dead
        return best

    def plan_broadcast(self, nbytes: int, n_hosts: int,
                       algorithm: Optional[str] = None,
                       dead: int = 0,
                       codec: Optional[Codec] = None) -> CollectivePlan:
        """Plan a one-root broadcast of `nbytes` to `n_hosts` LIVE hosts;
        `dead` skipped hosts add re-routing latency to the schedule.
        `codec` enables per-tier compress-at-source election."""
        return self._plan("broadcast", nbytes, n_hosts, algorithm, dead,
                          codec=codec)

    def plan_allgather(self, shard_bytes: int, n_hosts: int,
                       algorithm: Optional[str] = None,
                       dead: int = 0,
                       codec: Optional[Codec] = None) -> CollectivePlan:
        """Plan an all-gather where each of `n_hosts` LIVE hosts
        contributes `shard_bytes`; `dead` adds re-routing latency.
        `codec` enables per-tier compress-at-source election."""
        return self._plan("allgather", shard_bytes, n_hosts, algorithm, dead,
                          codec=codec)

    def plan_scatter(self, total_bytes: int, n_hosts: int,
                     algorithm: Optional[str] = None,
                     dead: int = 0,
                     codec: Optional[Codec] = None) -> CollectivePlan:
        """Plan a root scatter of `total_bytes` into 1/P shards over the
        LIVE hosts; `dead` adds re-routing latency. `codec` enables
        per-tier compress-at-source election."""
        return self._plan("scatter", total_bytes, n_hosts, algorithm, dead,
                          codec=codec)

    def plan_replichain(self, stripe_bytes: int, n_hosts: int,
                        replication: int,
                        codec: Optional[Codec] = None) -> CollectivePlan:
        """Plan R-way chained stripe replication: after the striped read,
        every host forwards its stripe to its successor for R-1 pipelined
        rounds (chained declustering), leaving stripe ``i`` resident on
        hosts ``i .. i+R-1 (mod P)``.

        Each round is P concurrent `stripe_bytes` transfers on the ring;
        with R_racks racks, R_racks of the P ring edges cross racks every
        round (same geometry as the ring all-gather)."""
        if not 1 <= replication <= max(n_hosts, 1):
            raise ValueError(
                f"replication must be in [1, n_hosts={n_hosts}], "
                f"got {replication}")
        topo = self.topology
        rounds = replication - 1
        if n_hosts <= 1 or rounds == 0 or stripe_bytes == 0:
            return CollectivePlan(op="replichain", algorithm="ring",
                                  nbytes=stripe_bytes, n_hosts=n_hosts,
                                  time=0.0,
                                  codec=codec.name if codec else "none")
        R, _ = topo.racks(n_hosts)
        crossings = R if R > 1 else 0
        candidates: List[Tuple[LinkTier, int]] = [(topo.intra, 1)]
        if crossings and topo.inter is not None:
            candidates.append((topo.inter, crossings))
        # restrict the election to tiers this chain actually crosses (the
        # candidates carrying > 0 transfers), so an elected-but-idle tier
        # never charges codec time or skews the step max
        carrying = {t.name for t, _ in candidates
                    if t is not topo.intra or n_hosts - crossings > 0}
        elected = frozenset(
            t for t in self.compression_election(codec, stripe_bytes)
            if t in carrying)
        active = codec if elected else None
        if active is not None:
            self._codec, self._elected = active, elected
        try:
            step = max(self._xfer(t, stripe_bytes, concurrent=c)
                       for t, c in candidates)
            bytes_: TierBytes = {}
            _add(bytes_, topo.intra,
                 rounds * (n_hosts - crossings)
                 * self._wire(topo.intra, stripe_bytes))
            if crossings and topo.inter is not None:
                _add(bytes_, topo.inter,
                     rounds * crossings * self._wire(topo.inter,
                                                     stripe_bytes))
        finally:
            if active is not None:
                self._codec, self._elected = None, frozenset()
        plan = CollectivePlan(op="replichain", algorithm="ring",
                              nbytes=stripe_bytes, n_hosts=n_hosts,
                              time=rounds * step, tier_bytes=bytes_)
        if active is not None:
            payload: TierBytes = {}
            _add(payload, topo.intra,
                 rounds * (n_hosts - crossings) * stripe_bytes)
            if crossings and topo.inter is not None:
                _add(payload, topo.inter, rounds * crossings * stripe_bytes)
            plan.payload_tier_bytes = payload
            # every host compresses its stripe once (parallel); each of
            # the R-1 forwarding rounds lands one stripe to decompress
            plan.compress_time = active.compress_time(stripe_bytes)
            plan.decompress_time = rounds * active.decompress_time(
                stripe_bytes)
            plan.time += plan.compress_time + plan.decompress_time
            plan.codec = active.name
            plan.compressed_tiers = tuple(sorted(elected))
        elif codec is not None:
            plan.codec = codec.name
        return plan

    def plan_repair(self, transfers: List[Tuple[int, int, int]],
                    n_hosts: int) -> CollectivePlan:
        """Plan an explicit point-to-point repair schedule: `transfers` is
        ``[(src_host, dst_host, nbytes), ...]`` in issue order.

        Each host's NIC serializes its transfers (a busy-line per host);
        transfers between different host pairs overlap. The tier of each
        transfer follows rack membership (rack-major placement, as in
        :meth:`~repro_torch.core.topology.Topology.racks`). The duration is the
        makespan of the schedule — deterministic in the transfer order."""
        topo = self.topology
        hpr = topo.hosts_per_rack
        busy: Dict[int, float] = {}
        t_done = 0.0
        bytes_: TierBytes = {}
        total = 0
        for src, dst, nbytes in transfers:
            if topo.is_flat or (src // hpr) == (dst // hpr):
                tier = topo.intra
            else:
                tier = topo.inter
            start = max(busy.get(src, 0.0), busy.get(dst, 0.0))
            end = start + self._xfer(tier, nbytes)
            busy[src] = busy[dst] = end
            t_done = max(t_done, end)
            _add(bytes_, tier, nbytes)
            total += nbytes
        return CollectivePlan(op="repair", algorithm="p2p_reroute",
                              nbytes=total, n_hosts=n_hosts, time=t_done,
                              tier_bytes=bytes_)

    def plan_point_to_point(self, nbytes: int, attempts: int = 1,
                            codec: Optional[Codec] = None) -> CollectivePlan:
        """One off-machine message (detector NIC -> leader host) over the
        topology's ingest tier.

        `attempts` models stop-and-wait retransmission on a lossy WAN
        hop (`repro_torch.core.wan`): each attempt serializes the full payload
        plus one tier latency, so time and ingest-tier bytes both scale
        by `attempts`.  The default of 1 keeps the plan identical to the
        lossless path (algorithm ``"direct"``); retries are labeled
        ``"retransmit"`` so traces and plan dumps show them.  A tier at
        scale 0 is a partition, not loss — no number of attempts crosses
        it, and :class:`LinkPartitionedError` propagates from `_bw`.

        With a `codec` elected on the ingest tier, every attempt re-sends
        the COMPRESSED frame (the sender keeps the compressed buffer, so
        compress is charged once, not per retry) — the wire-byte win
        compounds with retransmission on the lossy WAN pipe."""
        if nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {nbytes}")
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        tier = self.topology.ingest_tier
        algo = "direct" if attempts == 1 else "retransmit"
        elected = self.compression_election(codec, nbytes)
        active = codec if tier.name in elected else None
        if active is not None:
            self._codec, self._elected = active, elected
        try:
            t_wire = attempts * self._xfer(tier, nbytes)
            wire = self._wire(tier, nbytes)
        finally:
            if active is not None:
                self._codec, self._elected = None, frozenset()
        plan = CollectivePlan(op="point_to_point", algorithm=algo,
                              nbytes=nbytes, n_hosts=1, time=t_wire)
        _add(plan.tier_bytes, tier, attempts * wire)
        if active is not None:
            payload: TierBytes = {}
            _add(payload, tier, attempts * nbytes)
            plan.payload_tier_bytes = payload
            plan.compress_time = active.compress_time(nbytes)
            plan.decompress_time = active.decompress_time(nbytes)
            plan.time += plan.compress_time + plan.decompress_time
            plan.codec = active.name
            plan.compressed_tiers = (tier.name,)
        elif codec is not None:
            plan.codec = codec.name
        return plan
