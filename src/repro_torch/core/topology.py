"""Hierarchical interconnect topology (hosts -> racks -> cluster).

The paper's headline result was measured on a 5D-torus Blue Gene/Q; the
follow-on streaming literature (Welborn et al., Perlmutter detector
streaming; Poeschel et al., openPMD/ADIOS2 pipelines) shows delivery cost
is dominated by WHICH NETWORK TIER the bytes cross. A flat per-link model
cannot express that, so the communication model is layered:

  * this module — the pure machine description: :class:`LinkTier`
    (bandwidth, latency, optional bisection cap per tier) and
    :class:`Topology` (hosts grouped into racks/pods, one intra-rack and
    one optional inter-rack tier, plus the pipeline segment size);
  * `repro_torch.core.collectives` — the :class:`~repro_torch.core.collectives.
    CollectivePlanner` that turns a topology into explicit collective
    algorithms with per-tier byte accounting;
  * `repro_torch.core.fabric.Interconnect` — executes planned collectives and
    accumulates the per-tier traffic counters.

Canned instances:

  * :data:`FLAT` — the backward-compatibility anchor: one tier whose
    bandwidth/latency INHERIT the fabric's ``link_bw``/``link_latency``
    constants, with the legacy ring algorithms pinned, so a FLAT fabric
    reproduces the pre-topology accounting bit-for-bit.
  * :data:`BGQ_TORUS` — Blue Gene/Q flavored: 512-node midplanes on 5D
    torus links, optical inter-midplane links with a bisection cap.
  * :data:`TPU_POD_ICI_DCN` — TPU-pod flavored: 64-host ICI slices,
    DCN between slices.

:class:`TopologyConfig` is the typed, JSON-serializable selector that
rides on the `repro_torch.core.api` engine configs (name into
:data:`TOPOLOGIES` + per-field overrides).

Units: bandwidths bytes/s, latencies SIMULATED seconds (see
`repro_torch.core.fabric` for the sim-vs-wall discipline), sizes bytes.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Tuple, Union


@dataclass(frozen=True)
class LinkTier:
    """One class of links in the machine.

    ``bw``/``latency`` of ``None`` inherit the fabric's calibrated
    ``link_bw``/``link_latency`` at planning time (how :data:`FLAT` stays
    calibration-agnostic). ``bisection_cap`` is the AGGREGATE bytes/s the
    tier's cut sustains: when ``concurrent`` transfers would exceed it,
    they share the cap instead of each getting a full link.

    ``scale`` is the fault-injection degradation multiplier (see
    `repro_torch.core.faults`): the tier delivers ``scale`` times its healthy
    bandwidth (and bisection cap). Healthy tiers carry the default 1.0 and
    the planner skips the multiplication entirely, so zero-fault plans are
    bit-exact with the pre-fault model."""
    name: str
    bw: Optional[float] = None           # bytes/s per link (None: inherit)
    latency: Optional[float] = None      # s per message (None: inherit)
    bisection_cap: Optional[float] = None  # aggregate bytes/s across the cut
    scale: float = 1.0                   # degradation multiplier in (0, 1]

    def __post_init__(self) -> None:
        if not 0.0 <= self.scale <= 1.0:
            raise ValueError(
                f"tier scale must be in [0, 1], got {self.scale}")


@dataclass(frozen=True)
class Topology:
    """A two-level machine: hosts grouped into racks (pods/midplanes).

    ``hosts_per_rack <= 0`` (or ``inter is None``) means every host sits
    in ONE rack — the flat machine. ``pinned_algorithms`` maps a
    collective op name (``"broadcast"``/``"allgather"``/``"scatter"``) to
    a fixed algorithm, bypassing cost-model selection — :data:`FLAT` pins
    the legacy ring algorithms so it stays a numeric regression anchor.
    ``seg_bytes`` is the pipeline segment used by ring broadcasts."""
    name: str
    hosts_per_rack: int = 0
    intra: LinkTier = field(default_factory=lambda: LinkTier("link"))
    inter: Optional[LinkTier] = None
    seg_bytes: int = 1 << 20
    pinned_algorithms: Mapping[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.seg_bytes <= 0:
            raise ValueError(
                f"seg_bytes must be a positive pipeline segment size in "
                f"bytes, got {self.seg_bytes}")
        # freeze the mapping so canned instances are safely shareable
        object.__setattr__(self, "pinned_algorithms",
                           dict(self.pinned_algorithms))

    @property
    def is_flat(self) -> bool:
        """True when the machine has a single tier (one rack)."""
        return self.inter is None or self.hosts_per_rack <= 0

    def racks(self, n_hosts: int) -> Tuple[int, int]:
        """``(n_racks, max_rack_hosts)`` for a job spanning `n_hosts`.

        The flat machine is one rack of everything; otherwise hosts fill
        racks in order (rack-major placement), the last rack possibly
        short. ``max_rack_hosts`` is what parallel intra-rack phases are
        charged for (the fullest rack dominates)."""
        if n_hosts <= 0:
            return 0, 0
        if self.is_flat or n_hosts <= self.hosts_per_rack:
            return 1, n_hosts
        h = self.hosts_per_rack
        return -(-n_hosts // h), h

    @property
    def ingest_tier(self) -> LinkTier:
        """The tier an off-machine point-to-point hop (detector NIC ->
        leader host) crosses: the outermost tier present."""
        return self.inter if self.inter is not None else self.intra

    def tier_names(self) -> Tuple[str, ...]:
        if self.inter is None:
            return (self.intra.name,)
        return (self.intra.name, self.inter.name)

    def degraded(self, factors: Mapping[str, float]) -> "Topology":
        """A copy with the named tiers' ``scale`` multiplied by `factors`
        (fault-injection brownouts; see `repro_torch.core.faults.FaultSchedule.
        tier_factors`). Unknown tier names are ignored; an empty mapping
        returns ``self`` unchanged so the healthy path shares the canned
        instance."""
        if not factors:
            return self
        intra, inter = self.intra, self.inter
        if intra.name in factors:
            intra = replace(intra, scale=intra.scale * factors[intra.name])
        if inter is not None and inter.name in factors:
            inter = replace(inter, scale=inter.scale * factors[inter.name])
        if intra is self.intra and inter is self.inter:
            return self
        return replace(self, intra=intra, inter=inter)


# -- canned machines ---------------------------------------------------------

#: Backward-compat anchor: one tier inheriting the fabric link constants,
#: legacy ring algorithms pinned — numerically identical to the
#: pre-topology ``Interconnect`` accounting on every calibration.
FLAT = Topology(
    name="flat",
    pinned_algorithms={"broadcast": "pipelined_ring", "allgather": "ring",
                       "scatter": "binomial"},
)

#: Blue Gene/Q flavored 5D torus: 512-node midplanes on torus links,
#: optical inter-midplane links (higher latency, capped bisection).
BGQ_TORUS = Topology(
    name="bgq_torus",
    hosts_per_rack=512,
    intra=LinkTier("torus", bw=2e9, latency=2.5e-6),
    inter=LinkTier("optical", bw=2e9, latency=6e-6, bisection_cap=64e9),
)

#: TPU-pod flavored: 64-host ICI slices, DCN between slices.
TPU_POD_ICI_DCN = Topology(
    name="tpu_pod_ici_dcn",
    hosts_per_rack=64,
    intra=LinkTier("ici", bw=50e9, latency=1e-6),
    inter=LinkTier("dcn", bw=12.5e9, latency=1e-5, bisection_cap=400e9),
)

#: Cross-facility beamline: the detector lives OUTSIDE the machine, across
#: a wide-area tier (Welborn et al.'s detector -> Perlmutter push). The
#: whole compute pod sits in one 4096-host "rack" on cluster links, so any
#: job P <= 4096 collapses to a single rack — every delivery collective
#: (scatter/broadcast fan-out) stays on the fast ``cluster`` tier — while
#: the off-machine ingest hop (:attr:`Topology.ingest_tier`) crosses the
#: ``wan`` tier: ~10 Gb/s, 25 ms RTT-class latency, bisection-capped at
#: the link rate (one far-away pipe, not a fat fabric). WAN weather
#: (seeded jitter, brownouts) rides `repro_torch.core.faults.FaultSchedule.
#: wan_jitter` windows scaling this tier (`repro_torch.core.wan`).
WAN_BEAMLINE = Topology(
    name="wan_beamline",
    hosts_per_rack=4096,
    intra=LinkTier("cluster", bw=2e9, latency=2.5e-6),
    inter=LinkTier("wan", bw=1.25e9, latency=25e-3, bisection_cap=1.25e9),
)

#: Name -> canned :class:`Topology` — what :class:`TopologyConfig`
#: resolves against. Custom machines register here once.
TOPOLOGIES: Dict[str, Topology] = {
    t.name: t for t in (FLAT, BGQ_TORUS, TPU_POD_ICI_DCN, WAN_BEAMLINE)
}


@dataclass(frozen=True)
class TopologyConfig:
    """Typed, JSON-serializable topology selector for engine configs.

    ``name`` picks a canned machine from :data:`TOPOLOGIES`;
    ``hosts_per_rack``/``seg_bytes`` optionally override it (e.g. model a
    half-populated midplane without defining a new machine). Rides the
    `repro_torch.core.api` engine configs and round-trips through spec JSON."""
    name: str = "flat"
    hosts_per_rack: Optional[int] = None
    seg_bytes: Optional[int] = None

    def __post_init__(self) -> None:
        if self.name not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.name!r}; available: "
                f"{', '.join(sorted(TOPOLOGIES))}")
        if self.hosts_per_rack is not None and self.hosts_per_rack <= 0:
            raise ValueError(
                f"hosts_per_rack override must be positive, got "
                f"{self.hosts_per_rack}")
        if self.seg_bytes is not None and self.seg_bytes <= 0:
            raise ValueError(
                f"seg_bytes override must be positive, got {self.seg_bytes}")

    def resolve(self) -> Topology:
        """The concrete :class:`Topology` this config selects."""
        topo = TOPOLOGIES[self.name]
        overrides = {}
        if self.hosts_per_rack is not None:
            overrides["hosts_per_rack"] = self.hosts_per_rack
        if self.seg_bytes is not None:
            overrides["seg_bytes"] = self.seg_bytes
        return replace(topo, **overrides) if overrides else topo

    def to_dict(self) -> Dict[str, Any]:
        """Primitive dict for JSON round-trips (drops None overrides)."""
        return {k: v for k, v in asdict(self).items() if v is not None}

    @classmethod
    def coerce(cls, value: "TopologyLike") -> "TopologyConfig":
        """Normalize a loose topology spelling to a config: a config
        passes through; a name string or a JSON dict builds one; a canned
        :class:`Topology` is matched back to its registered name."""
        if isinstance(value, TopologyConfig):
            return value
        if isinstance(value, str):
            return cls(name=value)
        if isinstance(value, Mapping):
            return cls(**value)
        if isinstance(value, Topology):
            reg = TOPOLOGIES.get(value.name)
            if reg is not None:
                overrides = {}
                if value.hosts_per_rack != reg.hosts_per_rack:
                    overrides["hosts_per_rack"] = value.hosts_per_rack
                if value.seg_bytes != reg.seg_bytes:
                    overrides["seg_bytes"] = value.seg_bytes
                if replace(reg, **overrides) == value:
                    # the instance is the registered machine, possibly
                    # with overrides a config can carry — keep them
                    return cls(name=value.name, **overrides)
            raise ValueError(
                f"topology {value.name!r} is not the registered instance "
                f"(or differs in fields a TopologyConfig cannot carry — "
                f"tiers, pinned algorithms); register it in TOPOLOGIES to "
                f"reference it from a TopologyConfig, or bind it to the "
                f"fabric directly (Fabric(..., topology=<Topology>))")
        raise TypeError(
            f"cannot coerce {type(value).__name__} to a TopologyConfig "
            f"(expected a TopologyConfig, a topology name, a dict, or a "
            f"registered Topology)")


TopologyLike = Union[Topology, TopologyConfig, str, Mapping, None]


def resolve_topology(value: TopologyLike) -> Topology:
    """Any loose topology spelling -> a concrete :class:`Topology`
    (``None`` means :data:`FLAT`, the backward-compat default)."""
    if value is None:
        return FLAT
    if isinstance(value, Topology):
        return value
    return TopologyConfig.coerce(value).resolve()
