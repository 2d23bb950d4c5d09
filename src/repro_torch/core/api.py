"""Unified staging client API: typed engine configs, a pluggable engine
registry, and session-scoped campaigns.

The paper exposes staging to scientists through ONE declarative surface
(the Swift I/O hook of Fig. 6 over the MPI-IO staging library). After the
one-shot engines (`repro_torch.core.staging`), streamed ingestion
(`repro_torch.core.streaming`) and the multi-tenant catalog
(`repro_torch.core.datasvc`) grew their own entrypoints, that surface had
fractured into mode strings, untyped ``stage_kw`` dicts, a legacy
``collective`` boolean and a module-level engine table duplicated across
consumers. This module re-unifies it — the shape the streaming-pipeline
literature converges on (openPMD/ADIOS2 engine-agnostic APIs with
pluggable transports selected by typed config; the Perlmutter
detector-streaming client hiding batch-vs-stream delivery):

  * **Typed engine configs** — :class:`CollectiveConfig`,
    :class:`PipelinedConfig`, :class:`NaiveConfig`,
    :class:`ReplicatedConfig`, :class:`StreamConfig`,
    :class:`WanStreamConfig` and
    :class:`ServiceConfig`: one frozen dataclass per engine, validated
    in ``__post_init__`` (no more silently-ignored ``stage_kw`` typos).
    Each carries an optional :class:`FaultConfig` — a what-if fault
    timeline scoped to that stage; live faults go through
    :meth:`StagingClient.inject` (see `repro_torch.core.faults`).
  * **EngineRegistry** — name -> (config type, stage fn). The single
    source of truth for the mode -> engine mapping (replaces the old
    ``BATCH_STAGE_FNS`` table that was consumed by ``staging``/``iohook``/
    ``hedm`` separately). Adding an engine is ONE ``register`` call — the
    hook, the client, the dataset service and the HEDM runners all pick it
    up from here.
  * **StagingClient** — the facade: ``client.stage(spec_or_patterns,
    config)`` drives any one-shot engine, streamed delivery
    (:meth:`StagingClient.stream_stager`) or catalog-backed acquisition
    (a :class:`ServiceConfig` / an attached
    :class:`~repro_torch.core.datasvc.StagingService`) and always returns one
    unified :class:`Report`.
  * **Session-scoped campaigns** — ``with client.session(name) as s:``
    auto-releases every lease the session still holds on exit (even under
    an exception), killing the forgotten-``service.release(...)`` wedge
    footgun of the raw catalog API.
  * **Topology-aware transport** — every built-in engine config carries a
    ``topology`` field (a typed `repro_torch.core.topology.TopologyConfig`,
    JSON round-trippable): the stage's collectives are planned over that
    machine model by the `repro_torch.core.collectives.CollectivePlanner`
    (exposed as :attr:`StagingClient.planner`), with per-tier wire
    traffic in the report's ``tier_bytes``.

`repro_torch.core.iohook.run_io_hook` remains as a thin deprecation shim over
the client (``mode``/``collective``/``stage_kw`` honored), and
:class:`StagingSpec`/:class:`BroadcastEntry` live here now (re-exported
from ``iohook`` for compatibility). All times are SIMULATED seconds (see
`repro_torch.core.fabric`); replicas move real bytes and stay byte-exact.
"""
from __future__ import annotations

import json
import math
import os
import warnings
from dataclasses import dataclass, field, fields
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

from repro_torch.core.collectives import CollectivePlan, CollectivePlanner  # noqa: F401 (re-export)
from repro_torch.core.compression import (CODECS, Codec,  # noqa: F401 (re-export)
                                    CompressionConfig, CompressionStats,
                                    resolve_codec)
from repro_torch.core.fabric import Fabric
from repro_torch.core.faults import FaultEvent, FaultKind, FaultSchedule
from repro_torch.core.staging import (StagingReport, stage_collective, stage_naive,
                                stage_pipelined, stage_replicated)
from repro_torch.core.streaming import StreamStager, stage_stream
from repro_torch.core.wan import stage_wan
from repro_torch.core.telemetry import (NULL_TRACER, Tracer,  # noqa: F401
                                  TracerLike, flight_recorder,
                                  write_chrome_trace)
from repro_torch.core.topology import (BGQ_TORUS, FLAT, TOPOLOGIES,  # noqa: F401
                                 TPU_POD_ICI_DCN, Topology, TopologyConfig,
                                 resolve_topology)


# ---------------------------------------------------------------------------
# typed engine configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultConfig:
    """Typed, JSON-serializable fault-injection selector for engine
    configs (`repro_torch.core.faults`).

    Explicit events — ``host_deaths``/``host_recoveries`` are
    ``(t, host)`` pairs, ``degradations`` are ``(tier, t, t_end, factor)``
    brownout windows — plus an optional seeded random layer (``seed``
    with ``random_deaths`` deaths drawn over ``[0, horizon)`` by
    `repro_torch.core.faults.FaultSchedule.random`). :meth:`build` materializes
    the concrete :class:`~repro_torch.core.faults.FaultSchedule` for a fabric
    of ``n_hosts``.

    A config-level schedule is a WHAT-IF timing overlay scoped to one
    stage call (bound via ``Interconnect.scoped_faults``): collectives
    re-route around the dead, degraded tiers slow the wire, deliveries
    skip dead hosts — but no node-local store is wiped. State-changing
    live injection is the :meth:`StagingClient.inject` /
    ``Fabric.kill_host`` path. The default (no events, no seed) builds
    the trivial schedule — bit-exact zero-fault accounting."""
    host_deaths: Tuple[Tuple[float, int], ...] = ()
    host_recoveries: Tuple[Tuple[float, int], ...] = ()
    degradations: Tuple[Tuple[str, float, float, float], ...] = ()
    seed: Optional[int] = None
    random_deaths: int = 0
    horizon: float = 60.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "host_deaths", tuple(
            (float(t), int(h)) for t, h in self.host_deaths))
        object.__setattr__(self, "host_recoveries", tuple(
            (float(t), int(h)) for t, h in self.host_recoveries))
        object.__setattr__(self, "degradations", tuple(
            (str(tier), float(t), float(t_end), float(f))
            for tier, t, t_end, f in self.degradations))
        if (self.seed is None) != (self.random_deaths == 0):
            raise ValueError(
                "seed and random_deaths select the seeded random fault "
                "layer together: give both (seed=..., random_deaths>=1) "
                "or neither")
        if self.random_deaths < 0:
            raise ValueError(
                f"random_deaths must be >= 0, got {self.random_deaths}")
        if self.horizon <= 0:
            raise ValueError(
                f"horizon must be a positive window in simulated seconds, "
                f"got {self.horizon}")

    def build(self, n_hosts: int) -> FaultSchedule:
        """The concrete fault timeline for a fabric of `n_hosts` hosts
        (validation of hosts/windows happens in ``FaultEvent``)."""
        events = [FaultEvent(t, FaultKind.HOST_DEATH, host=h)
                  for t, h in self.host_deaths]
        events += [FaultEvent(t, FaultKind.HOST_RECOVERY, host=h)
                   for t, h in self.host_recoveries]
        events += [FaultEvent(t, FaultKind.LINK_DEGRADE, tier=tier,
                              t_end=t_end, factor=f)
                   for tier, t, t_end, f in self.degradations]
        sched = FaultSchedule(events)
        if self.seed is not None:
            for ev in FaultSchedule.random(self.seed, n_hosts, self.horizon,
                                           n_deaths=self.random_deaths
                                           ).events:
                sched.inject(ev)
        return sched

    def to_dict(self) -> Dict[str, Any]:
        """Primitive dict for JSON round-trips (drops empty layers)."""
        out: Dict[str, Any] = {}
        if self.host_deaths:
            out["host_deaths"] = [list(p) for p in self.host_deaths]
        if self.host_recoveries:
            out["host_recoveries"] = [list(p) for p in self.host_recoveries]
        if self.degradations:
            out["degradations"] = [list(d) for d in self.degradations]
        if self.seed is not None:
            out["seed"] = self.seed
            out["random_deaths"] = self.random_deaths
            out["horizon"] = self.horizon
        return out

    @classmethod
    def coerce(cls, value: Union["FaultConfig", Mapping]) -> "FaultConfig":
        """Normalize a loose faults spelling (a config passes through, a
        JSON dict builds one) — the ``topology``-field pattern."""
        if isinstance(value, FaultConfig):
            return value
        if isinstance(value, Mapping):
            return cls(**value)
        raise TypeError(
            f"cannot coerce {type(value).__name__} to a FaultConfig "
            f"(expected a FaultConfig or a dict)")


@dataclass(frozen=True)
class EngineConfig:
    """Base class for one-shot staging engine configs.

    Subclasses are frozen dataclasses: one field per engine parameter,
    validated in ``__post_init__`` with a clear message — the typed
    replacement for the old untyped ``stage_kw`` dict. ``to_kw()`` maps
    the fields onto the engine function's keyword arguments.

    A subclass that declares a ``topology`` field gets loose spellings
    (a canned name, a JSON dict, a registered
    `repro_torch.core.topology.Topology`) coerced to a typed
    :class:`~repro_torch.core.topology.TopologyConfig` here, a ``faults``
    field likewise to a :class:`FaultConfig`, and a ``compression``
    field (a codec name, mapping, or `repro_torch.core.compression.Codec`) to
    a typed :class:`~repro_torch.core.compression.CompressionConfig` —
    subclasses with their own ``__post_init__`` must call
    ``super().__post_init__()``. ``faults``
    is EXCLUDED from ``to_kw()``: it configures the fabric-side scope
    the stage runs under (``Interconnect.scoped_faults``), not an engine
    function parameter.
    """

    def __post_init__(self) -> None:
        topo = getattr(self, "topology", None)
        if topo is not None and not isinstance(topo, TopologyConfig):
            object.__setattr__(self, "topology", TopologyConfig.coerce(topo))
        flt = getattr(self, "faults", None)
        if flt is not None and not isinstance(flt, FaultConfig):
            object.__setattr__(self, "faults", FaultConfig.coerce(flt))
        comp = getattr(self, "compression", None)
        if comp is not None and not isinstance(comp, CompressionConfig):
            object.__setattr__(self, "compression",
                               CompressionConfig.coerce(comp))

    def to_kw(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name != "faults"}


@dataclass(frozen=True)
class CollectiveConfig(EngineConfig):
    """Two-phase ``MPI_File_read_all`` staging (leader stripes + planned
    all-gather) — `repro_torch.core.staging.stage_collective`. ``topology``
    selects the machine model the collectives are planned over for this
    stage (``None``: whatever the fabric runs — FLAT by default);
    ``faults`` optionally overlays a what-if :class:`FaultConfig` for
    this stage only; ``compression`` selects a codec for per-tier
    compress-at-source election (``None``: ship raw — bit-exact legacy
    path)."""
    topology: Optional[TopologyConfig] = None
    faults: Optional[FaultConfig] = None
    compression: Optional[CompressionConfig] = None


@dataclass(frozen=True)
class PipelinedConfig(EngineConfig):
    """Chunked two-phase staging with read/all-gather overlap
    (`repro_torch.core.staging.stage_pipelined`). ``chunk_bytes`` is the
    per-host segment size: smaller chunks overlap finer but round more;
    ``topology``/``faults``/``compression`` as on
    :class:`CollectiveConfig`."""
    chunk_bytes: int = 8 << 20
    topology: Optional[TopologyConfig] = None
    faults: Optional[FaultConfig] = None
    compression: Optional[CompressionConfig] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.chunk_bytes <= 0:
            raise ValueError(
                f"chunk_bytes must be a positive per-host segment size in "
                f"bytes, got {self.chunk_bytes}")


@dataclass(frozen=True)
class NaiveConfig(EngineConfig):
    """Uncoordinated per-host full reads — the paper's congested baseline
    (`repro_torch.core.staging.stage_naive`). ``topology`` and ``compression``
    are accepted for engine-protocol uniformity (the naive path never
    touches the interconnect, so neither changes anything); ``faults``
    as on :class:`CollectiveConfig`."""
    topology: Optional[TopologyConfig] = None
    faults: Optional[FaultConfig] = None
    compression: Optional[CompressionConfig] = None


@dataclass(frozen=True)
class ReplicatedConfig(EngineConfig):
    """R-way stripe-replicated staging with chained declustering
    (`repro_torch.core.staging.stage_replicated`): instead of every host
    holding a full replica, stripe ``i`` lands on hosts ``i..i+R-1``
    (mod P), so a host death loses no data while R-1 neighbors survive
    and repair (`repro_torch.core.staging.re_replicate`) moves only the lost
    stripes. ``replication`` is R (1 = no redundancy: a pure striped
    scatter); ``topology``/``faults``/``compression`` as on
    :class:`CollectiveConfig`."""
    replication: int = 2
    topology: Optional[TopologyConfig] = None
    faults: Optional[FaultConfig] = None
    compression: Optional[CompressionConfig] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.replication < 1:
            raise ValueError(
                f"replication must be a replica count >= 1, got "
                f"{self.replication}")


@dataclass(frozen=True)
class StreamConfig(EngineConfig):
    """Detector-push streamed ingestion (`repro_torch.core.streaming`): the
    shared FS is never read back. ``rate_hz`` is the acquisition rate in
    frames per simulated second (``None`` = replay as fast as the fabric
    delivers); ``window_bytes`` bounds the per-node sliding cache
    (``None`` = the whole set stays resident); ``topology`` as on
    :class:`CollectiveConfig` (the per-frame detector ingest hop is
    charged to its ingest tier and each delivery broadcast planned over
    it); ``faults`` overlays a what-if fault schedule on the stream
    (degraded ingest: deliveries skip hosts dead at delivery time);
    ``compression`` as on :class:`CollectiveConfig` (the WAN ingest hop
    is where compress-at-source pays most — see docs/compression.md)."""
    rate_hz: Optional[float] = None
    window_bytes: Optional[int] = None
    # paths pinned AT INGEST (exempt from window eviction) in addition to
    # whatever the broadcast entry's ``pin`` directive pins — the typed
    # home of the legacy ``stage_kw={"pin_paths": [...]}`` escape hatch
    pin_paths: Tuple[str, ...] = ()
    topology: Optional[TopologyConfig] = None
    faults: Optional[FaultConfig] = None
    compression: Optional[CompressionConfig] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        object.__setattr__(self, "pin_paths", tuple(self.pin_paths))
        if self.rate_hz is not None and self.rate_hz <= 0:
            raise ValueError(
                f"rate_hz must be a positive acquisition rate in frames "
                f"per simulated second (or None for replay), got "
                f"{self.rate_hz}")
        if self.window_bytes is not None and self.window_bytes <= 0:
            raise ValueError(
                f"window_bytes must be a positive per-node cache budget in "
                f"bytes (or None to keep the whole set resident), got "
                f"{self.window_bytes}")


@dataclass(frozen=True)
class WanStreamConfig(StreamConfig):
    """Cross-facility WAN ingest (`repro_torch.core.wan.stage_wan`): the
    detector sits across a wide-area ingest tier (pair with
    ``topology="wan_beamline"``), pushes only while it holds a send
    credit, and ONE WAN stream fans out to ``subscribers`` consumer
    campaigns (frames cross the WAN once; retention follows the slowest
    subscriber's watermark).

    On top of :class:`StreamConfig`: ``credit_window`` caps unconsumed
    in-flight frames (``None`` derives the largest window the node cache
    can absorb — it never binds on an unbounded cache); ``buffer_frames``
    bounds the detector's DAQ buffer (``None`` = unbounded, no drops;
    overflow overwrites the OLDEST frame, accounted in
    ``report.wan.frames_dropped``); ``consume_hz`` is the per-subscriber
    processing rate (scalar for all, a tuple per subscriber, ``None`` for
    instant acks); ``loss_rate``/``loss_seed`` drive seeded stop-and-wait
    retransmission on the WAN hop; ``jitter_seed``/``jitter_windows``/
    ``jitter_window_s``/``jitter_factors`` overlay seeded transient
    brownouts on the ingest tier
    (`repro_torch.core.faults.FaultSchedule.wan_jitter`), composed with any
    ``faults`` overlay.  All defaults off: the default WAN stage is
    byte- and time-exact vs :class:`StreamConfig` (the regression
    anchor)."""
    credit_window: Optional[int] = None
    buffer_frames: Optional[int] = None
    subscribers: int = 1
    consume_hz: Union[None, float, Tuple[float, ...]] = None
    loss_rate: float = 0.0
    loss_seed: int = 0
    jitter_seed: Optional[int] = None
    jitter_windows: int = 0
    jitter_window_s: Optional[float] = None
    jitter_factors: Tuple[float, float] = (0.3, 0.9)

    def __post_init__(self) -> None:
        super().__post_init__()
        if isinstance(self.consume_hz, (list, tuple)):
            object.__setattr__(self, "consume_hz",
                               tuple(float(r) for r in self.consume_hz))
        object.__setattr__(self, "jitter_factors",
                           tuple(float(f) for f in self.jitter_factors))
        if self.credit_window is not None and self.credit_window < 1:
            raise ValueError(
                f"credit_window must be >= 1 in-flight frames (or None "
                f"to derive it), got {self.credit_window}")
        if self.buffer_frames is not None and self.buffer_frames < 1:
            raise ValueError(
                f"buffer_frames must be >= 1 (or None for an unbounded "
                f"DAQ buffer), got {self.buffer_frames}")
        if self.subscribers < 1:
            raise ValueError(
                f"subscribers must be >= 1 consumer campaigns, got "
                f"{self.subscribers}")
        if isinstance(self.consume_hz, tuple) \
                and len(self.consume_hz) != self.subscribers:
            raise ValueError(
                f"consume_hz lists {len(self.consume_hz)} rates for "
                f"{self.subscribers} subscribers")
        if not 0.0 <= self.loss_rate < 1.0:
            raise ValueError(
                f"loss_rate must be in [0, 1) — a rate of 1 never "
                f"delivers, got {self.loss_rate}")
        if self.jitter_windows < 0:
            raise ValueError(
                f"jitter_windows must be >= 0, got {self.jitter_windows}")
        jf = self.jitter_factors
        if len(jf) != 2 or not 0.0 < jf[0] <= jf[1] <= 1.0:
            raise ValueError(
                f"jitter_factors must be (lo, hi) with 0 < lo <= hi <= 1 "
                f"(0 is a partition, not jitter), got {jf}")
        if self.jitter_window_s is not None and self.jitter_window_s <= 0:
            raise ValueError(
                f"jitter_window_s must be a positive brownout length in "
                f"simulated seconds (or None to derive it), got "
                f"{self.jitter_window_s}")


@dataclass(frozen=True)
class ServiceConfig:
    """Catalog-backed acquisition through a long-lived
    :class:`~repro_torch.core.datasvc.StagingService`: datasets register in the
    catalog, concurrent requests coalesce, residents evict under
    ``budget_bytes`` (per-node), and leases pin replicas until released.
    ``engine`` is the typed config of the batch engine the service stages
    with."""
    budget_bytes: int
    engine: EngineConfig = field(default_factory=CollectiveConfig)

    def __post_init__(self) -> None:
        if self.budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be a positive per-node memory budget "
                f"in bytes, got {self.budget_bytes}")
        # fail fast on a KNOWN non-batch engine (the service re-stages on
        # demand); configs only a custom registry knows are validated when
        # the service is built against that registry
        entry = ENGINES.lookup(self.engine)
        if entry is not None and not entry.batch:
            raise ValueError(
                f"ServiceConfig.engine must be a batch engine (the "
                f"service re-stages on demand); "
                f"{type(self.engine).__name__} drives the non-batch "
                f"{entry.name!r} engine")


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EngineEntry:
    """One registered staging engine."""
    name: str
    config_type: type
    stage_fn: Callable[..., Tuple[StagingReport, float]]
    batch: bool = True          # False: streamed delivery (no FS read-back)


class EngineRegistry:
    """Name -> (config type, stage fn) — the pluggable engine table.

    Engines register ONCE here; `repro_torch.core.iohook.run_io_hook`,
    :class:`StagingClient`, `repro_torch.core.datasvc.StagingService` and the
    HEDM runners all resolve modes through the same registry, so adding
    an engine is a one-file change (define config + stage fn, register).
    Stage functions follow the engine protocol
    ``fn(fabric, paths, t0, **config_kw) -> (StagingReport, t_done)``.
    """

    def __init__(self) -> None:
        self._by_name: Dict[str, EngineEntry] = {}
        self._by_config: Dict[type, EngineEntry] = {}

    @classmethod
    def default(cls) -> "EngineRegistry":
        """A fresh registry holding the six built-in engines."""
        reg = cls()
        reg.register("collective", CollectiveConfig, stage_collective)
        reg.register("pipelined", PipelinedConfig, stage_pipelined)
        reg.register("naive", NaiveConfig, stage_naive)
        reg.register("replicated", ReplicatedConfig, stage_replicated)
        reg.register("stream", StreamConfig, stage_stream, batch=False)
        reg.register("wan", WanStreamConfig, stage_wan, batch=False)
        return reg

    def register(self, name: str, config_type: type,
                 stage_fn: Callable[..., Tuple[StagingReport, float]],
                 batch: bool = True) -> EngineEntry:
        if name in self._by_name:
            raise ValueError(f"engine {name!r} is already registered")
        if config_type in self._by_config:
            raise ValueError(
                f"config type {config_type.__name__} is already registered "
                f"(to engine {self._by_config[config_type].name!r})")
        entry = EngineEntry(name=name, config_type=config_type,
                            stage_fn=stage_fn, batch=batch)
        self._by_name[name] = entry
        self._by_config[config_type] = entry
        return entry

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def entries(self) -> List[EngineEntry]:
        return list(self._by_name.values())

    def names(self, batch_only: bool = False) -> List[str]:
        return sorted(n for n, e in self._by_name.items()
                      if e.batch or not batch_only)

    def entry(self, name: str, batch_only: bool = False) -> EngineEntry:
        e = self._by_name.get(name)
        if e is None:
            raise ValueError(
                f"unknown staging mode {name!r}; registered engines: "
                f"{', '.join(self.names())}")
        if batch_only and not e.batch:
            raise ValueError(
                f"staging mode {name!r} is registered but not "
                f"batch-capable (this path needs a re-runnable one-shot "
                f"engine); expected one of: "
                f"{', '.join(self.names(batch_only=True))}")
        return e

    def lookup(self, config: EngineConfig) -> Optional[EngineEntry]:
        """The entry for `config`'s type, or None if unregistered here."""
        return self._by_config.get(type(config))

    def entry_for(self, config: EngineConfig) -> EngineEntry:
        e = self._by_config.get(type(config))
        if e is None:
            raise ValueError(
                f"no engine registered for config type "
                f"{type(config).__name__}; registered engines: "
                f"{', '.join(self.names())}")
        return e

    def name_of(self, config: EngineConfig) -> str:
        return self.entry_for(config).name

    def stage_fn(self, name: str) -> Callable[..., Tuple[StagingReport, float]]:
        return self.entry(name).stage_fn

    def config_for(self, name: str, batch_only: bool = False,
                   **params: Any) -> EngineConfig:
        """Build the typed config for engine `name` from loose params —
        the bridge from the legacy ``mode=...,(stage_kw={...})`` surface.
        Unknown engine names and unknown parameters both raise
        ``ValueError`` with the registered alternatives spelled out."""
        entry = self.entry(name, batch_only=batch_only)
        known = {f.name for f in fields(entry.config_type)}
        bogus = sorted(set(params) - known)
        if bogus:
            raise ValueError(
                f"unknown parameter(s) {', '.join(bogus)} for engine "
                f"{name!r}; {entry.config_type.__name__} accepts: "
                f"{', '.join(sorted(known)) or '(no parameters)'}")
        return entry.config_type(**params)


# The process-wide registry. Engines defined elsewhere plug in with
# ``ENGINES.register(name, ConfigType, stage_fn)``.
ENGINES = EngineRegistry.default()


# ---------------------------------------------------------------------------
# declarative staging spec (paper Fig. 6) — moved here from iohook
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BroadcastEntry:
    """One broadcast directive: glob patterns -> node-local destination."""
    files: Tuple[str, ...]
    dest: str = "/tmp"
    pin: bool = True


@dataclass
class StagingSpec:
    """Fig. 6 analogue. JSON-serializable so it can ride an env var.

    ``config`` optionally embeds the typed engine config in the spec
    itself, so a declarative spec fully selects its transport — the
    engine name and parameters round-trip through ``to_json``/
    ``from_json`` via the :data:`ENGINES` registry."""
    broadcasts: List[BroadcastEntry] = field(default_factory=list)
    config: Optional[EngineConfig] = None

    @classmethod
    def from_json(cls, text: str,
                  registry: Optional["EngineRegistry"] = None
                  ) -> "StagingSpec":
        raw = json.loads(text)
        config = None
        if raw.get("engine"):
            reg = registry if registry is not None else ENGINES
            config = reg.config_for(raw["engine"]["name"],
                                    **raw["engine"].get("params", {}))
        return cls(broadcasts=[
            BroadcastEntry(files=tuple(b["files"]), dest=b.get("dest", "/tmp"),
                           pin=b.get("pin", True))
            for b in raw.get("broadcasts", [])], config=config)

    def to_json(self, registry: Optional["EngineRegistry"] = None) -> str:
        out: Dict[str, Any] = {"broadcasts": [
            {"files": list(b.files), "dest": b.dest, "pin": b.pin}
            for b in self.broadcasts]}
        if self.config is not None:
            reg = registry if registry is not None else ENGINES
            # serialize every config field (not to_kw(), which excludes
            # the fabric-scoped `faults` field from engine kwargs)
            params = {f.name: (v.to_dict()
                               if isinstance(v, (TopologyConfig,
                                                 FaultConfig,
                                                 CompressionConfig)) else v)
                      for f in fields(self.config)
                      for v in (getattr(self.config, f.name),)}
            out["engine"] = {"name": reg.name_of(self.config),
                             "params": params}
        return json.dumps(out)

    @classmethod
    def from_env(cls, env: str = "REPRO_IO_HOOK") -> Optional["StagingSpec"]:
        text = os.environ.get(env)
        return cls.from_json(text) if text else None


Stageable = Union[StagingSpec, str, Sequence[str]]


def as_spec(what: Stageable, pin: bool = True) -> StagingSpec:
    """Normalize ``client.stage``'s first argument to a :class:`StagingSpec`:
    a spec passes through, a pattern string or a sequence of patterns
    becomes a single broadcast entry."""
    if isinstance(what, StagingSpec):
        return what
    if isinstance(what, str):
        return StagingSpec([BroadcastEntry(files=(what,), pin=pin)])
    return StagingSpec([BroadcastEntry(files=tuple(what), pin=pin)])


# ---------------------------------------------------------------------------
# unified report
# ---------------------------------------------------------------------------

@dataclass
class Report:
    """One staging operation's unified accounting, whatever the path.

    Reconciles the per-engine :class:`~repro_torch.core.staging.StagingReport`
    rows (streamed delivery folds its ``StreamReport`` into one), the old
    ``HookResult`` fields, and — on the catalog path — the service's
    shared accounting, behind one protocol. All times are simulated
    seconds.

    Documented invariants (asserted by ``tests/test_api.py``):

      * direct engines: ``total_time == metadata_time +
        sum(r.total_time for r in reports)`` — the old ``HookResult``
        identity, per-report ``total_time == stage + comm + write +
        broadcast``;
      * ``delivered_bytes == n_hosts * total_bytes`` (every node receives
        a full replica) — delivered bytes are LOGICAL payload and never
        shrink under compression;
      * ``net_bytes``/``tier_bytes`` are WIRE bytes (compressed where a
        codec elected a tier); per report the tier map sums to the net
        total, and ``payload_net_bytes == net_bytes + comp.saved_bytes``
        recovers the logical traffic;
      * ``fs_bytes`` is 1x the dataset for collective/pipelined, P x for
        naive, and **0** for stream (the FS is never read back).

    On the catalog path (``engine == "service"``) the per-dataset reports
    are SHARED across coalesced acquisitions, so the sum identity does
    not apply; ``total_time`` is the wall span until every lease is ready
    and the service-wide counters live in ``service.stats``.
    """
    engine: str
    n_hosts: int
    resolved_files: List[str]
    reports: List[StagingReport]
    metadata_time: float = 0.0
    total_time: float = 0.0
    leases: List = field(default_factory=list)
    service: Optional[object] = None     # StagingService on the catalog path

    # -- unified byte accounting -------------------------------------------
    @property
    def total_bytes(self) -> int:
        """Dataset bytes (pre-replication), summed over entries."""
        return sum(r.total_bytes for r in self.reports)

    @property
    def staged_bytes(self) -> int:       # HookResult-compatible alias
        return self.total_bytes

    @property
    def delivered_bytes(self) -> int:
        """Bytes landed on node-local stores: every host gets a replica.
        Logical payload — a staging codec compresses the WIRE traffic
        (``net_bytes``), never what lands in node memory."""
        return self.n_hosts * self.total_bytes

    @property
    def fs_bytes(self) -> int:
        return sum(r.fs_bytes for r in self.reports)

    @property
    def fs_write_bytes(self) -> int:
        return sum(r.fs_write_bytes for r in self.reports)

    @property
    def net_bytes(self) -> int:
        """Interconnect WIRE bytes (compressed where a codec elected)."""
        return sum(r.net_bytes for r in self.reports)

    # -- compression reconciliation (wire vs payload) ----------------------
    @property
    def comp(self) -> CompressionStats:
        """Aggregated codec accounting over every entry's report."""
        total = CompressionStats()
        for r in self.reports:
            total.add(r.comp)
        return total

    @property
    def wire_bytes(self) -> int:
        """Alias of :attr:`net_bytes` making the wire semantics explicit."""
        return self.net_bytes

    @property
    def payload_net_bytes(self) -> int:
        """Logical bytes behind the wire traffic: what the interconnect
        would have moved with no codec (``net_bytes + comp.saved_bytes``)."""
        return self.net_bytes + self.comp.saved_bytes

    @property
    def bytes_saved(self) -> int:
        """Wire bytes a staging codec avoided moving (0 without one)."""
        return self.comp.saved_bytes

    # -- unified time accounting -------------------------------------------
    @property
    def broadcast_time(self) -> float:
        return sum(r.broadcast_time for r in self.reports)

    @property
    def stage_time(self) -> float:
        return sum(r.stage_time for r in self.reports)

    @property
    def comm_time(self) -> float:
        return sum(r.comm_time for r in self.reports)

    @property
    def write_time(self) -> float:
        return sum(r.write_time for r in self.reports)

    def accounting_closes(self, tol: float = 1e-9) -> bool:
        """True when the direct-path identities hold: glob metadata plus
        the per-entry report totals equals the end-to-end time, AND the
        byte story reconciles — each report's per-tier wire bytes sum to
        its net wire total, and the codec's compressed traffic is a
        subset of it (savings never negative)."""
        time_ok = abs(self.metadata_time + sum(r.total_time for r in
                                               self.reports)
                      - self.total_time) <= tol
        bytes_ok = all(sum(r.tier_bytes.values()) == r.net_bytes
                       for r in self.reports)
        comp_ok = all(r.comp.saved_bytes >= 0
                      and r.comp.wire_bytes <= r.net_bytes
                      for r in self.reports)
        return time_ok and bytes_ok and comp_ok


# ---------------------------------------------------------------------------
# the client facade
# ---------------------------------------------------------------------------

class StagingClient:
    """One handle over every way data reaches node-local memory.

    ``client.stage(spec_or_patterns, config)`` runs any registered
    one-shot engine (typed config selects it); with a
    :class:`ServiceConfig` — or a client constructed with
    ``service=`` — the same call routes through the long-lived dataset
    catalog (registration, coalescing, leases). ``client.session(name)``
    opens a context-managed analysis session whose leases auto-release
    on exit. ``client.stream_stager(config)`` hands out the incremental
    streamed-delivery driver for consumers that interleave ingest with
    compute (the online HEDM loop).

    `fabric` is the simulated cluster; `service` an optional
    :class:`~repro_torch.core.datasvc.StagingService` or :class:`ServiceConfig`
    (built lazily); `registry` defaults to the process-wide
    :data:`ENGINES`; `trace` turns on timeline-resolved telemetry
    (``True`` builds a fresh `repro_torch.core.telemetry.Tracer`, or pass your
    own) attached fabric-wide — spans/metrics record simulated time but
    NEVER change it (docs/observability.md). Off (the default) the
    fabric keeps the zero-cost :data:`~repro_torch.core.telemetry.NULL_TRACER`.
    """

    def __init__(self, fabric: Fabric,
                 service: Optional[object] = None,
                 registry: EngineRegistry = ENGINES,
                 trace: Union[bool, Tracer] = False):
        self.fabric = fabric
        self.registry = registry
        if trace:
            fabric.attach_tracer(trace if isinstance(trace, Tracer)
                                 else Tracer())
        self._service = None
        self._service_config: Optional[ServiceConfig] = None
        if isinstance(service, ServiceConfig):
            self._service_config = service
        elif service is not None:
            self._service = service

    # -- telemetry ----------------------------------------------------------
    @property
    def tracer(self) -> TracerLike:
        """The fabric-wide tracer (the shared
        :data:`~repro_torch.core.telemetry.NULL_TRACER` when tracing is off)."""
        return self.fabric.tracer

    def write_trace(self, path: str) -> str:
        """Export every recorded span as a Chrome trace-event JSON file
        (load it at https://ui.perfetto.dev); returns `path`.
        Raises when the client was built without ``trace=``."""
        if not self.fabric.tracer.enabled:
            raise ValueError(
                "tracing is off; construct StagingClient(fabric, "
                "trace=True) to record a timeline")
        return write_chrome_trace(self.fabric.tracer, path)

    def flight_report(self) -> str:
        """The plain-text flight-recorder report (critical-path breakdown
        per stage, tier attribution, FS contention, metrics digest)."""
        if not self.fabric.tracer.enabled:
            raise ValueError(
                "tracing is off; construct StagingClient(fabric, "
                "trace=True) to record a timeline")
        return flight_recorder(self.fabric.tracer)

    @property
    def planner(self) -> CollectivePlanner:
        """The `repro_torch.core.collectives.CollectivePlanner` bound to the
        fabric's current topology — pure cost queries (``plan_*`` touches
        no traffic counters). A per-call ``TopologyConfig`` on an engine
        config rebinds it for that stage only."""
        return self.fabric.net.planner

    # -- service plumbing ---------------------------------------------------
    @property
    def service(self):
        """The attached :class:`~repro_torch.core.datasvc.StagingService`
        (built on first use when the client was given a
        :class:`ServiceConfig`); None when the client is engine-only."""
        if self._service is None and self._service_config is not None:
            self._service = self._build_service(self._service_config)
        return self._service

    def _build_service(self, cfg: ServiceConfig):
        from repro_torch.core.datasvc import StagingService
        return StagingService(self.fabric, cfg.budget_bytes,
                              engine=cfg.engine, registry=self.registry)

    def session(self, name: str) -> "ClientSession":
        """A context-managed analysis session on the attached service:
        every lease it still holds is released on ``__exit__`` (at the
        last simulated time the session observed, or pass
        ``close(t=...)`` explicitly), exception or not."""
        svc = self.service
        if svc is None:
            raise ValueError(
                "client has no staging service; construct it with "
                "StagingClient(fabric, service=ServiceConfig(...)) or an "
                "existing StagingService")
        return ClientSession(self, svc.session(name))

    def qos_scheduler(self, policy=None, loop=None):
        """An event-driven `repro_torch.core.qos.QoSScheduler` over the attached
        service: concurrent sessions submit timed requests onto a shared
        `repro_torch.core.events.EventLoop` and contend for the budget under the
        given `repro_torch.core.qos.QoSPolicy` (default: the ``qos`` policy;
        pass ``repro_torch.core.qos.FIFO`` for the arrival-order baseline)."""
        svc = self.service
        if svc is None:
            raise ValueError(
                "client has no staging service; construct it with "
                "StagingClient(fabric, service=ServiceConfig(...)) or an "
                "existing StagingService")
        from repro_torch.core.qos import QoSScheduler
        return QoSScheduler(svc, policy=policy, loop=loop)

    # -- staging ------------------------------------------------------------
    def stage(self, what: Stageable,
              config: Optional[Union[EngineConfig, ServiceConfig]] = None,
              t0: float = 0.0, session: str = "client",
              resolve: bool = True, pin: bool = True) -> Report:
        """Stage `what` (a :class:`StagingSpec`, a glob pattern, or a
        sequence of patterns) starting at simulated time `t0`.

        `config` selects the path: a typed engine config runs that
        one-shot engine; ``None`` on a service-attached client routes
        through the dataset catalog under `session` (the service's own
        engine is used — a spec-embedded engine config is ignored there);
        ``None`` otherwise defaults to the spec's embedded config, then
        :class:`CollectiveConfig`. A :class:`ServiceConfig` belongs in
        the CLIENT constructor, not here — passing one raises. With
        ``resolve=False`` the entry file lists are taken as CONCRETE
        shared-FS paths — no leader glob or manifest broadcast is run or
        charged (the programmatic path the HEDM runners use). `pin`
        applies only to the CONVENIENCE forms (a pattern or a path list,
        which become a single broadcast entry): ``pin=False`` leaves the
        replicas evictable, matching a bare engine call — a full
        :class:`StagingSpec` carries pinning per entry instead.

        Returns a unified :class:`Report`; on the catalog path its
        ``leases`` belong to the caller (use :meth:`session` to scope
        them so they can never leak).
        """
        spec = as_spec(what, pin=pin)
        if isinstance(config, ServiceConfig):
            # a per-call ServiceConfig would silently reroute LATER
            # config-less calls through the catalog (and leak leases with
            # no scope to release them) — the service is a property of
            # the CLIENT, so demand it at construction
            raise ValueError(
                "ServiceConfig configures the client, not a single call: "
                "construct StagingClient(fabric, service=ServiceConfig("
                "...)), then stage(..., config=None) routes through the "
                "catalog — ideally inside a `with client.session(name)` "
                "scope so the leases auto-release")
        has_service = (self._service is not None
                       or self._service_config is not None)
        if config is None and has_service:
            # the attached service wins over any spec-embedded engine
            # config: the service stages with ITS engine, and a session
            # scope must never silently fall back to an unleased direct
            # stage
            if not resolve:
                raise ValueError(
                    "resolve=False is not supported on the catalog path: "
                    "the service registers datasets by PATTERN (resolved "
                    "once by the leader root); pass concrete paths via "
                    "service.register(name, paths=...) instead")
            return self._stage_catalog(spec, self.service, session, t0)
        if config is None:
            config = spec.config or CollectiveConfig()
        return self._stage_direct(spec, config, t0, resolve)

    def _stage_direct(self, spec: StagingSpec, config: EngineConfig,
                      t0: float, resolve: bool) -> Report:
        entry_ = self.registry.entry_for(config)
        reports: List[StagingReport] = []
        all_files: List[str] = []
        t_meta = 0.0
        t = t0
        # a config-level FaultConfig scopes a what-if fault timeline to
        # THIS stage op (None -> the fabric's live schedule, trivially
        # empty on a healthy fabric — the exact pre-fault path)
        fault_cfg = getattr(config, "faults", None)
        sched = (fault_cfg.build(self.fabric.n_hosts)
                 if fault_cfg is not None else None)
        with self.fabric.net.scoped_faults(sched):
            for entry in spec.broadcasts:
                if resolve:
                    from repro_torch.core.iohook import resolve_manifest_timed
                    # the manifest broadcast is part of the stage op: plan
                    # it under the config's topology too (None -> fabric
                    # binding)
                    with self.fabric.net.scoped_topology(
                            getattr(config, "topology", None)):
                        files, t_resolved, bcast = resolve_manifest_timed(
                            self.fabric, entry.files, t)
                    t_meta += t_resolved - t - bcast     # glob phase only
                    t = t_resolved
                else:
                    files, bcast = list(entry.files), 0.0
                kw = config.to_kw()
                if isinstance(config, StreamConfig):
                    self._check_window(config, files)
                    if entry.pin:
                        # the streaming engine must pin AT INGEST: with a
                        # bounded window, post-hoc pinning would mark
                        # already-evicted files
                        kw["pin_paths"] = list(files) + [
                            p for p in config.pin_paths if p not in files]
                rep, t = entry_.stage_fn(self.fabric, files, t, **kw)
                rep.broadcast_time = bcast           # on_root manifest push
                reports.append(rep)
                all_files.extend(files)
                if entry.pin:
                    # only hosts that received replicas hold pins (a dead
                    # host's store was never written; pinning it would
                    # strand a stale refcount past its recovery)
                    hosts = (self.fabric.hosts if self.fabric.faults.trivial
                             else self.fabric.live_hosts(t))
                    for host in hosts:
                        for f in files:
                            host.store.pin(f)
        return Report(engine=entry_.name, n_hosts=self.fabric.n_hosts,
                      resolved_files=all_files, reports=reports,
                      metadata_time=t_meta, total_time=t - t0)

    def _check_window(self, config: StreamConfig,
                      files: Sequence[str]) -> None:
        if config.window_bytes is None or not files:
            return
        biggest = max(self.fabric.fs.size(f) for f in files)
        if config.window_bytes < biggest:
            raise ValueError(
                f"window_bytes ({config.window_bytes}) is smaller than the "
                f"largest frame to be staged ({biggest} B): not even one "
                f"frame fits the node cache")

    def _stage_catalog(self, spec: StagingSpec, service, session,
                       t0: float) -> Report:
        """Catalog-backed staging: register + acquire through the service.
        Per-dataset reports are SHARED across coalesced acquisitions, so
        the direct-path accounting identity does not apply here;
        ``metadata_time`` still covers the registration glob phase only
        (the manifest broadcast lands in ``service.stats.broadcast_time``).
        """
        session_id = getattr(session, "session_id", session)
        reports: List[StagingReport] = []
        leases: List = []
        all_files: List[str] = []
        t_meta = 0.0
        t = t0
        t_end = t0
        for entry in spec.broadcasts:
            name = "|".join(entry.files)
            bcast0 = service.stats.broadcast_time
            ds, t_reg = service.register(name, patterns=entry.files, t=t)
            t_meta += (t_reg - t) - (service.stats.broadcast_time - bcast0)
            lease = service.acquire(session_id, name, t_reg)
            leases.append(lease)
            t = t_reg
            t_end = max(t_end, lease.t_ready)
            if ds.last_report is not None:
                reports.append(ds.last_report)
            all_files.extend(ds.paths)
        return Report(engine="service", n_hosts=self.fabric.n_hosts,
                      resolved_files=all_files, reports=reports,
                      metadata_time=t_meta, total_time=t_end - t0,
                      leases=leases, service=service)

    # -- live fault injection -----------------------------------------------
    def inject(self, kind: Union[FaultEvent, FaultKind, str],
               t: float = 0.0, *, host: Optional[int] = None,
               tier: Optional[str] = None, t_end: float = math.inf,
               factor: float = 1.0, apply: bool = True) -> FaultEvent:
        """Inject a LIVE fault into the fabric's timeline (unlike a
        config-level :class:`FaultConfig`, this mutates state: a host
        death wipes its node-local store when applied).

        `kind` is a :class:`~repro_torch.core.faults.FaultKind` (or its string
        value, or a prebuilt :class:`~repro_torch.core.faults.FaultEvent`);
        ``host`` names the victim for death/recovery, ``tier``/``t_end``/
        ``factor`` describe a degradation window. With ``apply=True``
        (default) the fault clock advances to the event time — through
        the attached service's ``sync_faults`` when there is one, so
        catalog entries transition to DEGRADED in the same call; pass
        ``apply=False`` to schedule a future event and let the next
        ``sync_faults``/``advance_faults`` pick it up."""
        if isinstance(kind, FaultEvent):
            ev = kind
        else:
            ev = FaultEvent(t, FaultKind(kind), host=host, tier=tier,
                            t_end=t_end, factor=factor)
        self.fabric.faults.inject(ev)
        if apply:
            # sync the catalog when a service is ATTACHED (never build one
            # just to sync — an unbuilt service has no entries to degrade)
            if self._service is not None:
                self._service.sync_faults(ev.t)
            else:
                self.fabric.advance_faults(ev.t)
        return ev

    # -- streamed delivery (incremental driver) -----------------------------
    def stream_stager(self, config: StreamConfig,
                      t0: float = 0.0) -> StreamStager:
        """The incremental streamed-delivery driver configured by
        `config` (``window_bytes`` is required here — an open-ended
        stream has no "whole set" to default to). ``pin_paths`` are
        pre-pinned on the stager (exempt from window eviction the moment
        they land). ``rate_hz`` belongs to the DETECTOR, not the
        delivery window: feed it to the
        :class:`~repro_torch.core.streaming.DetectorSource` the caller attaches
        (as the online HEDM runner does). Use this when compute
        interleaves with ingest; for whole-set delivery just call
        :meth:`stage` with the same config."""
        if not isinstance(config, StreamConfig):
            raise ValueError(
                f"stream_stager needs a StreamConfig, got "
                f"{type(config).__name__}")
        if config.window_bytes is None:
            raise ValueError(
                "StreamConfig.window_bytes is required for an incremental "
                "stream stager (there is no dataset to default it to)")
        stager = StreamStager(self.fabric, window_bytes=config.window_bytes,
                              t0=t0, topology=config.topology,
                              compression=config.compression)
        for p in config.pin_paths:
            stager.pin(p)
        return stager


class ClientSession:
    """A session-scoped campaign: an
    :class:`~repro_torch.core.datasvc.AnalysisSession` bound to its client.

    Context manager — ``__exit__`` releases every lease the session still
    holds (exception or not) at the last simulated time it observed, so a
    forgotten ``release`` can no longer wedge later admissions.
    ``stage(...)`` routes a spec through the catalog under this session,
    with the resulting leases owned (and therefore auto-released) here.
    Everything else (``acquire``/``release``/``put_result``/``flush``/
    ``tag``/``close``) delegates to the underlying session.
    """

    def __init__(self, client: StagingClient, session) -> None:
        self._client = client
        self._session = session

    def __getattr__(self, name: str):
        return getattr(self._session, name)

    def stage(self, what: Stageable, t0: Optional[float] = None) -> Report:
        """Catalog-backed stage under this session at `t0` (default: the
        last simulated time this session observed). ALWAYS routes through
        the service — a spec-embedded engine config is ignored here (the
        service stages with its own engine), so the session's lease
        guarantees can never be silently bypassed."""
        t = self._session._t_last if t0 is None else t0
        rep = self._client._stage_catalog(as_spec(what),
                                          self._session.service,
                                          self._session, t)
        self._session.note(t + rep.total_time)
        return rep

    def __enter__(self) -> "ClientSession":
        self._session.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        return self._session.__exit__(exc_type, exc, tb)


def deprecated_call(old: str, new: str) -> None:
    """Emit the one shared deprecation message for a legacy surface."""
    warnings.warn(
        f"{old} is a compatibility shim over the unified staging client "
        f"API; migrate to {new} (see docs/api.md)",
        DeprecationWarning, stacklevel=3)
