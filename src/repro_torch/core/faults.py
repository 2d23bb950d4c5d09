"""Deterministic fault injection for the simulated fabric.

The paper's residency claim — datasets live in compute-node memory "for
extended periods" — only matters if residency survives the failures a real
machine throws at it over those periods.  This module is the single source
of truth for *what goes wrong and when*: a seeded, deterministic
:class:`FaultSchedule` of host deaths, host recoveries, and link-tier
degradation windows.  Nothing in here moves bytes or advances time; the
schedule is a pure queryable timeline that the rest of the stack consults:

- `repro_torch.core.fabric.Fabric.advance_faults` applies state-changing events
  (a host death wipes that host's node-local store, pins included);
- `repro_torch.core.fabric.Interconnect` plans collectives at time ``t`` over the
  *live* host set and under per-tier degraded bandwidth
  (`repro_torch.core.topology.Topology.degraded`);
- `repro_torch.core.datasvc.StagingService.sync_faults` turns host deaths into
  catalog DEGRADED transitions and drives repair.

Everything is reproducible: the same seed and parameters always produce the
same schedule, and an empty schedule (``FaultSchedule()``) is *trivial* —
every consumer short-circuits to the exact PR 5 code path, keeping the
zero-fault byte and time accounting bit-exact.
"""
from __future__ import annotations

import bisect
import enum
import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class FaultKind(str, enum.Enum):
    """What kind of fault an event injects."""
    HOST_DEATH = "host_death"        # node-local memory wiped at t
    HOST_RECOVERY = "host_recovery"  # host rejoins (blank store) at t
    LINK_DEGRADE = "link_degrade"    # tier bandwidth scaled on [t, t_end)


@dataclass(frozen=True, order=True)
class FaultEvent:
    """One point (or window) on the fault timeline.

    ``host`` is required for death/recovery; ``tier``/``t_end``/``factor``
    describe a degradation window: the named link tier runs at
    ``factor * bandwidth`` for ``t <= now < t_end``.  ``factor == 0`` is a
    partition (the tier carries no traffic; plans over it diverge)."""
    t: float
    kind: FaultKind = field(compare=False)
    host: Optional[int] = field(default=None, compare=False)
    tier: Optional[str] = field(default=None, compare=False)
    t_end: float = field(default=math.inf, compare=False)
    factor: float = field(default=1.0, compare=False)

    def __post_init__(self) -> None:
        if self.t < 0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.kind in (FaultKind.HOST_DEATH, FaultKind.HOST_RECOVERY):
            if self.host is None or self.host < 0:
                raise ValueError(f"{self.kind.value} needs a host id >= 0")
        elif self.kind is FaultKind.LINK_DEGRADE:
            if not self.tier:
                raise ValueError("link_degrade needs a tier name")
            if not 0.0 <= self.factor <= 1.0:
                raise ValueError(
                    f"degradation factor must be in [0, 1], got {self.factor}")
            if self.t_end <= self.t:
                raise ValueError("degradation window must have t_end > t")


@dataclass
class FaultSchedule:
    """A sorted, queryable timeline of :class:`FaultEvent`.

    Queries are pure functions of (events, t): :meth:`dead_hosts` is the set
    of hosts dead *at* ``t`` (death at or before ``t`` with no later
    recovery at or before ``t``); :meth:`tier_factor` is the product of all
    degradation windows covering ``t`` for a tier.  :meth:`inject` keeps the
    timeline sorted so mid-run injection (``client.inject``) composes with a
    pre-built schedule."""
    events: List[FaultEvent] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.events = sorted(self.events)

    @property
    def trivial(self) -> bool:
        """True when the schedule can never perturb anything — consumers
        use this to take the exact pre-fault (PR 5) code path."""
        return not self.events

    def inject(self, event: FaultEvent) -> FaultEvent:
        """Insert `event` keeping the timeline sorted; returns it."""
        bisect.insort(self.events, event)
        return event

    # -- queries ---------------------------------------------------------
    def dead_hosts(self, t: float) -> FrozenSet[int]:
        """Hosts dead at simulated time `t`."""
        dead: set = set()
        for ev in self.events:
            if ev.t > t:
                break
            if ev.kind is FaultKind.HOST_DEATH:
                dead.add(ev.host)
            elif ev.kind is FaultKind.HOST_RECOVERY:
                dead.discard(ev.host)
        return frozenset(dead)

    def n_dead(self, t: float, n_hosts: Optional[int] = None) -> int:
        """Count of dead hosts at `t`, optionally only those < n_hosts."""
        dead = self.dead_hosts(t)
        if n_hosts is not None:
            return sum(1 for h in dead if h < n_hosts)
        return len(dead)

    def is_dead(self, host: int, t: float) -> bool:
        return host in self.dead_hosts(t)

    def tier_factor(self, tier: str, t: float) -> float:
        """Bandwidth multiplier for `tier` at `t` (1.0 = healthy).

        Overlapping windows compound multiplicatively — two independent
        half-rate brownouts leave a quarter of the bandwidth."""
        f = 1.0
        for ev in self.events:
            if ev.t > t:
                break
            if (ev.kind is FaultKind.LINK_DEGRADE and ev.tier == tier
                    and t < ev.t_end):
                f *= ev.factor
        return f

    def tier_factors(self, tiers: Iterable[str], t: float
                     ) -> Dict[str, float]:
        """Non-trivial (!= 1.0) multipliers at `t`, keyed by tier name."""
        out: Dict[str, float] = {}
        for name in tiers:
            f = self.tier_factor(name, t)
            if f != 1.0:
                out[name] = f
        return out

    # -- constructors ----------------------------------------------------
    @classmethod
    def random(cls, seed: int, n_hosts: int, horizon: float, *,
               n_deaths: int = 1, recover_after: Optional[float] = None,
               n_degradations: int = 0,
               tiers: Sequence[str] = ("intra",),
               factor_range: Tuple[float, float] = (0.25, 0.75),
               window: Optional[float] = None) -> "FaultSchedule":
        """Seeded random schedule — same arguments, same timeline, always.

        Draws `n_deaths` distinct victims with death times uniform on
        (0, horizon); each recovers ``recover_after`` later when set.
        Draws `n_degradations` windows of length ``window`` (default
        horizon/4) on round-robin tiers with factors uniform in
        `factor_range`."""
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        victims = rng.choice(n_hosts, size=min(n_deaths, n_hosts),
                             replace=False)
        for h in victims:
            t = float(rng.uniform(0.0, horizon))
            events.append(FaultEvent(t, FaultKind.HOST_DEATH, host=int(h)))
            if recover_after is not None:
                events.append(FaultEvent(t + recover_after,
                                         FaultKind.HOST_RECOVERY,
                                         host=int(h)))
        win = horizon / 4.0 if window is None else window
        for i in range(n_degradations):
            t0 = float(rng.uniform(0.0, max(horizon - win, 0.0) or horizon))
            f = float(rng.uniform(*factor_range))
            events.append(FaultEvent(t0, FaultKind.LINK_DEGRADE,
                                     tier=tiers[i % len(tiers)],
                                     t_end=t0 + win, factor=f))
        return cls(events)

    @classmethod
    def wan_jitter(cls, seed: int, horizon: float, *, tier: str = "wan",
                   n_windows: int = 8,
                   factor_range: Tuple[float, float] = (0.3, 0.9),
                   window: Optional[float] = None) -> "FaultSchedule":
        """Seeded WAN weather: transient degradation windows on one tier.

        Models the bandwidth jitter a cross-facility ingest link sees —
        `n_windows` short brownouts with start times uniform on
        ``(0, horizon - window)`` and factors uniform in `factor_range`,
        all on the named `tier` (default ``"wan"``, the
        ``wan_beamline`` ingest tier).  Window length defaults to
        ``horizon / (2 * n_windows)`` so roughly half the horizon is
        degraded; overlapping windows compound multiplicatively like any
        other degradation (:meth:`tier_factor`).

        Jitter is *weather*, not an outage: `factor_range` must stay
        strictly above 0 — a zero factor is a partition
        (`repro_torch.core.collectives.LinkPartitionedError`) and must be
        injected explicitly, never drawn by accident from a seed.
        Same arguments, same timeline, always."""
        if horizon <= 0:
            raise ValueError(f"horizon must be > 0, got {horizon}")
        if n_windows < 1:
            raise ValueError(f"n_windows must be >= 1, got {n_windows}")
        lo, hi = factor_range
        if not 0.0 < lo <= hi <= 1.0:
            raise ValueError(
                "jitter factor_range must satisfy 0 < lo <= hi <= 1 "
                f"(0 is a partition, not jitter), got {factor_range}")
        win = horizon / (2.0 * n_windows) if window is None else window
        if win <= 0:
            raise ValueError(f"window must be > 0, got {win}")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(n_windows):
            t0 = float(rng.uniform(0.0, max(horizon - win, 0.0) or horizon))
            f = float(rng.uniform(lo, hi))
            events.append(FaultEvent(t0, FaultKind.LINK_DEGRADE, tier=tier,
                                     t_end=t0 + win, factor=f))
        return cls(events)
