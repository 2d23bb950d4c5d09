"""The Swift I/O hook, reimplemented (paper §IV, Fig. 6).

A declarative staging spec — "broadcast these files to this node-local
destination" — executed by the runtime before tasks run. Mirrors the paper:

  * the spec can come from an environment variable (``REPRO_IO_HOOK``), as
    ``SWIFT_IO_HOOK`` did;
  * glob resolution happens ONCE (leader rank 0) and the resolved list is
    broadcast — metadata contention avoidance (§IV: "only one process
    performs any globs");
  * transfers default to collective staging; every engine registered in
    `repro_torch.core.api.ENGINES` is selectable;
  * files are pinned in the node-local store for reuse across task waves.

Since the unified client API landed, this module is the COMPATIBILITY
layer: :func:`run_io_hook` is a thin shim over
`repro_torch.core.api.StagingClient` (its ``mode``/``collective``/``stage_kw``
arguments are deprecated but honored), and
:class:`~repro_torch.core.api.StagingSpec` / :class:`~repro_torch.core.api.BroadcastEntry`
live in ``repro_torch.core.api`` (re-exported here). New code should call
``StagingClient.stage(spec, config)`` with a typed engine config directly
— see ``docs/api.md`` for the migration table. The leader-side metadata
resolution (:func:`resolve_manifest_timed`) still lives here and is what
the client charges for glob + manifest broadcast.

All times returned are SIMULATED seconds (see `repro_torch.core.fabric`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# Compatibility re-exports: the spec types moved to the unified API.
from repro_torch.core.api import (ENGINES, BroadcastEntry, StagingClient,  # noqa: F401
                            StagingSpec, deprecated_call)
from repro_torch.core.fabric import Fabric
from repro_torch.core.leader import LeaderGroup
from repro_torch.core.staging import StagingReport


@dataclass
class HookResult:
    """Legacy hook accounting — the pre-client shape of
    `repro_torch.core.api.Report`, kept for the shim's callers."""
    resolved_files: List[str]
    reports: List[StagingReport]
    metadata_time: float
    total_time: float
    # catalog-backed mode only: the leases this hook acquired, one per
    # broadcast entry. The CALLER owns them — release each via
    # ``service.release(lease.session_id, lease.dataset, t)`` when done,
    # or the datasets stay pinned/unevictable forever. (The client API's
    # ``client.session(...)`` context manager does this automatically.)
    leases: List = field(default_factory=list)

    @property
    def staged_bytes(self) -> int:
        return sum(r.total_bytes for r in self.reports)


def resolve_manifest_timed(fabric: Fabric, patterns: Sequence[str], t0: float
                           ) -> Tuple[List[str], float, float]:
    """Leader-rank metadata resolution with a phase breakdown.

    ONE process (the leader-group root) runs the globs, then the resolved
    list is broadcast to the other leaders via
    :meth:`repro_torch.core.leader.LeaderGroup.on_root` (a naive implementation
    runs the glob on every rank, congesting the FS — paper §IV).

    `patterns` are fnmatch globs against the shared FS; `t0` the simulated
    start time (s). Returns ``(resolved paths, completion time,
    broadcast seconds)`` — the broadcast is included in the completion
    time AND reported separately so callers can charge it into
    ``StagingReport.broadcast_time``."""
    leaders = LeaderGroup(fabric)
    glob_done = [t0]

    def root_globs() -> List[str]:
        files: List[str] = []
        t = t0
        for pattern in patterns:
            names, t = fabric.fs.glob(pattern, t)
            files.extend(names)
        glob_done[0] = t
        return files

    files, bcast = leaders.on_root(root_globs)
    return files, glob_done[0] + bcast, bcast


def resolve_manifest(fabric: Fabric, patterns: Sequence[str], t0: float
                     ) -> Tuple[List[str], float]:
    """:func:`resolve_manifest_timed` without the breakdown — returns
    ``(resolved paths, completion time)``, broadcast included."""
    files, t, _ = resolve_manifest_timed(fabric, patterns, t0)
    return files, t


def run_io_hook(fabric: Fabric, spec: StagingSpec, t0: float = 0.0,
                collective: Optional[bool] = None, mode: Optional[str] = None,
                stage_kw: Optional[Dict] = None,
                service=None, session: str = "iohook") -> HookResult:
    """Execute the hook: resolve globs once, broadcast the manifest, stage.

    .. deprecated:: compatibility shim over
       `repro_torch.core.api.StagingClient` — prefer ``StagingClient(fabric)
       .stage(spec, config)`` with a typed engine config
       (``CollectiveConfig``/``PipelinedConfig``/``NaiveConfig``/
       ``StreamConfig``), or ``StagingClient(fabric, service=...)`` with a
       ``client.session(...)`` scope for the catalog path. The legacy
       arguments keep working: ``mode`` (an engine name from the
       `repro_torch.core.api.ENGINES` registry) overrides the ``collective``
       boolean, and ``stage_kw`` loose keywords are validated into the
       engine's typed config (unknown modes and unknown parameters raise
       ``ValueError`` listing the registered alternatives). A spec that
       embeds its own engine config is honored — exactly as the client
       honors it — when none of ``mode``/``collective``/``stage_kw`` are
       given.

    `spec` is the declarative staging spec (Fig. 6); `t0` the simulated
    start time (s). Returns a :class:`HookResult` whose times are
    simulated seconds. The leader metadata broadcast is charged into each
    report's ``broadcast_time``; ``metadata_time`` covers the glob phase
    only, so ``metadata_time + sum(report total_times) == total_time``.

    **Catalog-backed mode**: pass ``service`` (a
    :class:`repro_torch.core.datasvc.StagingService`) to route each broadcast
    entry through the long-lived dataset catalog under ``session`` —
    concurrent hook runs coalesce, the service's engine is used
    (``mode``/``stage_kw`` are ignored), and the acquired leases come
    back in ``HookResult.leases``, owned by the caller.
    """
    deprecated_call("run_io_hook", "repro_torch.core.api.StagingClient.stage")
    client = StagingClient(fabric, service=service)
    if service is not None:
        rep = client.stage(spec, t0=t0, session=session)
    elif (mode is None and stage_kw is None and collective is None
          and spec.config is not None):
        # the spec fully selects its transport (engine block in the
        # JSON): honor it, exactly as the client does
        rep = client.stage(spec, t0=t0)
    else:
        if mode is None:
            mode = "naive" if collective is False else "collective"
        config = ENGINES.config_for(mode, **(stage_kw or {}))
        rep = client.stage(spec, config, t0=t0)
    return HookResult(resolved_files=rep.resolved_files, reports=rep.reports,
                      metadata_time=rep.metadata_time,
                      total_time=rep.total_time, leases=rep.leases)


def naive_per_rank_globs(fabric: Fabric, patterns: Sequence[str],
                         t0: float = 0.0) -> float:
    """The anti-pattern (every rank globs): returns completion time, for the
    metadata-contention comparison benchmark."""
    t_end = t0
    for _ in range(fabric.n_ranks):
        t = t0
        for pattern in patterns:
            _, t = fabric.fs.glob(pattern, t)
        t_end = max(t_end, t)
    return t_end - t0
