"""Fault-tolerant training driver: checkpoint/restart, failure detection,
elastic rescale, straggler accounting.

The driver owns the outer loop. Failures are injected (or detected via the
heartbeat monitor) between steps; recovery = restore from the last complete
checkpoint, optionally onto a smaller mesh (elastic). On real clusters the
same hooks attach to the control plane; here they are exercised by tests
with simulated failures.

Counterpart of ``repro.runtime.driver``; the elastic path counts the CUDA
devices (1 on a machine without one) where the reference counts JAX's, and
a restart waits for the last checkpoint's writer before it reads which
step is the latest, as the reference's rescale does and its restart does
not.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.store import CheckpointStore


def _device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


@dataclass
class HeartbeatMonitor:
    """Tracks worker liveness; a worker missing `timeout` seconds is dead."""
    n_workers: int
    timeout: float = 10.0
    last_seen: Dict[int, float] = field(default_factory=dict)

    def beat(self, worker: int, now: float) -> None:
        self.last_seen[worker] = now

    def dead_workers(self, now: float) -> List[int]:
        return [w for w in range(self.n_workers)
                if now - self.last_seen.get(w, now) > self.timeout]


@dataclass
class DriverReport:
    steps_completed: int = 0
    restarts: int = 0
    rescales: int = 0
    losses: List[float] = field(default_factory=list)
    checkpoints: List[int] = field(default_factory=list)


class TrainDriver:
    """Outer training loop with checkpoint/restart + elastic rescale.

    `build_step(mesh_spec) -> (step_fn, state)` lets the driver rebuild the
    computation after a rescale. `failure_schedule` maps step -> event
    ("fail" = lose a node and restart from checkpoint; "rescale" = shrink).
    """

    def __init__(self, store: CheckpointStore,
                 build_step: Callable[[Dict], Any],
                 checkpoint_every: int = 10,
                 failure_schedule: Optional[Dict[int, str]] = None):
        self.store = store
        self.build_step = build_step
        self.checkpoint_every = checkpoint_every
        self.failure_schedule = failure_schedule or {}
        self.report = DriverReport()

    def run(self, total_steps: int, mesh_spec: Dict) -> DriverReport:
        step_fn, state = self.build_step(mesh_spec)
        start = 0
        # resume if a checkpoint exists
        latest = self.store.latest_step()
        if latest is not None:
            state = self._restore(state, latest)
            start = latest
        step = start
        while step < total_steps:
            event = self.failure_schedule.get(step)
            if event == "fail":
                # node loss mid-step: restart from last complete checkpoint
                self.report.restarts += 1
                del self.failure_schedule[step]
                # the last save may still be writing: the reference reads
                # LATEST without waiting, so it can restart from step 0 and
                # then restore a checkpoint that the writer finished since
                self.store.wait()
                latest = self.store.latest_step() or 0
                step_fn, state = self.build_step(mesh_spec)
                if self.store.latest_step() is not None:
                    state = self._restore(state, latest)
                step = latest
                continue
            if event == "rescale":
                # elastic: shrink the mesh, reshard from checkpoint
                self.report.rescales += 1
                del self.failure_schedule[step]
                mesh_spec = dict(mesh_spec)
                mesh_spec["n_devices"] = max(1, mesh_spec.get(
                    "n_devices", _device_count()) // 2)
                self.store.wait()
                latest = self.store.latest_step() or 0
                step_fn, state = self.build_step(mesh_spec)
                if self.store.latest_step() is not None:
                    state = self._restore(state, latest)
                step = latest
                continue
            state, metrics = step_fn(state)
            self.report.losses.append(float(metrics["loss"]))
            step += 1
            self.report.steps_completed += 1
            if step % self.checkpoint_every == 0:
                self.store.wait()
                self.store.save_async(step, self._snapshot(state))
                self.report.checkpoints.append(step)
        self.store.wait()
        return self.report

    @staticmethod
    def _snapshot(state: Any) -> Any:
        return state

    def _restore(self, template: Any, step: int) -> Any:
        return self.store.restore(template, step)
