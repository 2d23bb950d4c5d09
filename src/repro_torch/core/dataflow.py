"""Swift-style implicitly-parallel dataflow (paper §III, Figs. 4/5).

Futures + deferred task graph. Building blocks:
  * ``Dataflow.task(fn, *deps)``  -> Future (a node in the DAG)
  * ``Dataflow.foreach(fn, xs)``  -> list of Futures (the map phase)
  * ``Dataflow.merge_pairwise``   -> recursive pairwise reduction (Fig. 4's
    merge(), including the no-barrier property: merges become eligible as
    soon as their two inputs are ready, while other maps still run)
  * ``Dataflow.frame_task(fn, record)`` -> a node keyed to a streamed
    detector frame (`repro_torch.core.streaming.FrameRecord`): it becomes
    eligible the moment the frame lands on the node-local stores
    (``record.t_avail``), while acquisition is still in flight.
  * ``Dataflow(fabric, stage=...)`` -> the graph declares its input
    dataset ONCE (a `repro_torch.core.api.StagingSpec`, a glob pattern, or a
    pattern list, with an optional typed engine config via
    ``stage_config``); :meth:`Dataflow.run` has the unified
    `repro_torch.core.api.StagingClient` stage it before execution, and no
    task starts before the staged replicas are resident (the I/O-hook
    discipline, expressed at graph level).

Execution is delegated to the ManyTaskEngine (simulated time + optional real
payloads), preserving dataflow ordering.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.fabric import Fabric
from repro_torch.core.manytask import EngineStats, ManyTaskEngine, Task


@dataclass
class Future:
    """A dataflow value: closed over by downstream tasks."""
    task_id: int
    graph: "Dataflow"

    def result(self) -> Any:
        if not self.graph.executed:
            raise RuntimeError("graph not executed yet")
        return self.graph._results[self.task_id]


class Dataflow:
    def __init__(self, fabric: Fabric, stage: Any = None,
                 stage_config: Any = None, **engine_kw):
        self.fabric = fabric
        self.engine_kw = engine_kw
        self._tasks: List[Task] = []
        self._fns: Dict[int, Callable] = {}
        self._results: Dict[int, Any] = {}
        self.executed = False
        # declared-once staged inputs: spec/pattern(s) + typed engine config
        self._stage = stage
        self._stage_config = stage_config
        self.stage_report = None     # repro_torch.core.api.Report after run()

    # -- graph construction -------------------------------------------------
    def task(self, fn: Callable[..., Any], *args: Any,
             duration: Optional[float] = None,
             inputs: Sequence[str] = (),
             not_before: float = 0.0) -> Future:
        """Add a node. `args` may contain Futures (become dependencies).
        `not_before` (simulated s) delays eligibility — the frame-future
        hook: a task keyed to a streamed frame passes its ``t_avail``."""
        tid = len(self._tasks)
        deps = tuple(a.task_id for a in args if isinstance(a, Future))

        def thunk(tid=tid, fn=fn, args=args):
            concrete = [self._results[a.task_id] if isinstance(a, Future)
                        else a for a in args]
            out = fn(*concrete)
            self._results[tid] = out
            return out

        self._tasks.append(Task(task_id=tid, fn=thunk, duration=duration,
                                deps=deps, inputs=tuple(inputs),
                                not_before=not_before))
        return Future(tid, self)

    def frame_task(self, fn: Callable[..., Any], frame: Any, *args: Any,
                   duration: Optional[float] = None) -> Future:
        """Node keyed to a streamed frame future (`FrameRecord`-shaped:
        needs ``.path`` and ``.t_avail``): eligible the moment the frame is
        resident on the node-local stores, with the frame file as its
        locality input. ``fn`` receives the record as its first argument."""
        return self.task(fn, frame, *args, duration=duration,
                         inputs=(frame.path,), not_before=frame.t_avail)

    def foreach(self, fn: Callable[[Any], Any], xs: Sequence[Any],
                durations: Optional[Sequence[float]] = None,
                inputs_of: Optional[Callable[[Any], Sequence[str]]] = None,
                not_befores: Optional[Sequence[float]] = None
                ) -> List[Future]:
        """Swift `foreach`: independent, concurrent, load-balanced.
        `not_befores` optionally staggers eligibility per element
        (frame-future streaming of the map phase)."""
        futs = []
        for i, x in enumerate(xs):
            d = durations[i] if durations is not None else None
            ins = tuple(inputs_of(x)) if inputs_of else ()
            nb = not_befores[i] if not_befores is not None else 0.0
            futs.append(self.task(fn, x, duration=d, inputs=ins,
                                  not_before=nb))
        return futs

    def merge_pairwise(self, merge_fn: Callable[[Any, Any], Any],
                       futures: Sequence[Future],
                       duration: Optional[float] = None) -> Future:
        """Fig. 4's recursive pairwise merge — no barrier with the map phase:
        each merge depends only on its two inputs."""
        level = list(futures)
        if not level:
            raise ValueError("nothing to merge")
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level) - 1, 2):
                nxt.append(self.task(merge_fn, level[i], level[i + 1],
                                     duration=duration))
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        return level[0]

    # -- execution -----------------------------------------------------------
    def run(self, n_workers: Optional[int] = None) -> EngineStats:
        if self._stage is not None and self.stage_report is None:
            from repro_torch.core.api import StagingClient
            self.stage_report = StagingClient(self.fabric).stage(
                self._stage, self._stage_config)
            # staged inputs gate the whole graph: nothing starts before
            # the replicas are resident on the node-local stores
            t_staged = self.stage_report.total_time
            for task in self._tasks:
                task.not_before = max(task.not_before, t_staged)
        engine = ManyTaskEngine(self.fabric, n_workers=n_workers,
                                **self.engine_kw)
        stats = engine.run(self._tasks)
        self.executed = True
        return stats
