"""Many-task execution engine — the Swift/T + ADLB analogue (paper §III).

Event-driven simulator with real payload execution (optional): tasks carry
either a declared duration (for makespan studies matching Figs. 12/13) or a
Python callable (for real JAX work; wall time is measured and used as the
duration). Features mirroring the production requirements:

  * dynamic load balancing via work stealing (ADLB),
  * data-locality-aware dispatch (prefer hosts whose node-local store holds
    the task's inputs — "send work to data", §III),
  * straggler mitigation: speculative backup tasks after a median-based
    deadline (first completion wins),
  * fault tolerance: worker failure -> heartbeat-detected re-queue + retry,
  * per-task I/O accounting against the node-local cache (staged inputs hit
    the cache; unstaged inputs fall back to shared-FS reads),
  * frame futures (``Task.not_before``): a task keyed to a streamed
    detector frame becomes eligible the moment the frame lands on the
    node-local stores (its ``FrameRecord.t_avail``), not when the whole
    dataset closes — the scheduling half of `repro_torch.core.streaming`.
"""
from __future__ import annotations

import heapq
import math
import random
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fabric import Fabric


@dataclass
class Task:
    task_id: int
    duration: Optional[float] = None          # simulated seconds
    fn: Optional[Callable[[], Any]] = None    # real payload (measured)
    inputs: Tuple[str, ...] = ()              # file deps (node-local or FS)
    deps: Tuple[int, ...] = ()                # task-id dependencies
    not_before: float = 0.0                   # earliest eligibility (sim s):
    #   a frame future — set to FrameRecord.t_avail so the task becomes
    #   runnable the moment its frame lands, not when the dataset closes
    session: Optional[str] = None             # analysis-session tenant tag
    #   (AnalysisSession.tag); per-session accounting lands in
    #   EngineStats.sessions
    priority: int = 0                         # QoS class: higher dispatches
    #   first among queued-and-eligible tasks (ties keep FIFO order, so
    #   all-default workloads schedule exactly as before)
    retries: int = 0
    result: Any = None


@dataclass
class TaskEvent:
    task_id: int
    worker: int
    start: float
    end: float
    kind: str = "run"          # run | backup | retry


@dataclass
class SessionStats:
    """Per-analysis-session slice of an engine run (multi-tenant view)."""
    tasks: int = 0
    input_read_time: float = 0.0      # simulated input time, this session
    busy_time: float = 0.0            # sum of event durations
    makespan: float = 0.0             # last completion of a session task


@dataclass
class EngineStats:
    makespan: float = 0.0
    events: List[TaskEvent] = field(default_factory=list)
    steals: int = 0
    backups_launched: int = 0
    backups_won: int = 0
    failures_recovered: int = 0
    input_read_time: float = 0.0      # total simulated input time
    cache_hits: int = 0
    cache_misses: int = 0
    sessions: Dict[str, SessionStats] = field(default_factory=dict)

    def cpu_seconds(self) -> float:
        return sum(e.end - e.start for e in self.events)

    def session(self, session_id: str) -> SessionStats:
        return self.sessions.setdefault(session_id, SessionStats())


class ManyTaskEngine:
    """ADLB-style scheduler over `n_workers` ranks spread across fabric hosts.

    Workers pull from a shared queue (ADLB server analogue). Locality: tasks
    whose inputs are resident on a host's node-local store are preferentially
    matched to that host's workers.
    """

    def __init__(self, fabric: Fabric, n_workers: Optional[int] = None,
                 seed: int = 0, straggler_factor: float = 0.0,
                 backup_threshold: float = 2.0,
                 failure_times: Optional[Dict[int, float]] = None,
                 heartbeat: float = 1.0):
        self.fabric = fabric
        self.n_workers = n_workers or fabric.n_ranks
        self.rng = random.Random(seed)
        self.straggler_factor = straggler_factor   # prob a run is straggling
        self.backup_threshold = backup_threshold   # x p95 before backup
        self.failure_times = failure_times or {}   # worker -> failure time
        self.heartbeat = heartbeat

    def host_of(self, worker: int) -> int:
        per = max(1, self.n_workers // self.fabric.n_hosts)
        return min(worker // per, self.fabric.n_hosts - 1)

    # ------------------------------------------------------------------
    def _input_time(self, task: Task, worker: int, stats: EngineStats
                    ) -> float:
        """Simulated time to acquire inputs: node-local hit is RAM-speed;
        miss falls back to an uncoordinated shared-FS read."""
        host = self.fabric.hosts[self.host_of(worker)]
        t = 0.0
        for path in task.inputs:
            data = host.store.read(path)
            if data is not None:
                stats.cache_hits += 1
                t += data.size / self.fabric.constants.local_read_bw
            else:
                stats.cache_misses += 1
                if path not in self.fabric.fs.files:
                    # streamed frames never touch the shared FS: once the
                    # sliding window evicts one, there is nowhere to
                    # re-fetch it from — fail loudly, not with a KeyError
                    raise RuntimeError(
                        f"task {task.task_id} input {path!r} is neither "
                        f"node-local nor on the shared FS (streamed frame "
                        f"evicted before use? pin it or enlarge the "
                        f"stream window)")
                size = self.fabric.fs.size(path)
                _, t_done = self.fabric.fs.read(path, 0, size, 0.0,
                                                coordinated=False)
                t += self.fabric.constants.fs_op_latency + \
                    size / self.fabric.constants.fs_rand_bw
        return t

    def _duration(self, task: Task) -> float:
        """Run the payload (if any) and return the charged duration:
        declared duration wins; otherwise measured wall time."""
        measured = None
        if task.fn is not None:
            t0 = _time.perf_counter()
            task.result = task.fn()
            measured = _time.perf_counter() - t0
        if task.duration is None:
            return measured or 0.0
        d = float(task.duration)
        if self.straggler_factor and self.rng.random() < self.straggler_factor:
            d *= self.rng.uniform(3.0, 8.0)       # pathological slowdown
        return d

    # ------------------------------------------------------------------
    def run(self, tasks: Sequence[Task]) -> EngineStats:
        stats = EngineStats()
        tasks = list(tasks)
        by_id = {t.task_id: t for t in tasks}
        remaining_deps = {t.task_id: set(t.deps) for t in tasks}
        dependents: Dict[int, List[int]] = {}
        for t in tasks:
            for d in t.deps:
                dependents.setdefault(d, []).append(t.task_id)

        queue: List[int] = []                      # shared ADLB queue
        done: set = set()
        running: Dict[int, Tuple[int, float, float, str]] = {}  # tid -> (worker,s,e,kind)
        backups: Dict[int, int] = {}               # original tid -> backup worker
        dead: set = set()
        durations_seen: List[float] = []

        # event heap: (time, seq, kind, payload)
        seq = 0
        heap: List[Tuple[float, int, str, Any]] = []
        idle: List[int] = list(range(self.n_workers))
        now = 0.0

        for w, ft in self.failure_times.items():
            heapq.heappush(heap, (ft, seq, "fail", w)); seq += 1

        def schedule(tid: int, t_now: float, front: bool = False):
            """Enqueue a dep-free task, honoring its frame future: a task
            whose `not_before` is still ahead waits on a release event."""
            nonlocal seq
            nb = by_id[tid].not_before
            if nb > t_now:
                heapq.heappush(heap, (nb, seq, "release", tid)); seq += 1
            elif front:
                queue.insert(0, tid)
            else:
                queue.append(tid)

        for tid in sorted(t.task_id for t in tasks if not t.deps):
            schedule(tid, 0.0)

        # priority dispatch costs a queue scan per pop; skip it entirely
        # for all-default workloads (100k-task campaigns stay O(1)-pop)
        prioritized = any(t.priority != 0 for t in tasks)

        def dispatch(t_now: float):
            nonlocal seq
            while queue and idle:
                # stable first-max pop: highest Task.priority wins, FIFO
                # among equals — an all-default queue pops the head
                best = 0
                if prioritized:
                    for i in range(1, len(queue)):
                        if (by_id[queue[i]].priority
                                > by_id[queue[best]].priority):
                            best = i
                tid = queue.pop(best)
                if tid in done or tid in running:
                    continue
                task = by_id[tid]
                # locality-aware worker choice
                widx = None
                if task.inputs:
                    for i, w in enumerate(idle):
                        host = self.fabric.hosts[self.host_of(w)]
                        if all(p in host.store.data for p in task.inputs):
                            widx = i
                            break
                if widx is None:
                    widx = 0
                else:
                    stats.steals += 0   # locality match, not a steal
                w = idle.pop(widx)
                if w in dead:
                    continue
                t_in = self._input_time(task, w, stats)
                stats.input_read_time += t_in
                if task.session:
                    stats.session(task.session).input_read_time += t_in
                dur = self._duration(task)
                durations_seen.append(dur)
                start, end = t_now, t_now + t_in + dur
                running[tid] = (w, start, end, "run")
                heapq.heappush(heap, (end, seq, "done", (tid, w, start, "run")))
                seq += 1
                # straggler watchdog: a run exceeding backup_threshold x
                # median-duration gets a speculative backup (median is robust
                # to the stragglers themselves, unlike upper quantiles)
                if self.backup_threshold and len(durations_seen) >= 8:
                    d_sorted = sorted(durations_seen)
                    p50 = d_sorted[len(d_sorted) // 2]
                    deadline = t_now + t_in + self.backup_threshold * p50
                    if deadline < end:
                        heapq.heappush(heap, (deadline, seq, "check", tid))
                        seq += 1

        dispatch(now)
        while heap:
            now, _, kind, payload = heapq.heappop(heap)
            if kind == "fail":
                w = payload
                dead.add(w)
                if w in idle:
                    idle.remove(w)
                # re-queue this worker's running tasks after heartbeat detect
                for tid, (tw, s, e, k) in list(running.items()):
                    if tw == w:
                        del running[tid]
                        by_id[tid].retries += 1
                        stats.failures_recovered += 1
                        heapq.heappush(heap, (now + self.heartbeat, seq,
                                              "requeue", tid)); seq += 1
            elif kind == "requeue":
                tid = payload
                if tid not in done:
                    schedule(tid, now, front=True)
                dispatch(now)
            elif kind == "release":
                tid = payload
                if tid not in done and tid not in running \
                        and tid not in queue:
                    queue.append(tid)
                dispatch(now)
            elif kind == "check":
                tid = payload
                if tid in running and tid not in backups:
                    if idle:
                        # speculative backup (first completion wins)
                        w = idle.pop(0)
                        task = by_id[tid]
                        t_in = self._input_time(task, w, stats)
                        dur = float(task.duration or 0.0)  # nominal draw
                        backups[tid] = w
                        stats.backups_launched += 1
                        heapq.heappush(heap, (now + t_in + dur, seq, "done",
                                              (tid, w, now, "backup")))
                        seq += 1
                    else:
                        # all workers busy: re-check once capacity frees up
                        d = durations_seen[-1] if durations_seen else 1.0
                        heapq.heappush(heap, (now + max(d * 0.5, 1e-3), seq,
                                              "check", tid))
                        seq += 1
            elif kind == "done":
                tid, w, start, runkind = payload
                if w in dead:
                    continue
                if tid in done:
                    idle.append(w)          # losing duplicate
                    dispatch(now)
                    continue
                done.add(tid)
                if runkind == "backup":
                    stats.backups_won += 1
                    # release the straggling primary's worker notionally
                    if tid in running:
                        pw = running.pop(tid)[0]
                        if pw not in dead:
                            idle.append(pw)
                else:
                    running.pop(tid, None)
                stats.events.append(TaskEvent(tid, w, start, now, runkind))
                if by_id[tid].session:
                    s = stats.session(by_id[tid].session)
                    s.tasks += 1
                    s.busy_time += now - start
                    s.makespan = max(s.makespan, now)
                idle.append(w)
                for dep in dependents.get(tid, ()):  # release dependents
                    remaining_deps[dep].discard(tid)
                    if not remaining_deps[dep] and dep not in done:
                        schedule(dep, now)
                dispatch(now)
        stats.makespan = max((e.end for e in stats.events), default=0.0)
        missing = set(by_id) - done
        if missing:
            raise RuntimeError(f"tasks never completed: {sorted(missing)[:5]}")
        return stats
