"""Shared discrete-event timeline for concurrent simulated sessions.

Everything in the simulator is driven by callers passing explicit
simulated times ``t`` (`repro_torch.core.fabric`'s accounting discipline).
That contract has a latent serial-clock assumption: shared-resource
state (``SharedFilesystem.busy_until``, the catalog's admission queue)
is mutated in PROGRAM order, so two sessions interleaved out of
timestamp order would see causally impossible state. The
:class:`EventLoop` here makes the timeline explicit: independent
sessions, stages, streams, repairs and fault injections are scheduled
as timestamped events and executed in GLOBAL simulated-time order with
deterministic tie-breaking — which is exactly what lets them genuinely
overlap (contending for FS bandwidth and node memory) instead of
serializing on call order.

Determinism: events fire in ``(t, priority, seq)`` order. ``seq`` is a
monotone issue counter, so two events at the same instant and priority
fire in the order they were scheduled — the same schedule always
replays identically (the property the invariant suite in
``tests/test_events.py`` pins down). Scheduling into the past raises
:class:`CausalityError`: time never runs backwards on a shared
timeline.

The loop runs callbacks; it moves no bytes and charges no time itself.
`repro_torch.core.qos.QoSScheduler` drives a
`repro_torch.core.datasvc.StagingService` on one of these loops; the
many-task engine's internal heap (`repro_torch.core.manytask`) is the same
idiom specialized to task dispatch.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple


class CausalityError(RuntimeError):
    """Raised when an event is scheduled before the loop's current time."""


@dataclass
class Event:
    """One timestamped callback on the shared timeline.

    ``priority`` breaks ties at equal ``t`` (lower fires first), ``seq``
    breaks ties at equal ``(t, priority)`` (schedule order). ``key`` is
    a free-form label (a session id, a host, ``"fault"``) recorded in
    the loop's history — the invariant suite asserts per-key timestamp
    monotonicity over it."""
    t: float
    priority: int
    seq: int
    fn: Callable[[], None] = field(compare=False)
    key: Optional[str] = field(default=None, compare=False)
    canceled: bool = field(default=False, compare=False)

    def sort_key(self) -> Tuple[float, int, int]:
        return (self.t, self.priority, self.seq)


class EventLoop:
    """Priority queue of timestamped events with deterministic replay.

    ``now`` only moves forward; an event's callback may schedule further
    events at any ``t >= now`` (including ``now`` itself — it fires in
    this same drain, after anything already due there with a smaller
    ``(priority, seq)``)."""

    def __init__(self, t0: float = 0.0, history_limit: int = 100_000,
                 history_key_limit: Optional[int] = None):
        self.now = t0
        self.fired = 0
        # fired events, firing order — a ring buffer so a long-running
        # loop's memory stays bounded. `history_limit` caps the global
        # retention; `history_key_limit` (optional) additionally caps
        # retention PER `key`, so one chatty session cannot crowd every
        # other key out of the window. `fired` keeps counting either way;
        # `history_dropped` counts evictions.
        self.history: Deque[Event] = deque()
        self.history_limit = history_limit
        self.history_key_limit = history_key_limit
        self.history_dropped = 0
        self._key_counts: Dict[Optional[str], int] = {}
        self._heap: List[Tuple[Tuple[float, int, int], Event]] = []
        self._seq = 0

    # -- scheduling ---------------------------------------------------------
    def schedule(self, t: float, fn: Callable[[], None], *,
                 priority: int = 0, key: Optional[str] = None) -> Event:
        """Schedule ``fn`` to fire at simulated time `t`; returns the
        :class:`Event` handle (pass it to :meth:`cancel`)."""
        if t < self.now:
            raise CausalityError(
                f"cannot schedule an event at t={t:.6f} < now={self.now:.6f}"
                f" (key={key!r}): the shared timeline only moves forward")
        ev = Event(t=float(t), priority=priority, seq=self._seq, fn=fn,
                   key=key)
        self._seq += 1
        heapq.heappush(self._heap, (ev.sort_key(), ev))
        return ev

    def schedule_after(self, delay: float, fn: Callable[[], None], *,
                       priority: int = 0, key: Optional[str] = None
                       ) -> Event:
        """Schedule ``fn`` `delay` seconds after ``now`` — the natural
        form for callbacks that compute a duration while handling the
        current event (a consumer finishing `delay` after a frame lands,
        a credit granted one ack later).  A negative delay is a
        causality violation like any past-scheduling."""
        if delay < 0:
            raise CausalityError(
                f"cannot schedule an event {-delay:.6f}s in the past "
                f"(key={key!r}): the shared timeline only moves forward")
        return self.schedule(self.now + delay, fn, priority=priority,
                             key=key)

    def cancel(self, event: Event) -> None:
        """Cancel `event`; a canceled event is skipped silently."""
        event.canceled = True

    # -- inspection ---------------------------------------------------------
    @property
    def pending(self) -> int:
        """Count of scheduled, not-yet-fired, not-canceled events."""
        return sum(1 for _, ev in self._heap if not ev.canceled)

    def peek(self) -> Optional[float]:
        """Timestamp of the next event to fire, or None when drained."""
        while self._heap and self._heap[0][1].canceled:
            heapq.heappop(self._heap)
        return self._heap[0][1].t if self._heap else None

    # -- execution ----------------------------------------------------------
    def _record(self, ev: Event) -> None:
        """Append `ev` to the bounded fired-history ring buffer."""
        self.history.append(ev)
        self._key_counts[ev.key] = self._key_counts.get(ev.key, 0) + 1
        if (self.history_key_limit is not None
                and self._key_counts[ev.key] > self.history_key_limit):
            # evict the OLDEST event with this key (the deque stays in
            # firing order; only the matching entry is removed)
            for i, old in enumerate(self.history):
                if old.key == ev.key:
                    del self.history[i]
                    break
            self._key_counts[ev.key] -= 1
            self.history_dropped += 1
        while len(self.history) > self.history_limit:
            old = self.history.popleft()
            self._key_counts[old.key] -= 1
            if self._key_counts[old.key] == 0:
                del self._key_counts[old.key]
            self.history_dropped += 1

    def step(self) -> Optional[Event]:
        """Fire exactly the next event (advancing ``now`` to it); returns
        it, or None when the timeline is drained."""
        while self._heap:
            _, ev = heapq.heappop(self._heap)
            if ev.canceled:
                continue
            self.now = ev.t
            self.fired += 1
            self._record(ev)
            ev.fn()
            return ev
        return None

    def run(self, until: float = math.inf) -> float:
        """Fire every event with ``t <= until`` (in timeline order,
        including events scheduled along the way); returns the new
        ``now`` — the last firing time, or `until` when it is finite."""
        while True:
            t_next = self.peek()
            if t_next is None or t_next > until:
                break
            self.step()
        if math.isfinite(until) and until > self.now:
            self.now = until
        return self.now

    def advance(self, t: float) -> float:
        """Alias of ``run(until=t)`` — drain the timeline up to `t`."""
        return self.run(until=t)
