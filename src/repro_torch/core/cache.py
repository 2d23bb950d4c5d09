"""Application-memory input caching (paper §VI-B).

"We modified NF-HEDM to cache all inputs in application memory (for each
variable, tasks first check to see if it has already been read, if not, they
perform read operations to instantiate it). Since Swift/T reuses the same
processes for subsequent tasks, HEDM tasks after the first do not need to
perform Read operations at all."

``TaskInputCache`` is that layer: a per-worker-process memoization of
deserialized inputs above the node-local store. First access pays the
node-local read; subsequent accesses are free. Also provides the pinned
reuse across human-in-the-loop cycles.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Set, Tuple

import numpy as np

from repro_torch.core.fabric import Fabric, NodeLocalStore, pin_ref, unpin_ref


@dataclass
class TaskInputCache:
    """Per-process in-memory cache over a node-local store.

    ``capacity_bytes`` bounds the deserialized working set (bytes; default
    16 GiB ~ a BG/Q I/O-node's RAM share); beyond it, entries evict FIFO.
    ``read_time_charged`` accumulates SIMULATED seconds spent on cache
    misses (``size / local_read_bw``) — hits are free, which is exactly
    the §VI-B effect; no wall-clock time is ever involved."""
    store: NodeLocalStore
    capacity_bytes: int = 1 << 34
    _mem: Dict[str, Any] = field(default_factory=dict)
    _sizes: Dict[str, int] = field(default_factory=dict)
    _pins: Dict[str, int] = field(default_factory=dict)   # lease refcounts
    _faulted: Set[str] = field(default_factory=set)       # ever faulted in
    hits: int = 0
    misses: int = 0
    read_time_charged: float = 0.0      # simulated seconds spent on misses

    def get(self, path: str,
            deserialize: Callable[[np.ndarray], Any] = lambda b: b
            ) -> Optional[Any]:
        """The deserialized value of `path`, or None if it is resident on
        neither this cache nor the backing node-local store.

        `deserialize` maps the raw uint8 buffer to the application object
        (parsed once, on the miss that faults it in); the raw byte size —
        not the deserialized footprint — is what counts against
        ``capacity_bytes`` and the charged read time."""
        if path in self._mem:
            self.hits += 1              # free: already in application memory
            return self._mem[path]
        raw = self.store.read(path)
        if raw is None:
            if path in self._faulted:
                # a path this cache HELD is now resident nowhere: the
                # backing store force-dropped it (NodeLocalStore.drop
                # clears its pins) — mirror that, or the stale pin would
                # shield a later re-staged copy from capacity eviction
                # forever. A pin placed AHEAD of first staging (never
                # faulted) is live intent and survives.
                self._pins.pop(path, None)
                self._faulted.discard(path)
            return None
        self.misses += 1
        self.read_time_charged += raw.size / self.store.constants.local_read_bw
        val = deserialize(raw)
        self._put(path, val, raw.size)
        self._faulted.add(path)
        return val

    def _put(self, path: str, val: Any, size: int) -> None:
        total = sum(self._sizes.values()) + size
        if total > self.capacity_bytes:
            # one ordered sweep (FIFO ~ LRU-ish, unpinned): the seed
            # restarted the victim generator per eviction — O(n) per
            # victim, O(n^2) per put on a cold cache full of small entries
            for victim in list(self._mem):
                if total <= self.capacity_bytes:
                    break
                if victim in self._pins:
                    continue
                total -= self._sizes.pop(victim)
                del self._mem[victim]
        self._mem[path] = val
        self._sizes[path] = size

    def pin(self, path: str) -> None:
        """Exempt `path` from capacity eviction (lease-aware: a dataset
        leased from the staging service stays deserialized across task
        waves). Refcounted — each pin needs a matching :meth:`unpin`."""
        pin_ref(self._pins, path)

    def unpin(self, path: str) -> None:
        """Drop one pin reference; the entry becomes evictable once the
        last holder unpins. No-op when `path` is not pinned."""
        unpin_ref(self._pins, path)

    def drop(self, path: str) -> None:
        """Force-drop `path` from this cache, mirroring
        `repro_torch.core.fabric.NodeLocalStore.drop`: any pin refs go with the
        entry (a forced drop must not leave stale pins that would shield
        a later re-faulted copy). Pure bookkeeping — no time charged."""
        self._mem.pop(path, None)
        self._sizes.pop(path, None)
        self._pins.pop(path, None)
        self._faulted.discard(path)

    @property
    def resident_bytes(self) -> int:
        """Raw bytes currently held (the eviction accounting basis)."""
        return sum(self._sizes.values())
