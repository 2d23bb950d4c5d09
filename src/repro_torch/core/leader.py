"""Leader communicator (paper §IV).

Exactly one I/O rank per node forms the leader group; the remaining ranks
never touch the shared FS during staging. Metadata is resolved by the group
root and broadcast. In the JAX runtime this maps to "one process per host"
(jax.process_index) doing I/O; in the simulated fabric, to Host.leader_rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, TypeVar

from repro_torch.core.fabric import Fabric

T = TypeVar("T")


def manifest_bytes(files: Sequence[str]) -> int:
    """Wire size of a resolved file manifest: the path strings plus an
    8-byte (size/offset) header per entry — the payload ``on_root``
    broadcasts after the root's glob."""
    return sum(len(f) for f in files) + 8 * len(files)


@dataclass
class LeaderGroup:
    """One member per host. Root = member 0 (metadata resolution)."""
    fabric: Fabric

    @property
    def members(self) -> List[int]:
        return [h.leader_rank() for h in self.fabric.hosts]

    @property
    def root(self) -> int:
        return self.members[0]

    def is_leader(self, rank: int) -> bool:
        return rank in set(self.members)

    def on_root(self, fn: Callable[[], T],
                payload_bytes: Optional[int] = None) -> Tuple[T, float]:
        """Run a metadata operation once (root) and broadcast its result
        to the other leaders.

        Returns ``(result, broadcast seconds)`` — the broadcast duration
        is simulated time the CALLER must place on its timeline and
        charge into ``StagingReport.broadcast_time`` (it is real wire
        traffic, accounted in ``Interconnect.bytes_moved`` here).
        ``payload_bytes`` overrides the wire-size estimate; by default
        the result is treated as a file manifest (:func:`manifest_bytes`).
        """
        result = fn()
        if payload_bytes is None:
            payload_bytes = manifest_bytes(result)  # type: ignore[arg-type]
        return result, self.broadcast_time(max(int(payload_bytes), 1))

    def broadcast_time(self, nbytes: int) -> float:
        """Duration of one leader-group broadcast of `nbytes`, planned
        over the fabric's topology (`repro_torch.core.collectives`) and
        accounted on the interconnect's per-tier counters."""
        return self.fabric.net.broadcast(nbytes, self.fabric.n_hosts)


def jax_leader_process(process_index: int, processes_per_host: int = 1) -> bool:
    """JAX-runtime analogue: is this process its host's I/O leader?"""
    return process_index % processes_per_host == 0
