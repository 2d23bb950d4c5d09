"""Stage 1's copies to the card through a ring of page-locked slots.

``torch.from_numpy(a).to("cuda")`` from pageable memory copies on one host
thread into the driver's own small pinned buffer and DMAs from there, so
it moves at one thread's memcpy rate. :func:`to_device` instead walks each
array in chunks of at most ``SLOT_BYTES``: the host copies a chunk into a
page-locked slot with torch's intra-op threads, then queues the slot's DMA
on the current stream, so the copy engine moves chunk *i* while the host
fills chunk *i+1*. Kernels queued after the call on the same stream are
ordered after the last chunk with no host wait.

The ring is allocated on a device's first call and kept (``SLOTS`` x
``SLOT_BYTES`` page-locked bytes a device); a lock serializes the calls
that share it. The caller's arrays are never page-locked, and their bytes
are in the slots before :func:`to_device` returns, so a caller may edit
them at once.
"""
from __future__ import annotations

import threading
import warnings
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

#: slots of the ring, and bytes a slot: the best of 2-4 slots of 4-32 MiB
#: in ``tools/h2d_sweep.py`` on an H100's host, ~31 GB/s for nf-f32.stage1's
#: 144 MiB a call (smaller chunks pay more per chunk, more slots gain
#: nothing while the host's copy sets the pace)
SLOTS = 2
SLOT_BYTES = 16 << 20


class Chunk(NamedTuple):
    """Bytes ``start:stop`` of array ``array`` of a call, through ``slot``."""
    array: int
    start: int
    stop: int
    slot: int


def chunk_plan(sizes: Sequence[int], slot_bytes: int, slots: int,
               first_slot: int = 0) -> List[Chunk]:
    """The chunks of arrays of ``sizes`` bytes, in order: each array cut
    into pieces of ``slot_bytes`` (its last piece shorter), the slots taken
    round-robin from ``first_slot`` across the arrays of the call."""
    chunks = []
    slot = first_slot
    for i, n in enumerate(sizes):
        for start in range(0, n, slot_bytes):
            chunks.append(Chunk(i, start, min(start + slot_bytes, n), slot))
            slot = (slot + 1) % slots
    return chunks


class StagingRing:
    """``slots`` page-locked buffers of ``slot_bytes`` on the host, each
    with the event recorded after its last DMA to ``device``.

    ``event`` makes the events (a test passes a fake to run the ring on
    the CPU, where the buffers are not page-locked)."""

    def __init__(self, device: torch.device, slots: int = SLOTS,
                 slot_bytes: int = SLOT_BYTES, event=torch.cuda.Event):
        pin = device.type == "cuda"
        self.device = device
        self.slot_bytes = slot_bytes
        self.buffers = [torch.empty(slot_bytes, dtype=torch.uint8,
                                    pin_memory=pin) for _ in range(slots)]
        self.events = [event() for _ in range(slots)]
        self.next_slot = 0
        self.lock = threading.Lock()

    def fill(self, slot: torch.Tensor, src: np.ndarray) -> None:
        """The host's copy of ``src`` (bytes) into ``slot``."""
        slot.copy_(torch.from_numpy(src))

    def stage(self, arrays: Sequence[np.ndarray]
              ) -> Tuple[List[torch.Tensor], int]:
        """Each of ``arrays`` as a new tensor on the device, its copy
        queued on the current stream, and how often a slot's last DMA had
        not finished when the host came to refill it."""
        srcs = [np.ascontiguousarray(a) for a in arrays]
        out = [torch.empty(a.shape, dtype=_torch_dtype(a.dtype),
                           device=self.device) for a in srcs]
        src_bytes = [a.reshape(-1).view(np.uint8) for a in srcs]
        dst_bytes = [t.view(-1).view(torch.uint8) for t in out]
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        waits = 0
        with self.lock, warnings.catch_warnings():
            # staged replicas are read-only views; only the slots are
            # written, so torch's warning about a non-writable source is
            # moot
            warnings.simplefilter("ignore", UserWarning)
            plan = chunk_plan([s.size for s in src_bytes], self.slot_bytes,
                              len(self.buffers), self.next_slot)
            for c in plan:
                done = self.events[c.slot]
                if not done.query():
                    waits += 1
                    done.synchronize()
                slot = self.buffers[c.slot][:c.stop - c.start]
                self.fill(slot, src_bytes[c.array][c.start:c.stop])
                dst_bytes[c.array][c.start:c.stop].copy_(slot,
                                                         non_blocking=True)
                done.record(stream)
            if plan:
                self.next_slot = (plan[-1].slot + 1) % len(self.buffers)
        return out, waits


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


_rings: Dict[torch.device, StagingRing] = {}
_rings_lock = threading.Lock()


def ring(device: torch.device) -> StagingRing:
    """The ring of CUDA ``device``, allocated on its first call."""
    dev = torch.device("cuda", device.index if device.index is not None
                       else torch.cuda.current_device())
    with _rings_lock:
        if dev not in _rings:
            _rings[dev] = StagingRing(dev)
        return _rings[dev]


def to_device(arrays: Sequence[np.ndarray], device: torch.device
              ) -> Tuple[List[torch.Tensor], int]:
    """``arrays`` on CUDA ``device`` through its ring: the tensors, their
    copies queued on the current stream, and the ring's slot waits."""
    return ring(device).stage(arrays)
