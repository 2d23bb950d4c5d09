"""Stage 1's staging ring (`repro_torch.hedm.h2d`) on the CPU: the chunk
plan it follows, and the ring itself run with fake events and buffers that
are not page-locked (the card runs it in ``tests/test_torch_cuda.py``)."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import telemetry
from repro_torch.hedm import h2d
from repro_torch.hedm import pipeline as T

CPU = torch.device("cpu")
FRAME = 2048 * 2048 * 4          # a float32 detector frame's bytes

#: (array sizes in bytes, slot bytes, slots, first slot)
PLANS = [
    ([100], 256, 3, 0),                        # smaller than a chunk
    ([1000], 256, 3, 0),                       # not a multiple of a chunk
    ([1024], 256, 2, 1),                       # a multiple, from slot 1
    ([8 * 96 * 4, 96 * 4, 8 * 96 * 8], 1000, 3, 2),  # frames, dark, weights
    ([0, 5, 0], 4, 2, 1),                      # empty arrays
    ([8 * FRAME, FRAME], h2d.SLOT_BYTES, h2d.SLOTS, 0),  # nf-f32.stage1
    ([FRAME // 2, FRAME], h2d.SLOT_BYTES, h2d.SLOTS, h2d.SLOTS - 1),  # frame1
]


@pytest.mark.parametrize("sizes,slot_bytes,slots,first", PLANS)
def test_chunk_plan_covers_every_byte_once_in_order(sizes, slot_bytes,
                                                    slots, first):
    plan = h2d.chunk_plan(sizes, slot_bytes, slots, first)
    for i, n in enumerate(sizes):
        mine = [c for c in plan if c.array == i]
        bounds = [0] + [c.stop for c in mine]
        assert [c.start for c in mine] == bounds[:-1] and bounds[-1] == n
    assert [c.array for c in plan] == sorted(c.array for c in plan)
    assert all(0 < c.stop - c.start <= slot_bytes for c in plan)
    # round-robin over the slots, across the arrays of the call
    assert [c.slot for c in plan] == [(first + i) % slots
                                      for i in range(len(plan))]
    assert len(plan) == sum(-(-n // slot_bytes) for n in sizes)


def test_the_ring_is_small():
    assert h2d.SLOTS * h2d.SLOT_BYTES <= 64 << 20
    assert h2d.SLOTS >= 2


class FakeEvent:
    """A CUDA event whose DMA never finishes on its own: ``query`` is
    False from ``record`` until ``synchronize``. Every call is logged."""

    def __init__(self, log, slot):
        self.log, self.slot, self.pending = log, slot, False

    def query(self):
        return not self.pending

    def synchronize(self):
        self.log.append(("wait", self.slot))
        self.pending = False

    def record(self, stream=None):
        self.log.append(("record", self.slot))
        self.pending = True


def fake_ring(slots, slot_bytes):
    log = []
    made = iter(range(slots))
    ring = h2d.StagingRing(CPU, slots, slot_bytes,
                           event=lambda: FakeEvent(log, next(made)))
    fill = ring.fill

    def logged(slot, src):
        log.append(("fill", ring_slot(ring, slot)))
        fill(slot, src)
    ring.fill = logged
    return ring, log


def ring_slot(ring, view):
    (i,) = [i for i, b in enumerate(ring.buffers)
            if b.data_ptr() == view.data_ptr()]
    return i


def _arrays(dtype, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 4000, (3, 17, 29)).astype(dtype)
    dark = rng.integers(0, 20, (17, 29)).astype(np.float32)
    return [frames, dark, frames.astype(np.float64)]


@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.int32,
                                   np.float64], ids=str)
@pytest.mark.parametrize("slot_bytes", [7, 64, 1001, 1 << 20])
def test_ring_stages_every_array_whole(dtype, slot_bytes):
    ring, _ = fake_ring(3, slot_bytes)
    arrays = _arrays(dtype)
    arrays[0].setflags(write=False)          # a staged replica is read-only
    out, _ = ring.stage(arrays)
    for a, t in zip(arrays, out):
        assert t.dtype == torch.from_numpy(np.empty(0, a.dtype)).dtype
        assert t.shape == a.shape and t.device == CPU
        assert t.numpy().tobytes() == a.tobytes()
        assert not np.shares_memory(t.numpy(), a)


def test_ring_takes_non_contiguous_arrays():
    ring, _ = fake_ring(2, 40)
    a = np.arange(300, dtype=np.float32).reshape(10, 30)[:, ::3]
    (t,), _ = ring.stage([a])
    assert np.array_equal(t.numpy(), a)


def test_ring_reuses_a_slot_only_after_its_wait():
    ring, log = fake_ring(3, 100)
    sizes = [1000, 250]                      # 10 + 3 chunks
    ring.stage([np.zeros(n, np.uint8) for n in sizes])
    waits = []
    for call in range(2):
        log.clear()
        _, w = ring.stage([np.full(n, call, np.uint8) for n in sizes])
        waits.append(w)
        fills = [s for op, s in log if op == "fill"]
        # round-robin, on from where the last call stopped
        start = 13 * (call + 1) % 3
        assert fills == [(start + i) % 3 for i in range(13)]
        # each fill of a slot after a wait on it, and that wait after the
        # slot's last record: its DMA has finished
        for i, (op, s) in enumerate(log):
            if op == "fill":
                before = [e for e in log[:i] if e[1] == s]
                assert before[-1] == ("wait", s)
    # the first call found three slots never used; later ones wait on all
    assert waits == [13, 13]
    assert ring.next_slot == 13 * 3 % 3


def test_first_call_waits_only_on_reused_slots():
    ring, log = fake_ring(4, 10)
    _, waits = ring.stage([np.ones(95, np.uint8)])     # 10 chunks
    assert waits == 10 - 4
    assert [s for op, s in log if op == "wait"] == [0, 1, 2, 3, 0, 1]


def test_ring_shared_by_threads_keeps_each_call_whole():
    # more threads than cores, switching often: a call interleaved with
    # another (a lost lock) would mix their slots' bytes
    ring, log = fake_ring(3, 64)
    n_threads = 4 * len(os.sched_getaffinity(0))
    results, errors = {}, []

    def work(k):
        try:
            for rep in range(20):
                a = np.full(1000 + k, (k * 20 + rep) % 251, np.uint8)
                (t,), _ = ring.stage([a])
                assert t.numpy().tobytes() == a.tobytes()
            results[k] = True
        except AssertionError as e:      # read on the main thread
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == n_threads
    chunks = sum(20 * -(-(1000 + k) // 64) for k in range(n_threads))
    assert len([e for e in log if e[0] == "fill"]) == chunks
    assert ring.next_slot == chunks % 3


def test_rings_are_one_a_device(monkeypatch):
    monkeypatch.setattr(h2d, "_rings", {})
    monkeypatch.setattr(h2d, "StagingRing", lambda dev: object())
    got = []
    threads = [threading.Thread(
        target=lambda i=i: got.append(h2d.ring(torch.device("cuda", i % 2))))
        for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and len(got) == 16
    assert len({id(r) for r in got}) == 2
    assert set(h2d._rings) == {torch.device("cuda", 0),
                               torch.device("cuda", 1)}


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.float64])
def test_cpu_path_takes_no_ring(monkeypatch, use_kernel, dtype):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path staged through the ring")
    monkeypatch.setattr(h2d, "to_device", refuse)
    frames, dark = T.simulate_detector_frames(2, size=40, n_spots=3, seed=4)
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        T.reduce_frames(frames.astype(dtype), dark, use_kernel=use_kernel,
                        device=CPU)
    counters = tr.metrics.snapshot()["counters"]
    assert counters["stage1.h2d_bytes"] > 0
    assert counters.get("stage1.h2d_pinned_bytes", 0) == 0
    assert "stage1.h2d_slot_waits" not in counters
