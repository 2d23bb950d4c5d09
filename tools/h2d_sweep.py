"""Sweep of stage 1's staging ring (`repro_torch.hedm.h2d`) on a CUDA card.

    PYTHONPATH=src python3 tools/h2d_sweep.py [--out sweep.json] \
        [--layer-frames 256] [--calls 8] [--rounds 10]

Holds a layer of ``--layer-frames`` float32 frames of 2048x2048 in host
memory (pageable, as a staged replica is) and copies windows of it to the
card as ``reduce_frames`` does: nf-f32.stage1's call (8 float32 frames and
the float32 dark frame, 144 MiB) and nf-u16.frame1's (one uint16 frame and
the dark, 24 MiB). Each call takes the next window of the layer, so its
frames come from memory and not from the host's caches. A call is timed
on the host clock to ``torch.cuda.synchronize()``; a variant's rate in a
round is its bytes over the median of ``--calls`` calls (1e9 bytes a
second). Every round runs every variant, in an order rotated a round, so
that a neighbour's load on the host falls on all of them alike; each row
gives the median, least and most of its ``--rounds`` rates.

It prints the card, its power limit, the host's CPUs and torch's intra-op
threads, then the rates of: the pageable ``Tensor.to`` copy, on one thread
and split over 2-8 threads and streams; the DMA alone from page-locked
memory; the host's copy alone into the slots; and the ring at slot sizes
of 4-32 MiB and 2-4 slots (at most 64 MiB), with its slot waits a call,
copying as bytes and as 8-byte words. The last lines check that the
ring's copies equal the pageable ones. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.hedm import h2d  # noqa: E402

MiB = 1 << 20
SIZE = 2048
#: (slot MiB, slots) of the ring's sweep: at most 64 MiB page-locked
SHAPES = [(c, k) for c in (4, 8, 16, 32) for k in (2, 3, 4) if c * k <= 64]


class WordRing(h2d.StagingRing):
    """The ring copying 8-byte words where a chunk allows it."""

    def fill(self, slot, src):
        if src.size % 8 or src.ctypes.data % 8:
            return super().fill(slot, src)
        slot.view(torch.int64).copy_(torch.from_numpy(src.view(np.int64)))


def pageable_split(dev, threads):
    """The pageable copy with each array split over ``threads`` threads,
    each on a stream of its own."""
    streams = [torch.cuda.Stream(dev) for _ in range(threads)]

    def copy(win, dark):
        outs = []
        for a in (win, dark):
            flat = a.reshape(-1)
            out = torch.empty(flat.shape, dtype=torch.float32, device=dev)
            step = -(-flat.size // threads)

            def part(i):
                with torch.cuda.stream(streams[i]):
                    out[i * step:(i + 1) * step].copy_(
                        torch.from_numpy(flat[i * step:(i + 1) * step]),
                        non_blocking=True)
            ts = [threading.Thread(target=part, args=(i,))
                  for i in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            outs.append(out)
        return outs
    return copy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/h2d_sweep.json")
    ap.add_argument("--layer-frames", type=int, default=256)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    env = {"card": smi.strip(), "torch": torch.__version__,
           "cpu_count": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0)),
           "torch_threads": torch.get_num_threads()}
    print(json.dumps(env), flush=True)
    layer = np.empty((args.layer_frames, SIZE, SIZE), np.float32)
    layer[...] = np.arange(SIZE, dtype=np.float32)
    layer[:, :, 0] = np.arange(args.layer_frames, dtype=np.float32)[:, None]
    layer16 = layer.astype(np.uint16)
    dark = np.full((SIZE, SIZE), 8.0, np.float32)
    cells = {"stage1": (layer, 8), "frame1": (layer16, 1)}
    turn = {cell: 0 for cell in cells}

    def window(cell):
        src, n = cells[cell]
        i = turn[cell] % (src.shape[0] // n)
        turn[cell] += 1
        return src[i * n:(i + 1) * n]

    def pageable(win, dark):
        return [torch.from_numpy(a).to(dev) for a in (win, dark)]

    pinned = torch.empty(144 * MiB, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(144 * MiB, dtype=torch.uint8, device=dev)

    def dma_only(win, dark):
        dst.copy_(pinned, non_blocking=True)

    def through(ring, waits):
        def copy(win, dark):
            out, w = ring.stage([win, dark])
            waits.append(w)
            return out
        return copy

    def fill_only(ring):
        def copy(win, dark):
            for a in (win, dark):
                src = a.reshape(-1).view(np.uint8)
                for i, s in enumerate(range(0, src.size, ring.slot_bytes)):
                    piece = src[s:s + ring.slot_bytes]
                    ring.fill(ring.buffers[i % len(ring.buffers)]
                              [:piece.size], piece)
        return copy

    variants = {("stage1", "pageable"): (pageable, None),
                ("frame1", "pageable"): (pageable, None),
                ("stage1", "dma_only"): (dma_only, None)}
    for t in (2, 4, 8):
        variants[("stage1", f"pageable {t} threads")] = (
            pageable_split(dev, t), None)
    for cls, kind in ((h2d.StagingRing, "bytes"), (WordRing, "words")):
        variants[("stage1", f"fill_only {kind} 8x3")] = (
            fill_only(cls(dev, 3, 8 * MiB)), None)
        for c, k in SHAPES:
            for cell in cells:
                waits = []
                variants[(cell, f"ring {kind} {c}x{k}")] = (
                    through(cls(dev, k, c * MiB), waits), waits)

    rates = {key: [] for key in variants}
    keys = list(variants)
    for r in range(args.rounds):
        for key in keys[r % len(keys):] + keys[:r % len(keys)]:
            copy, _ = variants[key]
            secs = []
            for _ in range(args.calls):
                win = window(key[0])
                torch.cuda.synchronize()
                t = time.perf_counter()
                copy(win, dark)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            rates[key].append((win.nbytes + dark.nbytes)
                              / statistics.median(secs) / 1e9)
    results = {"env": env, "rows": []}
    for key, got in rates.items():
        waits = variants[key][1]
        row = {"cell": key[0], "name": key[1],
               "GBps": round(statistics.median(got), 3),
               "min": round(min(got), 3), "max": round(max(got), 3)}
        if waits is not None:
            row["waits_per_call"] = statistics.median(waits)
        results["rows"].append(row)
        print(json.dumps(row), flush=True)

    for cell in cells:     # the ring's bytes against the pageable copy's
        win = window(cell)
        got, _ = h2d.StagingRing(dev, 3, 3 * MiB + 24).stage([win, dark])
        want = pageable(win, dark)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(json.dumps({"cell": cell, "ring_equals_pageable": same}))
        results[f"equal_{cell}"] = same
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
