"""Online NF-HEDM over streamed detector ingestion, end to end, on the port.

Step for step the counterpart of ``examples/hedm_streaming.py``. The batch
workflow waits for the whole scan to land on the shared FS, stages it
collectively, then reduces it in one pass (``run_batch_hedm``). The
streamed workflow pushes frames straight into node-local memory as the
detector produces them (scatter to the owning leader, ring broadcast, a
bounded sliding window with watermark eviction and backpressure) and runs
stage 1 on each full window while acquisition is still in flight
(``run_online_hedm``). Both reduce through the ``hedm_reduce`` kernel on a
card (its plain version on the CPU) and must give identical bytes.

The defaults are the example's scenario: 64 hosts, 32 frames of 128x128
with 8 spots at 4 Hz, reduce windows of 8 frames, a node cache of 16
frames, and a declared stage-1 cost of 0.15 simulated s a frame. On a card
the scan is rendered there (``simulate_detector_frames(device=...)``); on
the CPU it is the numpy scan, the reference's own. Staging, delivery and
turnarounds are the numpy simulator, in simulated seconds.

    PYTHONPATH=src python -m repro_torch.hedm.streaming [--frames N --size W]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import torch

from repro_torch.core.streaming import StreamScenario
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hedm.pipeline import (pack_reduced, run_batch_hedm,
                                       run_online_hedm,
                                       simulate_detector_frames)

#: the example's scenario apart from the scan's size: 64 hosts, 8 spots a
#: frame at 4 Hz, reduce windows of 8 frames, a node cache of 16 frames
SCENARIO = dict(n_hosts=64, n_spots=8, rate_hz=4.0, window_frames=8,
                cache_frames=16, seed=0)
REDUCE_S_PER_FRAME = 0.15        # declared stage-1 cost (simulated s/frame)


def main(device: DeviceLike = "cuda", n_frames: int = 32,
         frame_size: int = 128, verbose: bool = True) -> Dict:
    """Run the batch and the streamed workflow over one scan on ``device``
    and return: ``packed`` (the streamed output, ``pack_reduced``),
    ``n_spots``, ``batch_turnaround_s``, ``online_turnaround_s``,
    ``first_result_s`` and ``window_done`` (simulated), ``stream`` (the
    ingest side's ``StreamReport``) and ``wall``: host seconds of
    ``generation``, ``batch`` and ``online``, each ending with the device
    done. Raises if the streamed output differs from the batch output by a
    byte."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    sc = StreamScenario(n_frames=n_frames, frame_size=frame_size,
                        **SCENARIO)
    rate_hz, window = sc.rate_hz, sc.window_frames
    wall: Dict[str, float] = {}

    def sync() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync()
    frames, dark = simulate_detector_frames(
        n_frames, size=frame_size, n_spots=sc.n_spots, seed=sc.seed,
        device=dev if dev.type == "cuda" else None)
    wall["generation"] = sync() - t0
    say(f"=== Online HEDM: streaming detector ingestion on {dev} ===")
    say(f"scan: {n_frames} frames x {sc.frame_bytes >> 10} KB at "
        f"{rate_hz:g} Hz -> acquisition spans {n_frames / rate_hz:.1f}s "
        f"(simulated)")

    # batch baseline: detector -> FS -> stage_collective -> one-shot reduce
    t0 = sync()
    batch, t_batch, stage_rep = run_batch_hedm(
        sc.make_fabric(), frames, dark, rate_hz=rate_hz, use_kernel=True,
        reduce_time_per_frame=REDUCE_S_PER_FRAME, device=dev)
    wall["batch"] = sync() - t0
    say(f"(batch)  scan closes at {n_frames / rate_hz:.1f}s, staging "
        f"{stage_rep.total_time:.2f}s ({stage_rep.mode}), reduce "
        f"{n_frames * REDUCE_S_PER_FRAME:.1f}s -> turnaround {t_batch:.2f}s")

    # streaming: frames reduced per window while acquisition runs
    t0 = sync()
    online = run_online_hedm(
        sc.make_fabric(), frames, dark, rate_hz=rate_hz, window=window,
        use_kernel=True, cache_frames=sc.cache_frames,
        reduce_time_per_frame=REDUCE_S_PER_FRAME, device=dev)
    wall["online"] = sync() - t0
    srep = online.stream
    say(f"(stream) first results at {online.window_done[0]:.2f}s "
        f"(acquisition still running), turnaround {online.turnaround:.2f}s "
        f"-> {t_batch / online.turnaround:.2f}x")
    say(f"         window: peak {srep.peak_resident_bytes >> 10} KB of "
        f"{sc.window_bytes >> 10} KB budget, {srep.evictions} evictions, "
        f"backpressure stall {srep.stall_time:.2f}s, mean frame latency "
        f"{srep.mean_latency * 1e3:.2f} ms")

    packed = pack_reduced(online.reduced)
    if packed.tobytes() != pack_reduced(batch).tobytes():
        raise AssertionError("the streamed stage-1 output differs from the "
                             "batch output")
    n_found = sum(r.n_spots for r in online.reduced)
    say(f"==> {len(online.reduced)} frames reduced, {n_found} spots; "
        f"streaming output bit-identical to batch: True")
    return {"n_frames": n_frames, "n_spots": n_found, "packed": packed,
            "batch_turnaround_s": t_batch,
            "online_turnaround_s": online.turnaround,
            "first_result_s": online.window_done[0],
            "window_done": online.window_done, "stream": srep,
            "wall": wall}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=128)
    a = ap.parse_args()
    main(device=a.device, n_frames=a.frames, frame_size=a.size)


if __name__ == "__main__":
    _cli()
