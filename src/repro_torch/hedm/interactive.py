"""The paper's end-to-end interactive NF-HEDM workflow (Fig. 7) on the port:

  detector -> shared FS -> [Swift I/O hook: collective staging] ->
  stage-1 reduction (hedm_reduce CUDA kernel) -> stage-2 FitOrientation
  (batched Gauss-Newton in PyTorch) -> many-task makespan at paper scale

Step for step the counterpart of ``examples/hedm_interactive.py``, at the
paper's detector size by default: a layer of 736 frames of 2048x2048
(12.35 GB of float32) and 100,000 grid points. On a card the scan is
rendered there (``simulate_detector_frames(device=...)``); the staging and
the makespan are the numpy simulator, in simulated seconds.

    PYTHONPATH=src python -m repro_torch.hedm.interactive [--frames N]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core.api import (BroadcastEntry, CollectiveConfig,
                                  NaiveConfig, StagingClient, StagingSpec)
from repro_torch.core.fabric import BGQ, Fabric
from repro_torch.core.manytask import ManyTaskEngine, Task
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hedm.pipeline import (fit_grid, make_gvectors, reduce_frames,
                                       simulate_detector_frames, stream_to_fs,
                                       synth_grid_observations)

PER_POINT_S = 30.0            # paper: ~30 s of FitOrientation per grid point
BUDGET_S = 5 * 60             # the paper's interactive target


def main(device: DeviceLike = "cuda", n_frames: int = 736, size: int = 2048,
         grid_points: int = 100_000, n_spots: int = 12, n_tasks: int = 100_000,
         n_workers: int = 2048, seed: int = 0, verbose: bool = True) -> Dict:
    """Run the workflow once on ``device`` and return its results:
    ``n_spots`` (stage-1 spots over all frames), ``recovered`` (stage-2
    share of points within 0.05 of the truth), ``staged_s``/``naive_s``
    (simulated staging seconds), ``makespan_s`` (simulated), and
    ``phases``: wall seconds of ``generation``, ``fs_and_staging``,
    ``h2d``, ``kernel``, ``d2h``, ``labeling``, ``stage2``, ``makespan``.
    """
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    phases: Dict[str, float] = {}

    def sync() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    say(f"=== NF-HEDM interactive pipeline (paper Fig. 7) on {dev} ===")
    # (1) detector writes frames to the shared FS
    t0 = sync()
    frames, dark = simulate_detector_frames(n_frames, size=size,
                                            n_spots=n_spots, seed=seed,
                                            device=dev)
    phases["generation"] = sync() - t0
    t0 = time.perf_counter()
    fabric = Fabric(n_hosts=128, ranks_per_host=16, constants=BGQ)
    paths = stream_to_fs(fabric, frames)
    say(f"(1) detector: {n_frames} frames -> shared FS "
        f"({fabric.fs.size(paths[0]) >> 10} KB each)")

    # (2) Swift I/O hook via the unified client, and the naive baseline on
    # a second fabric, freed once its report is taken (its FS holds a full
    # copy of the scan)
    spec = StagingSpec([BroadcastEntry(files=("scan/*.bin",))])
    res = StagingClient(fabric).stage(spec, CollectiveConfig())
    say(f"(2) I/O hook: staged {len(res.resolved_files)} files to "
        f"{fabric.n_hosts} nodes in {res.total_time:.3f}s (simulated)")
    fab2 = Fabric(n_hosts=128, ranks_per_host=16, constants=BGQ)
    stream_to_fs(fab2, frames)
    naive_s = StagingClient(fab2).stage(spec, NaiveConfig()).total_time
    del fab2
    say(f"    naive per-node input would take {naive_s:.3f}s "
        f"({naive_s / res.total_time:.1f}x)")
    phases["fs_and_staging"] = time.perf_counter() - t0

    # (3) stage 1: reduction on the kernel (h2d, kernel, d2h, labeling)
    t0 = time.perf_counter()
    reduced = reduce_frames(frames, dark, threshold=200.0, use_kernel=True,
                            device=dev, timings=phases)
    t1 = time.perf_counter() - t0
    n_spots_found = sum(r.n_spots for r in reduced)
    del frames
    say(f"(3) stage 1: {n_frames} frames reduced in {t1:.2f}s wall — "
        f"{n_spots_found} diffraction spots")

    # (4) stage 2: FitOrientation over the sample grid, one batched program
    gvec = make_gvectors()
    truth, obs = synth_grid_observations(grid_points, gvec, device=dev)
    t0 = sync()
    fit = fit_grid(obs, gvec, np.zeros((grid_points, 3), np.float32),
                   device=dev)
    phases["stage2"] = sync() - t0
    err = np.abs(fit.cpu().numpy() - truth).max(axis=1)
    recovered = float((err < 0.05).mean())
    say(f"(4) stage 2: {grid_points} grid points fit in "
        f"{phases['stage2']:.2f}s wall — {recovered * 100:.0f}% recovered")

    # (5) makespan accounting in the simulated cluster (paper Fig. 8 scale)
    t0 = time.perf_counter()
    eng = ManyTaskEngine(fabric, n_workers=n_workers)
    stats = eng.run([Task(task_id=i, duration=PER_POINT_S,
                          inputs=(paths[i % n_frames],))
                     for i in range(n_tasks)])
    phases["makespan"] = time.perf_counter() - t0
    say(f"(5) at scale: {n_tasks} grid points x {PER_POINT_S:.0f}s on "
        f"{n_workers} workers -> makespan {stats.makespan / 60:.1f} min "
        f"(cache hits {stats.cache_hits})")
    total = res.total_time + stats.makespan
    say(f"==> interactive budget: {total / 60:.1f} min vs 5 min target "
        f"({'MET with >=10k workers' if stats.makespan > BUDGET_S else 'MET'})")
    return {"n_frames": n_frames, "n_spots": n_spots_found,
            "recovered": recovered, "staged_s": res.total_time,
            "naive_s": naive_s, "makespan_s": stats.makespan,
            "cache_hits": stats.cache_hits, "phases": phases}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=736)
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--grid-points", type=int, default=100_000)
    a = ap.parse_args()
    main(device=a.device, n_frames=a.frames, size=a.size,
         grid_points=a.grid_points)


if __name__ == "__main__":
    _cli()
