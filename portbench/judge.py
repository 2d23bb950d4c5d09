"""The comparison that decides ``correct``: the program's answers against
the plain reference's, at the timed sizes, once the window has closed.

Each function returns the numbers compared, by name; the cell's file
``workloads/<cell>.json`` gives each its limit, and a run is correct when
every number is at or under its limit and no request failed.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import fit, stage1

BLOCK = 8           # frames the reference filters at once


def frames(answers: Sequence[Tuple[Tuple[int, int], list]],
           layer: np.ndarray, dark: np.ndarray, threshold: float,
           device: torch.device) -> Dict[str, float]:
    """Stage 1. ``answers`` are ``((first frame, frames), reduced)`` of every
    answered request; every frame answered is compared with the reference
    of that frame of ``layer``.

    - ``missing``: frames of a request with no reduced frame in place;
    - ``count_mismatch``: frames whose filter count differs;
    - ``spot_mismatch``: frames whose number of spots differs;
    - ``peak_gap``: over the other frames, the widest gap of a spot's y, x
      or intensity, as a share of the reference's (at least 1).
    """
    by_frame: Dict[int, List] = {}
    missing = 0
    for (first, n), reduced in answers:
        reduced = list(reduced)
        for j in range(n):
            r = reduced[j] if j < len(reduced) else None
            if r is None or r.frame_id != j:
                missing += 1
            else:
                by_frame.setdefault(first + j, []).append(r)
    ids = sorted(by_frame)
    count_mismatch = spot_mismatch = 0
    peak_gap = 0.0
    for b in range(0, len(ids), BLOCK):
        block = ids[b:b + BLOCK]
        ref = stage1.reduce_block(layer[block], dark, threshold, device)
        for fid, (count, n_spots, peaks) in zip(block, ref):
            for r in by_frame[fid]:
                got = np.asarray(r.peaks, dtype=np.float64)
                if r.n_signal_pixels != count:
                    count_mismatch += 1
                if r.n_spots != n_spots or got.shape != peaks.shape:
                    spot_mismatch += 1
                elif n_spots:
                    gap = np.abs(got - peaks) / np.maximum(np.abs(peaks), 1)
                    peak_gap = max(peak_gap, float(np.nan_to_num(
                        gap, nan=np.inf).max()))
    return {"missing": missing, "count_mismatch": count_mismatch,
            "spot_mismatch": spot_mismatch, "peak_gap": peak_gap}


def fits(answers: Sequence[Tuple[int, torch.Tensor]], grids: Sequence,
         gvec: torch.Tensor, theta0: torch.Tensor, iters: int,
         damping: float, device: torch.device) -> Dict[str, float]:
    """Stage 2. ``answers`` are ``(grid, fitted orientations)`` of every
    answered request; each is compared with the reference's fit of that
    grid, as rotations (angles that differ by a turn are one orientation).

    - ``missing``: answers of the wrong shape or not finite;
    - ``rot_gap_p99``: the worst answer's 99th percentile over its points
      of the largest entry of |R(program) - R(reference)|. The last
      percent is left out: at points where Gauss-Newton has not converged
      after ``iters`` steps, float32 round-off takes the two fits apart.
    """
    refs = {}
    missing = 0
    worst = 0.0
    for g, theta in answers:
        if g not in refs:
            refs[g] = fit.rotation(fit.fit_blocks(
                grids[g], gvec, theta0, iters, damping))
        want = refs[g]
        theta = torch.as_tensor(theta).to(device)
        if theta.shape != (want.shape[0], 3) or not torch.isfinite(
                theta).all():
            missing += 1
            continue
        gap = (fit.rotation(theta.float()) - want).abs().amax(dim=(1, 2))
        worst = max(worst, float(torch.quantile(gap, 0.99)))
    return {"missing": missing, "rot_gap_p99": worst}
