"""Stage 1 in plain PyTorch: the filter, 4-connected labels and centroids.

The semantics of the NF-HEDM reduction (paper §VI-A), per frame:

1. ``img = max(frame - dark, 0)``;
2. ``med`` = the 3x3 median of ``img``, ``lap`` = the 3x3 Laplacian
   ``8 c - (sum of the 8 neighbours)`` of ``med``, both with the border
   replicated;
3. ``mask = lap > thr and med > thr / 2``; the frame's count is its mask
   pixels;
4. spots are the 4-connected components of the mask, numbered by their
   first pixel in row-major order;
5. a spot's peak is ``(sum v y / sum v, sum v x / sum v, sum v)`` over its
   pixels, ``v`` the frame's pixel as given (before the dark frame is
   taken off), summed in float64 and stored in float32.

Labels are found by propagating the least pixel index over mask edges with
pointer jumping, on the mask's pixels only (no union-find over runs, as the
program has). ``dtype`` is the precision of every floating step: float32
(and float64 sums) for the reference; ``torch.bfloat16`` makes the control
that a lower precision must fail.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _shifts(x: torch.Tensor) -> List[torch.Tensor]:
    """The 9 neighbours of every pixel of (B, H, W), border replicated,
    in row-major order over the 3x3 window."""
    B, H, W = x.shape
    p = torch.cat([x[:, :1], x, x[:, -1:]], 1)
    p = torch.cat([p[:, :, :1], p, p[:, :, -1:]], 2)
    return [p[:, i:i + H, j:j + W] for i in range(3) for j in range(3)]


def filter_mask(frames: torch.Tensor, dark: torch.Tensor, threshold: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W) bool mask of frames (B, H, W) against dark (H, W)."""
    img = torch.clamp_min(frames.to(dtype) - dark.to(dtype), 0)
    med = torch.stack(_shifts(img)).median(dim=0).values
    n = _shifts(med)
    ring = n[0] + n[1] + n[2] + n[3] + n[5] + n[6] + n[7] + n[8]
    lap = 8 * n[4] - ring
    thr = torch.tensor(threshold, dtype=dtype, device=frames.device)
    return (lap > thr) & (med > thr / 2)


def components(mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat indices of the mask's pixels, the component of each, numbered
    from 0 in row-major order of their first pixel, and that first pixel's
    flat index a component) over all of (B, H, W); components never cross
    frames."""
    B, H, W = mask.shape
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)          # ascending
    n = idx.numel()
    if n == 0:
        return idx, idx, idx
    a, b = [], []
    for step, ok in ((1, idx % W != W - 1), (W, (idx // W) % H != H - 1)):
        nb = idx + step
        pos = torch.searchsorted(idx, nb).clamp_max(n - 1)
        hit = ok & (idx[pos] == nb)
        a.append(torch.nonzero(hit).reshape(-1))
        b.append(pos[hit])
    a, b = torch.cat(a), torch.cat(b)
    lab = torch.arange(n, device=idx.device)
    while True:
        new = lab.clone()
        new.scatter_reduce_(0, a, lab[b], "amin")
        new.scatter_reduce_(0, b, lab[a], "amin")
        new = new[new]
        if torch.equal(new, lab):
            break
        lab = new
    roots, comp = torch.unique(lab, return_inverse=True)        # sorted
    return idx, comp, idx[roots]


def reduce_block(frames: np.ndarray, dark: np.ndarray, threshold: float,
                 device: torch.device, dtype: torch.dtype = torch.float32):
    """Stage 1 of a block of frames (B, H, W), numpy in the detector's
    dtype -> one ``(count, n_spots, peaks (n, 3) float32)`` a frame."""
    B, H, W = frames.shape
    f = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    d = torch.from_numpy(np.ascontiguousarray(dark)).to(device)
    mask = filter_mask(f, d, threshold, dtype)
    counts = mask.sum(dim=(1, 2)).tolist()
    idx, comp, first = components(mask)
    acc = torch.float64 if dtype == torch.float32 else dtype
    v = f.reshape(-1)
    if v.dtype == torch.uint16:          # CUDA indexes no uint16 tensor
        v = v.to(torch.int32)
    v = v[idx].to(acc)
    pix = idx % (H * W)
    ys, xs = (pix // W).to(acc), (pix % W).to(acc)
    k = first.numel()
    sums = torch.zeros((3, k), dtype=acc, device=device)
    for row, w in enumerate((v, v * ys, v * xs)):
        sums[row].index_add_(0, comp, w)
    s_i, s_y, s_x = sums
    denom = torch.clamp_min(s_i, 1e-9) if acc == torch.float64 else s_i
    peaks = torch.stack([s_y / denom, s_x / denom, s_i], 1).float().cpu()
    per = torch.bincount((first // (H * W)).cpu(), minlength=B).tolist()
    out, at = [], 0
    for b in range(B):
        out.append((int(counts[b]), per[b], peaks[at:at + per[b]].numpy()))
        at += per[b]
    return out
