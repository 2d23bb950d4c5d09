"""Detector frames: a layer rendered on the device, held in host memory.

A frozen copy of ``_simulate_on_device`` of ``repro_torch.hedm.pipeline``:
Poisson(8) background and dark frame, ``spots`` Gaussian spots a frame
with centres U(8, size - 8), amplitudes U(800, 4000) and widths U(1, 2.5),
rendered in float64 and added in float32. The spots' parameters are drawn
first, then each chunk of frames is rendered and copied into one host
array, so the device never holds the layer. ``dtype="uint16"`` rounds and
clips the float32 render to the detector's 16 bits, as the detector writes
it.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 32          # frames rendered at once: 1 GB of float64 spot product
DTYPES = {"float32": (np.float32, torch.float32),
          "uint16": (np.uint16, torch.uint16)}


def layer(n_frames: int, height: int, width: int, spots: int, dtype: str,
          gen: torch.Generator, device: torch.device):
    """(frames (F, H, W) host numpy in ``dtype``, dark (H, W) float32)."""
    np_dtype, t_dtype = DTYPES[dtype]
    f32, f64 = torch.float32, torch.float64
    dark = torch.poisson(torch.full((height, width), 8.0, dtype=f32,
                                    device=device), generator=gen)

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand((n_frames, spots, 1), generator=gen, dtype=f64,
                       device=device)
        return lo + (hi - lo) * u

    cy, cx = uniform(8, height - 8), uniform(8, width - 8)
    amp, sig = uniform(800, 4000), uniform(1.0, 2.5)
    ry = torch.arange(height, dtype=f64, device=device)
    rx = torch.arange(width, dtype=f64, device=device)
    host = np.empty((n_frames, height, width), np_dtype)
    for f0 in range(0, n_frames, CHUNK):
        c = slice(f0, min(f0 + CHUNK, n_frames))
        frames = torch.poisson(torch.full((c.stop - f0, height, width), 8.0,
                                          dtype=f32, device=device),
                               generator=gen)
        if spots:
            gy = amp[c] * torch.exp(-((ry - cy[c]) ** 2) / (2 * sig[c] ** 2))
            gx = torch.exp(-((rx - cx[c]) ** 2) / (2 * sig[c] ** 2))
            frames += torch.einsum("fsh,fsw->fhw", gy, gx).to(f32)
        if t_dtype != f32:
            frames = frames.round_().clamp_(0, 65535).to(torch.int32)
        torch.from_numpy(host[c]).copy_(frames.to(t_dtype))
    return host, dark.cpu().numpy()
