"""The system under test: the entries of ``repro_torch`` that the loops
drive. This is the only file of the benchmark that imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


class Program:
    """``repro_torch.hedm.pipeline``'s stage 1 and stage 2 on ``device``."""

    def __init__(self, device: torch.device):
        from repro_torch.hedm import pipeline
        self.pipeline = pipeline
        self.device = device

    def reduce_frames(self, frames: np.ndarray, dark: np.ndarray,
                      threshold: float,
                      timings: Optional[Dict[str, float]] = None) -> List:
        """Stage 1 of ``frames`` on the kernel: one ``ReducedFrame`` (its
        ``n_signal_pixels``, ``n_spots`` and ``peaks``) a frame, on the
        host."""
        return self.pipeline.reduce_frames(frames, dark, threshold=threshold,
                                           use_kernel=True,
                                           device=self.device,
                                           timings=timings)

    def fit_grid(self, y_obs: torch.Tensor, gvec: torch.Tensor,
                 theta0: torch.Tensor, iters: int) -> torch.Tensor:
        """Stage 2: (P, 3) fitted orientations, on the device."""
        return self.pipeline.fit_grid(y_obs, gvec, theta0, iters=iters,
                                      device=self.device)
