"""The control: the reference in the program's place, one precision down.

The configurations state float32 (stage 1's filter; stage 2 with TF32
off). The control runs stage 1 in bfloat16 and stage 2 with every
product's operands rounded to TF32, and the check must find it not
correct. A served model's configuration states bfloat16 weights: its
control need not decode, so the program serves the window and the check
reads, at each position of the same prompts and served tokens, the gap of
the token that the reference on weights rounded to float8 e4m3 puts first
(``lm_control``; ``reference/lm.py``). ``calibrate.py --control`` runs it
on the chip; the tests run it at a small size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import fit, stage1


@dataclass
class Reduced:
    frame_id: int
    n_signal_pixels: int
    n_spots: int
    peaks: np.ndarray


class Control:
    """Stage 1 and stage 2 of the reference, one precision down, with the
    program's interface; for a served model, the program's session with
    the check's reading turned to the control's."""
    lm_control = True

    def __init__(self, device: torch.device, config: Dict):
        self.device = device
        self.damping = float(config.get("gn_damping", 1e-3))

    def reduce_frames(self, frames: np.ndarray, dark: np.ndarray,
                      threshold: float,
                      timings: Optional[Dict[str, float]] = None
                      ) -> List[Reduced]:
        out = stage1.reduce_block(frames, dark, threshold, self.device,
                                  torch.bfloat16)
        return [Reduced(i, c, n, p) for i, (c, n, p) in enumerate(out)]

    def fit_grid(self, y_obs: torch.Tensor, gvec: torch.Tensor,
                 theta0: torch.Tensor, iters: int) -> torch.Tensor:
        return fit.fit_blocks(y_obs, gvec, theta0, iters, self.damping,
                              tf32=True)

    def serve_session(self, config: Dict, weights, batch_slots: int,
                      capacity: int):
        from portbench.program import Program
        return Program(self.device).serve_session(config, weights,
                                                  batch_slots, capacity)
