"""Stage-2 inputs: reciprocal-lattice directions and noisy grid observations.

A frozen copy of ``make_gvectors``, ``forward_model`` and
``synth_grid_observations`` of ``repro_torch.hedm.pipeline``: the same
g-vectors (numpy seed 7), the same ZYZ forward model and the same
distributions (orientations U(-0.6, 0.6), noise N(0, 0.01)). Orientations
and noise are drawn on the device with a seeded ``torch.Generator``, one
grid a call, in float32.
"""
from __future__ import annotations

import numpy as np
import torch

N_GVEC = 24
GVEC_SEED = 7


def gvectors(n: int = N_GVEC, seed: int = GVEC_SEED) -> np.ndarray:
    """(n, 3) unit vectors, float32: ``make_gvectors`` bit for bit."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, 3))
    return (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)


def rotation(theta: torch.Tensor) -> torch.Tensor:
    """(P, 3) angles -> (P, 3, 3) ZYZ rotations Rz(a) Ry(b) Rz(c)."""
    a, b, c = theta.unbind(-1)
    ca, sa, cb, sb = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    rz1 = torch.stack([ca, -sa, zero, sa, ca, zero, zero, zero, one], -1)
    ry = torch.stack([cb, zero, sb, zero, one, zero, -sb, zero, cb], -1)
    rz2 = torch.stack([cc, -sc, zero, sc, cc, zero, zero, zero, one], -1)
    shape = theta.shape[:-1] + (3, 3)
    return rz1.view(shape) @ ry.view(shape) @ rz2.view(shape)


def signature(theta: torch.Tensor, gvec: torch.Tensor) -> torch.Tensor:
    """(P, 3) orientations -> (P, 2N) signatures: sin(3 u) p, cos(2 v) p of
    the rotated g-vectors (u, v, p) = g R^T."""
    rotated = gvec @ rotation(theta).transpose(-1, -2)       # (P, N, 3)
    proj = rotated[..., 2]
    return torch.cat([torch.sin(3.0 * rotated[..., 0]) * proj,
                      torch.cos(2.0 * rotated[..., 1]) * proj], dim=-1)


def observations(n_points: int, gvec: torch.Tensor, gen: torch.Generator,
                 noise: float = 0.01, spread: float = 0.6):
    """(truth (P, 3), y_obs (P, 2N)) float32 on ``gvec``'s device."""
    dev = gvec.device
    truth = (torch.rand((n_points, 3), generator=gen, device=dev)
             * (2 * spread) - spread)
    y = signature(truth, gvec)
    y = y + noise * torch.randn(y.shape, generator=gen, device=dev)
    return truth, y
