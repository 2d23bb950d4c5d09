"""Closed loop of stage-2 fits: one ``fit_grid`` call over a whole grid,
its orientations copied to the host as the answer, the next call sent when
it has come back. ``grids`` grids are drawn in set-up and cycled, so no
call repeats its predecessor's input.

Mix parameters: ``grids``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from portbench import judge as judging
from portbench.gen import grid as gen_grid


@dataclass
class Grids:
    y: List[torch.Tensor]       # (P, 2N) observations on the device
    gvec: torch.Tensor          # (N, 3)
    theta0: torch.Tensor        # (P, 3)
    iters: int
    damping: float


def prepare(config, mix, seed: int, device: torch.device) -> Grids:
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    gvec = torch.from_numpy(gen_grid.gvectors(config["n_gvec"])).to(device)
    y = [gen_grid.observations(config["grid_points"], gvec, gen,
                               noise=config["noise"],
                               spread=config["truth_spread"])[1]
         for _ in range(int(mix["grids"]))]
    theta0 = torch.zeros((config["grid_points"], 3), device=device)
    return Grids(y, gvec, theta0, int(config["gn_iters"]),
                 float(config["gn_damping"]))


def warmup(grids: Grids, program) -> None:
    for _ in range(2):
        program.fit_grid(grids.y[-1], grids.gvec, grids.theta0,
                         grids.iters).cpu()


def window(sess, grids: Grids) -> None:
    P, N = grids.y[0].shape[0], grids.gvec.shape[0]
    meta = {"points": P, "n_gvec": N, "iters": grids.iters}
    sess.start()
    i = 0
    while True:
        g = i % len(grids.y)
        sess.request("fit_grid",
                     lambda: sess.program.fit_grid(
                         grids.y[g], grids.gvec, grids.theta0,
                         grids.iters).cpu(),
                     items=P, key=g, meta=meta)
        i += 1
        if sess.over():
            break


def judge(grids: Grids, answers, requests, device):
    return judging.fits(answers, grids.y, grids.gvec, grids.theta0,
                        grids.iters, grids.damping, device)
