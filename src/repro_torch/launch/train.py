"""Training launcher: the train state, the checkpointed fault-tolerant loop.

Counterpart of ``repro.launch.train`` on one device: the same config, step
shape (``remat=True``), ``OptConfig``, random token batches from numpy's
generator at seed 0, a `CheckpointStore` and a `TrainDriver` that saves
every 10 steps. ``fail_at`` injects a node failure before that step (the
driver's ``failure_schedule``): the driver rebuilds the state and restores
the last checkpoint. The batches carry tokens only, as the reference's do,
so a vision or audio config raises for its missing input, as it does
there. A mesh and compressed DCN gradients are not ported yet and raise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \
        --smoke --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import (canonical, get_config,
                                          get_smoke_config)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.driver import DriverReport, TrainDriver
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (POD_TODO, init_train_state,
                                          make_train_step)


def main(arch: str = "qwen3-32b", smoke: bool = False, steps: int = 20,
         batch: int = 8, seq: int = 128, microbatches: int = 1,
         ckpt_dir: Optional[str] = None, device: DeviceLike = "cuda",
         fail_at: Optional[int] = None) -> DriverReport:
    """Train ``steps`` steps and return the driver's report (losses,
    checkpoints, restarts). ``ckpt_dir`` defaults to a new temporary
    directory."""
    dev = resolve_device(device)
    arch = canonical(arch)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = ShapeConfig("train", "train", seq, batch,
                        num_microbatches=microbatches, remat=True)
    opt = OptConfig(total_steps=max(steps, 10),
                    warmup_steps=max(2, steps // 10), peak_lr=1e-3)
    store = CheckpointStore(ckpt_dir
                            or tempfile.mkdtemp(prefix="repro_train_"))
    rng = np.random.default_rng(0)

    def next_batch():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq),
                                             dtype=np.int32)).to(dev)
        return {"tokens": toks, "labels": toks}

    def build_step(mesh_spec):
        params, opt_state = init_train_state(
            torch.Generator(device=dev).manual_seed(0), cfg, opt)
        raw = make_train_step(cfg, shape, opt)

        def step_fn(state):
            p, o = state
            p, o, m = raw(p, o, next_batch())
            return (p, o), m
        return step_fn, (params, opt_state)

    driver = TrainDriver(store, build_step, checkpoint_every=10,
                         failure_schedule=None if fail_at is None
                         else {fail_at: "fail"})
    return driver.run(steps, mesh_spec={})


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure before this step")
    ap.add_argument("--mesh", default=None, help="not ported yet: raises")
    ap.add_argument("--compress-dcn", action="store_true",
                    help="not ported yet: raises")
    a = ap.parse_args()
    if a.mesh or a.compress_dcn:
        raise NotImplementedError(POD_TODO)
    report = main(arch=a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch,
                  seq=a.seq, microbatches=a.microbatches,
                  ckpt_dir=a.ckpt_dir, device=a.device, fail_at=a.fail_at)
    print(f"completed {report.steps_completed} steps; "
          f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}; "
          f"checkpoints {report.checkpoints}; restarts {report.restarts}")
