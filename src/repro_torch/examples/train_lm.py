"""End-to-end training driver example: staged data pipeline + checkpointed,
fault-tolerant training of a ~100M-param LM.

Counterpart of ``examples/train_lm.py`` on ``device``: the same presets,
the same Zipf-ish synthetic token stream (numpy seed 0), ``OptConfig`` and
step shape, a `CheckpointStore` and a `TrainDriver` that saves every 10
steps; ``--fail-at`` injects a node failure before that step and the
driver restarts from the last checkpoint.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --preset demo --steps 30
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \
        --steps 300

The 100m preset is the deliverable configuration (a few hundred steps on
the card); ``demo`` shrinks it for the CPU.
"""
from __future__ import annotations

import argparse
import copy
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.examples._say import Say
from repro_torch.models import model as M
from repro_torch.runtime.driver import TrainDriver
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import init_train_state, make_train_step

PRESETS = {
    # ~100M params: 12L d=768 12H (GPT-2-small-like, llama-style blocks)
    "100m": ModelConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                        vocab=32000, head_dim=64,
                        param_dtype="float32", compute_dtype="float32"),
    "demo": ModelConfig(name="lm-demo", family="dense", n_layers=4,
                        d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                        vocab=2048, head_dim=32,
                        param_dtype="float32", compute_dtype="float32"),
}


def synthetic_batches(cfg, batch, seq, device, seed=0):
    """Staged input pipeline stand-in: a Zipf-ish synthetic token stream."""
    rng = np.random.default_rng(seed)
    while True:
        z = rng.zipf(1.5, size=(batch, seq)).astype(np.int64)
        toks = torch.from_numpy(np.minimum(z, cfg.vocab - 1)
                                .astype(np.int32)).to(device)
        yield {"tokens": toks, "labels": toks}


def main(device: DeviceLike = "cuda", preset: str = "demo", steps: int = 30,
         batch: int = 8, seq: int = 128, ckpt_dir: Optional[str] = None,
         fail_at: Optional[int] = None, params: Optional[M.Model] = None,
         verbose: bool = True) -> Dict:
    """Train and return ``text``, ``report`` (the driver's: losses,
    checkpoints, restarts) and ``ckpt_dir``. ``params`` (a model of the
    preset on ``device``) gives the initial weights, copied at every
    (re)build; by default ``init_model`` from a generator seeded 0."""
    dev = resolve_device(device)
    say = Say(verbose)
    cfg = PRESETS[preset]
    n_params = cfg.param_count()
    say(f"model {cfg.name}: ~{n_params/1e6:.0f}M params")
    opt = OptConfig(total_steps=max(steps, 10),
                    warmup_steps=max(2, steps // 10), peak_lr=1e-3)
    shape = ShapeConfig("train", "train", seq, batch,
                        num_microbatches=1, remat=True)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    store = CheckpointStore(ckpt_dir)
    batches = synthetic_batches(cfg, batch, seq, dev)

    def build_step(mesh_spec):
        if params is None:
            p, o = init_train_state(
                torch.Generator(device=dev).manual_seed(0), cfg, opt)
        else:
            p = copy.deepcopy(params).requires_grad_(True)
            o = init_opt_state(p)
        raw_step = make_train_step(cfg, shape, opt)

        def step_fn(state):
            p, o = state
            p, o, m = raw_step(p, o, next(batches))
            return (p, o), m
        return step_fn, (p, o)

    schedule = {fail_at: "fail"} if fail_at else {}
    driver = TrainDriver(store, build_step, checkpoint_every=10,
                         failure_schedule=schedule)
    report = driver.run(steps, mesh_spec={})
    say(f"steps={report.steps_completed} restarts={report.restarts} "
        f"checkpoints={report.checkpoints}")
    say(f"loss: {report.losses[0]:.4f} -> {report.losses[-1]:.4f}")
    say(f"checkpoints in {ckpt_dir}")
    return {"text": say.text, "report": report, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="demo", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step (restart demo)")
    a = ap.parse_args()
    main(device=a.device, preset=a.preset, steps=a.steps, batch=a.batch,
         seq=a.seq, ckpt_dir=a.ckpt_dir, fail_at=a.fail_at)
