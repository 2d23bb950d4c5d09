"""Quickstart: stage training data through the client API, train a small
LM a few steps, then serve it.

Counterpart of ``examples/quickstart.py`` on ``device``: token shards land
on the simulated shared FS and are staged collectively to every node-local
store under the BGQ 5D-torus machine model (``TopologyConfig``), training
(qwen3-32b's smoke config, 20 steps of 8 x 64 tokens in 2 microbatches,
remat) reads the staged replica, and a continuous-batching session serves
4 requests from the trained weights.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.api import (CollectiveConfig, Report, StagingClient,
                                  TopologyConfig)
from repro_torch.core.fabric import BGQ, Fabric
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.examples._say import Say
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeSession
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


def stage_tokens(n_steps: int, batch: int, seq: int, vocab: int,
                 n_hosts: int = 16, say=print) -> Tuple[np.ndarray, Report]:
    """Produce token shards on the shared FS and stage them to node-local
    memory with the unified client API, topology selected explicitly.
    Returns the tokens read back from host 0's replica and the report."""
    rng = np.random.default_rng(0)
    fab = Fabric(n_hosts=n_hosts, constants=BGQ)
    toks = rng.integers(0, vocab, (n_steps, batch, seq), dtype=np.int32)
    fab.fs.put("tokens/train.bin", toks)

    client = StagingClient(fab)
    config = CollectiveConfig(topology=TopologyConfig("bgq_torus"))
    rep = client.stage("tokens/*.bin", config)
    r = rep.reports[0]
    tiers = ", ".join(f"{k}={v >> 10} KiB" for k, v in r.tier_bytes.items())
    say(f"staged {rep.total_bytes >> 10} KiB to {rep.n_hosts} hosts in "
        f"{rep.total_time * 1e3:.1f} simulated ms "
        f"(engine={rep.engine}, wire: {tiers or 'none'})")

    # train from the staged node-local replica (byte-exact with the FS)
    replica = fab.hosts[0].store.read("tokens/train.bin")
    return np.frombuffer(replica.tobytes(), dtype=np.int32).reshape(
        n_steps, batch, seq), rep


def serve(params: M.Model, cfg: ModelConfig, device: DeviceLike = "cuda",
          say=print) -> List[Request]:
    """4 requests of 12 prompt tokens (numpy seed 0), 8 new tokens each,
    on 2 slots of a 128-token cache; the finished requests."""
    rng = np.random.default_rng(0)
    sess = ServeSession(params, cfg, batch_slots=2, capacity=128,
                        device=device)
    for rid in range(4):
        sess.submit(Request(request_id=rid,
                            prompt=rng.integers(0, cfg.vocab, 12,
                                                dtype=np.int32),
                            max_new_tokens=8))
    finished = sess.run_to_completion()
    for req in finished:
        say(f"  request {req.request_id}: generated {req.generated}")
    return finished


def main(device: DeviceLike = "cuda", params: Optional[M.Model] = None,
         verbose: bool = True) -> Dict:
    """Stage, train, serve; return ``text``, ``staging`` (the report),
    ``losses`` and ``lrs`` (every step's), ``params`` (the trained model)
    and ``finished`` (the served requests). ``params`` (a model of the
    smoke config on ``device``, trained in place) defaults to
    ``init_model`` from a generator seeded 0."""
    dev = resolve_device(device)
    say = Say(verbose)
    cfg = get_smoke_config("qwen3_32b")
    say(f"arch: {cfg.name} (reduced) — {cfg.n_layers}L d={cfg.d_model}")

    opt = OptConfig(total_steps=40, warmup_steps=5, peak_lr=3e-3)
    if params is None:
        params = M.init_model(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    params.requires_grad_(True)
    opt_state = init_opt_state(params)
    shape = ShapeConfig("demo", "train", 64, 8, num_microbatches=2,
                        remat=True)
    step = make_train_step(cfg, shape, opt)

    say("staging synthetic tokens ...")
    tokens, staging = stage_tokens(n_steps=20, batch=8, seq=64,
                                   vocab=cfg.vocab, say=say)

    say("training on staged tokens ...")
    losses, lrs = [], []
    for i in range(len(tokens)):
        toks = torch.tensor(tokens[i], device=dev)
        batch = {"tokens": toks, "labels": toks}
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        if i % 5 == 0:
            say(f"  step {i:3d}  loss={losses[-1]:.4f}  lr={lrs[-1]:.2e}")

    say("serving with continuous batching ...")
    finished = serve(params, cfg, dev, say)
    return {"text": say.text, "staging": staging, "losses": losses,
            "lrs": lrs, "params": params, "finished": finished}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
