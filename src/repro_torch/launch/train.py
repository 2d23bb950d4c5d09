"""Training launcher: the train state, the checkpointed fault-tolerant loop,
on one device or over a mesh of ``torch.distributed`` ranks.

Counterpart of ``repro.launch.train``: the same config, step shape
(``remat=True``), ``OptConfig``, random token batches from numpy's
generator at seed 0, a `CheckpointStore` and a `TrainDriver` that saves
every 10 steps. ``fail_at`` injects a node failure before that step (the
driver's ``failure_schedule``): the driver rebuilds the state and restores
the last checkpoint. The batches carry tokens only, as the reference's do,
so a vision or audio config raises for its missing input, as it does
there.

``--mesh AxB`` ((data, model)) or ``AxBxC`` ((pod, data, model)) trains
over a mesh of that many ranks: the parameters and the optimizer state are
laid onto it (``init_train_state(ctx=...)``), every rank draws the same
batch and the step takes its rows (``make_train_step(ctx=...)``);
``--compress-dcn`` takes the pod branch, with the int8 hop over the pods.
The ranks come from ``torchrun`` (``RANK``, ``WORLD_SIZE`` and its
rendezvous in the environment) or from any launcher that sets ``RANK`` and
``WORLD_SIZE`` and passes ``--init-method`` (``file://...``); NCCL on the
card (``LOCAL_RANK`` picks it), gloo on the CPU. A mesh needs
``--ckpt-dir``, the one store its ranks share. Rank 0 alone writes each
checkpoint, its blocks gathered to rank 0 alone; every rank restores
through ``restore_resharded`` onto the mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
        --smoke --device cpu --steps 4
    RANK=<r> WORLD_SIZE=4 PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-32b --smoke --device cpu --steps 4 --mesh 2x2 \\
        --ckpt-dir ckpt --init-method file:///tmp/rdzv  # each r in 0..3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import (canonical, get_config,
                                          get_smoke_config)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (P, ShardCtx, make_ctx,
                                              param_pspecs)
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.driver import DriverReport, TrainDriver
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def mesh_axes(dims) -> tuple:
    """The axis names of a ``--mesh`` of ``dims``, as the reference names
    them."""
    return ("data", "model")[:len(dims)] if len(dims) <= 2 else \
        ("pod", "data", "model")


def _init_ranks(dev: torch.device, init_method: Optional[str]) -> None:
    """Join the default process group from the environment (``RANK``,
    ``WORLD_SIZE``; ``env://`` reads ``MASTER_ADDR``/``MASTER_PORT``)."""
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            rank=int(os.environ.get("RANK", "0")),
                            world_size=int(os.environ.get("WORLD_SIZE", "1")))


def _block_slices(shape, mesh, places, coord) -> tuple:
    """The slices of the block that the rank at mesh coordinate ``coord``
    holds of a ``DTensor`` of ``shape``: cut along each ``Shard`` dim in
    mesh-dim order, as ``torch.chunk`` cuts it."""
    bounds = [(0, n) for n in shape]
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            lo, hi = bounds[pl.dim]
            size = -(-(hi - lo) // mesh.size(i))
            start = min(lo + coord[i] * size, hi)
            bounds[pl.dim] = (start, min(start + size, hi))
    return tuple(slice(a, b) for a, b in bounds)


def _on_writer(t: torch.Tensor) -> Optional[torch.Tensor]:
    """A host copy of ``t`` whole on rank 0, ``None`` on the others (a
    collective: every rank takes it). A ``DTensor``'s blocks go to rank 0
    alone, each padded to the largest, in one ``gather``: no other rank
    ever holds the whole tensor."""
    rank = dist.get_rank()
    if not isinstance(t, DTensor):
        return t.detach().to("cpu", copy=True) if rank == 0 else None
    mesh, places = t.device_mesh, t.placements
    ranks = mesh.mesh.reshape(-1).tolist()
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError("the checkpoint's mesh must span every rank")
    largest = _block_slices(t.shape, mesh, places, [0] * mesh.ndim)
    size = 1
    for sl in largest:
        size *= sl.stop - sl.start
    local = t.to_local().detach().reshape(-1)
    buf = local.new_zeros((size,))
    buf[:local.numel()] = local
    blocks = ([torch.empty_like(buf) for _ in ranks] if rank == 0
              else None)
    dist.gather(buf, blocks, dst=0)
    if rank != 0:
        return None
    whole = torch.empty(t.shape, dtype=t.dtype)
    for r, blk in enumerate(blocks):
        coord = (mesh.mesh == r).nonzero()[0].tolist()
        dst = whole[_block_slices(t.shape, mesh, places, coord)]
        dst.copy_(blk[:dst.numel()].view(dst.shape))
    return whole


def _empty(t: torch.Tensor) -> torch.Tensor:
    """A host tensor of ``t``'s whole shape and type, to restore into."""
    return torch.empty(t.shape, dtype=t.dtype)


def _tree(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _sharded_io(store: CheckpointStore, cfg, ctx: ShardCtx):
    """(snapshot, restore) of a sharded train state (model, optimizer
    state): the snapshot gathers every leaf whole to rank 0's host, the
    writer (a collective: every rank takes it; the others get ``None``),
    the restore reads the checkpoint and lays it onto the mesh through
    ``restore_resharded``, then copies it into the live state's blocks."""
    def snapshot(state):
        params, opt = state
        snap = ({n: _on_writer(p) for n, p in params.named_parameters()},
                _tree(_on_writer, opt))
        return snap if dist.get_rank() == 0 else None

    def restore(state, step):
        params, opt = state
        template = ({n: _empty(p) for n, p in params.named_parameters()},
                    _tree(_empty, opt))
        specs = param_pspecs(cfg, params, ctx)
        opt_specs = {k: P() if k == "step" else specs for k in opt}
        back = store.restore_resharded(template, ctx.mesh, (specs, opt_specs),
                                       step)
        with torch.no_grad():
            _copy(dict(params.named_parameters()), back[0])
            _copy(opt, back[1])
        return state
    return snapshot, restore


def _copy(live: Any, back: Any) -> None:
    if isinstance(live, dict):
        for k in live:
            _copy(live[k], back[k])
        return
    src = back.to_local() if isinstance(back, DTensor) else back
    dst = live.to_local() if isinstance(live, DTensor) else live
    dst.copy_(src.to(dst.device))


def main(arch: str = "qwen3-32b", smoke: bool = False, steps: int = 20,
         batch: int = 8, seq: int = 128, microbatches: int = 1,
         ckpt_dir: Optional[str] = None, device: DeviceLike = "cuda",
         fail_at: Optional[int] = None, mesh: Optional[str] = None,
         compress_dcn: bool = False,
         init_method: Optional[str] = None) -> DriverReport:
    """Train ``steps`` steps and return the driver's report (losses,
    checkpoints, restarts). ``ckpt_dir`` defaults to a new temporary
    directory on one device; a mesh needs it. ``mesh`` (``"2x2"``,
    ``"2x1x2"``) trains over that many ranks, joining the default process
    group first (see the module's doc); ``compress_dcn`` takes the pod
    branch on a mesh with a pod axis."""
    dev = resolve_device(device)
    arch = canonical(arch)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = ShapeConfig("train", "train", seq, batch,
                        num_microbatches=microbatches, remat=True)
    opt = OptConfig(total_steps=max(steps, 10),
                    warmup_steps=max(2, steps // 10), peak_lr=1e-3)
    ctx = None
    if mesh:
        if not ckpt_dir:
            raise ValueError("a mesh needs ckpt_dir (--ckpt-dir): its ranks "
                             "write and restore one shared store")
        _init_ranks(dev, init_method)
        dims = tuple(int(x) for x in mesh.split("x"))
        ctx = make_ctx(make_mesh(dims, mesh_axes(dims), dev.type))
    store = CheckpointStore(ckpt_dir
                            or tempfile.mkdtemp(prefix="repro_train_"))
    rng = np.random.default_rng(0)

    def next_batch():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq),
                                             dtype=np.int32)).to(dev)
        return {"tokens": toks, "labels": toks}

    def build_step(mesh_spec):
        params, opt_state = init_train_state(
            torch.Generator(device=dev).manual_seed(0), cfg, opt,
            compress_dcn=compress_dcn, ctx=ctx)
        raw = make_train_step(cfg, shape, opt, ctx=ctx,
                              compress_dcn=compress_dcn)

        def step_fn(state):
            p, o = state
            p, o, m = raw(p, o, next_batch())
            return (p, o), m
        return step_fn, (params, opt_state)

    hooks = {}
    if ctx is not None:
        snapshot, restore = _sharded_io(store, cfg, ctx)
        hooks = dict(snapshot=snapshot, restore=restore,
                     writer=dist.get_rank() == 0, sync=dist.barrier)
    driver = TrainDriver(store, build_step, checkpoint_every=10,
                         failure_schedule=None if fail_at is None
                         else {fail_at: "fail"}, **hooks)
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
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 -> (data, model), 2x1x2 -> (pod, data, "
                         "model); default: one device")
    ap.add_argument("--compress-dcn", action="store_true",
                    help="int8 error-feedback hop over the pod axis")
    ap.add_argument("--init-method", default=None,
                    help="the process group's rendezvous (default env://)")
    ap.add_argument("--report", default=None,
                    help="write the driver's report (losses, checkpoints, "
                         "restarts) to this JSON file (rank 0)")
    a = ap.parse_args()
    try:
        report = main(arch=a.arch, smoke=a.smoke, steps=a.steps,
                      batch=a.batch, seq=a.seq, microbatches=a.microbatches,
                      ckpt_dir=a.ckpt_dir, device=a.device, fail_at=a.fail_at,
                      mesh=a.mesh, compress_dcn=a.compress_dcn,
                      init_method=a.init_method)
        if a.report and (not dist.is_initialized() or dist.get_rank() == 0):
            with open(a.report, "w") as f:
                json.dump(dataclasses.asdict(report), f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"completed {report.steps_completed} steps; "
          f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}; "
          f"checkpoints {report.checkpoints}; restarts {report.restarts}")
