"""The training step: gradients over microbatches, global-norm clipping and
AdamW, on one device or over a ``DeviceMesh``.

Counterpart of ``repro.train.train_step``. The loss runs on the models'
plain mixers (``model.loss_fn``), as the reference trains on its XLA
paths: the kernels have no backward. Gradients accumulate in float32 as
``g / n_mb`` over the microbatches, as the reference's scan does.

Over a mesh (``ctx``, see `repro_torch.distributed.sharding`) the model's
parameters are ``DTensor``s (:func:`init_train_state` lays them out) and
the step takes the whole batch on every rank: each microbatch (consecutive
rows, as the reference reshapes the batch) is cut to this rank's block of
rows over the data-parallel axes, as the reference shards it. Every rank
back-propagates its loss (the whole batch's, the same on every rank)
divided by the ranks the grads are summed over; the collectives inside the
model reduce-scatter the fsdp-gathered weights' grads, and a grad
replicated over one of those axes is summed over it after backward. So the
grads, the clip's norm and the AdamW update are the whole model's, each
rank holding its blocks.

With ``compress_dcn`` and a "pod" axis, this is the reference's pod
branch: per-pod grads (the batch cut over the pods first, the grads summed
over data and model only), the int8 hop over the pods with error feedback
(:func:`int8_pod_hop`; a block's scale is its whole leaf's), the clip
after the hop, AdamW, and ``dcn_error`` carried in the optimizer state;
the loss is the mean of the pods' losses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (ShardCtx, _ref_path,
                                              shard_model)
from repro_torch.models import model as M
from repro_torch.train.compression import dequantize_int8
from repro_torch.train.optimizer import (OptConfig, _local, adamw_update,
                                         clip_by_global_norm, init_opt_state)

Batch = Dict[str, torch.Tensor]


def _split_microbatches(batch: Batch, n_mb: int):
    """``n_mb`` batches of consecutive rows, as the reference reshapes the
    leading axis to (n_mb, B / n_mb)."""
    parts = {k: v.chunk(n_mb, dim=0) for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n_mb)]


def _take_grads(params: nn.Module):
    """(name, grad or None) of every parameter, each ``.grad`` cleared."""
    for name, p in params.named_parameters():
        g, p.grad = p.grad, None
        yield name, g


def grads_and_loss(params: nn.Module, cfg: ModelConfig, batch: Batch,
                   shape: ShapeConfig, ctx: Optional[ShardCtx] = None
                   ) -> Tuple[Dict[str, Optional[torch.Tensor]],
                              torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean float32 grads over the (possibly microbatched) batch, keyed by
    parameter name, the loss, and the metrics: ``loss_fn``'s {"ce", "aux"}
    for one microbatch, {"ce": loss, "aux": 0} for several, as in the
    reference. A parameter the loss does not reach has a grad of ``None``
    with one microbatch and zeros with several (the optimizer takes
    ``None`` as zeros). Over a mesh the grads are ``DTensor``s with their
    parameters' placements."""
    n_mb = shape.num_microbatches
    if ctx is not None:
        return _sharded_grads_and_loss(params, cfg, batch, shape, ctx)
    if n_mb <= 1:
        loss, metrics = M.loss_fn(params, cfg, batch, remat=shape.remat)
        loss.backward()
        grads = {n: None if g is None else g.float()
                 for n, g in _take_grads(params)}
        return grads, loss.detach(), {k: v.detach()
                                      for k, v in metrics.items()}
    grads = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.named_parameters()}
    loss_acc = torch.zeros((), device=next(iter(grads.values())).device)
    for mb in _split_microbatches(batch, n_mb):
        loss, _ = M.loss_fn(params, cfg, mb, remat=shape.remat)
        loss.backward()
        for n, g in _take_grads(params):
            if g is not None:
                grads[n].add_(g.float() / n_mb)
        loss_acc = loss_acc + loss.detach() / n_mb
    return grads, loss_acc, {"ce": loss_acc,
                             "aux": torch.zeros_like(loss_acc)}


def _grad_axes(ctx: ShardCtx) -> Tuple[str, ...]:
    """The axes the grads are summed over: data-parallel, then tp."""
    return ctx.dp_axes + ((ctx.tp_axis,) if ctx.tp_axis else ())


def _placed(p: torch.Tensor, ctx: ShardCtx) -> List:
    """``p``'s placements on the mesh (a plain parameter is replicated)."""
    if isinstance(p, DTensor):
        return list(p.placements)
    return [Replicate()] * len(ctx.axis_names)


def _sharded_grads_and_loss(params: nn.Module, cfg: ModelConfig,
                            batch: Batch, shape: ShapeConfig,
                            ctx: ShardCtx):
    axes = _grad_axes(ctx)
    world = ctx.size(axes)
    n_mb = max(1, shape.num_microbatches)
    named = dict(params.named_parameters())
    acc: Dict[str, Optional[torch.Tensor]] = {
        n: None if n_mb == 1 else
        torch.zeros_like(_local(p), dtype=torch.float32)
        for n, p in named.items()}
    loss_acc = None
    for mb in _split_microbatches(batch, n_mb):
        mb = {k: ctx.constrain(v, ctx.dp_axes) for k, v in mb.items()}
        loss, metrics = M.loss_fn(params, cfg, mb, remat=shape.remat,
                                  ctx=ctx)
        (loss / world if world > 1 else loss).backward()
        for n, g in _take_grads(params):
            if g is None:
                continue
            g = _local(g).float()
            if n_mb == 1:
                acc[n] = g
            else:
                acc[n].add_(g / n_mb)
        loss = loss.detach()
        loss_acc = loss if n_mb == 1 else (
            loss / n_mb if loss_acc is None else loss_acc + loss / n_mb)
    _sum_replicated(acc, named, ctx, axes)
    grads = {n: None if g is None else _as_placed(g, named[n], ctx)
             for n, g in acc.items()}
    if n_mb == 1:
        return grads, loss_acc, {k: v.detach() for k, v in metrics.items()}
    return grads, loss_acc, {"ce": loss_acc,
                             "aux": torch.zeros_like(loss_acc)}


@torch.no_grad()
def _sum_replicated(grads: Dict[str, Optional[torch.Tensor]],
                    named: Dict[str, torch.Tensor], ctx: ShardCtx,
                    axes: Tuple[str, ...]) -> None:
    """Sum in place, over each axis of ``axes`` on which its parameter is
    replicated, every local grad: what each rank computed there is its part
    of the sum. Grads with the same axes go in one flat buffer a
    collective."""
    buckets: Dict[Tuple[str, ...], List[str]] = {}
    for n, g in grads.items():
        if g is None:
            continue
        places = _placed(named[n], ctx)
        over = tuple(a for a in axes if ctx.shape[a] > 1 and isinstance(
            places[ctx.axis_names.index(a)], Replicate))
        if over:
            buckets.setdefault(over, []).append(n)
    for over, names in buckets.items():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        for a in over:
            dist.all_reduce(flat, group=ctx.group(a))
        off = 0
        for n in names:
            k = grads[n].numel()
            grads[n].copy_(flat[off:off + k].view_as(grads[n]))
            off += k


def _as_placed(local: torch.Tensor, p: torch.Tensor,
               ctx: ShardCtx) -> DTensor:
    """A local grad block as a ``DTensor`` with ``p``'s placements."""
    return DTensor.from_local(local, ctx.mesh, _placed(p, ctx),
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, opt: OptConfig,
                    ctx: Optional[ShardCtx] = None,
                    compress_dcn: bool = False
                    ) -> Callable[..., Tuple[nn.Module, Any,
                                             Dict[str, torch.Tensor]]]:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: grads, clipping to ``opt.grad_clip``, AdamW; metrics
    ``loss``, ``grad_norm`` and ``lr``. The parameters and the optimizer
    state are updated in place. With ``ctx`` the step runs over its mesh
    (every rank passes the whole batch); with ``compress_dcn`` and a "pod"
    axis it is the pod branch, whose optimizer state carries
    ``dcn_error`` (:func:`init_train_state` with ``compress_dcn``)."""
    if not compress_dcn or ctx is None or "pod" not in ctx.axis_names:
        def train_step(params, opt_state, batch):
            grads, loss, _ = grads_and_loss(params, cfg, batch, shape, ctx)
            grads, gnorm = clip_by_global_norm(grads, opt.grad_clip)
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 opt)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                       **om}
        return train_step

    inner = dataclasses.replace(ctx, dp_axes=("data",))
    n_pod = ctx.size("pod")

    def train_step(params, opt_state, batch):
        # per-pod grads (summed over data and model inside)
        pod_batch = {k: ctx.constrain(v, "pod") for k, v in batch.items()}
        grads, loss, _ = grads_and_loss(params, cfg, pod_batch, shape, inner)
        named = dict(params.named_parameters())
        local = {n: torch.zeros_like(_local(named[n]), dtype=torch.float32)
                 if g is None else _local(g) for n, g in grads.items()}
        errs = {n: _local(e) for n, e in opt_state["dcn_error"].items()}
        red, new_err = int8_pod_hop(local, errs, named, ctx)
        grads = {n: _as_placed(g, named[n], ctx) for n, g in red.items()}
        grads, gnorm = clip_by_global_norm(grads, opt.grad_clip)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt)
        # the optimizer state keeps the error-feedback residuals
        opt_state["dcn_error"] = {
            n: _as_placed(e, named[n], ctx) for n, e in new_err.items()}
        return params, opt_state, {"loss": _pod_mean(loss, ctx, n_pod),
                                   "grad_norm": gnorm, **om}
    return train_step


@torch.no_grad()
def int8_pod_hop(grads: Dict[str, torch.Tensor],
                 errors: Dict[str, torch.Tensor],
                 named: Dict[str, torch.Tensor], ctx: ShardCtx
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The pod branch's compressed hop over the "pod" axis, as the
    reference's ``pod_body`` computes it, on this rank's blocks of the
    per-pod grads and of the carried errors (keyed by parameter name).
    Each of the reference's leaves (the port's per-layer parameters of one
    stacked leaf together) has ``g + e`` quantized once to int8 with the
    scale max|g + e| / 127 + 1e-12 over the whole leaf (its layers and the
    blocks the pod's data and model axes hold). The int8 payloads and the
    scales are all-gathered over the pods, and the sum of scale times
    payload is taken in pod order and divided by the pods. Returns (the
    reduced grads, the new errors ``g + e - q * scale``)."""
    names = list(grads)
    tgts = [grads[n].to(torch.float32) + errors[n] for n in names]
    leaf_of = [_ref_path(n)[0] for n in names]
    leaves = list(dict.fromkeys(leaf_of))
    of = [leaves.index(k) for k in leaf_of]
    dev = tgts[0].device
    amax = torch.zeros(len(leaves), device=dev).scatter_reduce(
        0, torch.tensor(of, device=dev),
        torch.stack([t.abs().amax() for t in tgts]), "amax")
    # a leaf sharded within the pod: its scale is the whole leaf's
    within: Dict[Tuple[str, ...], List[int]] = {}
    for n, j in zip(names, of):
        places = _placed(named[n], ctx)
        axes = tuple(a for a in ("data", "model") if ctx.shape[a] > 1
                     and isinstance(places[ctx.axis_names.index(a)], Shard))
        if axes:
            within.setdefault(axes, []).append(j)
    for axes, idx in within.items():
        idx = sorted(set(idx))
        sub = amax[idx]
        for a in axes:
            dist.all_reduce(sub, op=dist.ReduceOp.MAX, group=ctx.group(a))
        amax[idx] = sub
    scale = amax / 127.0 + 1e-12
    # int8 on the wire: every leaf's payload in one buffer, the scales in
    # another; each target becomes its new error in place
    flat = torch.empty(sum(t.numel() for t in tgts), dtype=torch.int8,
                       device=dev)
    off = 0
    for i, t in enumerate(tgts):
        q = flat[off:off + t.numel()].view(t.shape)
        q.copy_(torch.clamp(torch.round(t / scale[of[i]]), -127, 127))
        t.sub_(dequantize_int8(q, scale[of[i]]))
        off += t.numel()
    n_pod = ctx.size("pod")
    pod = ctx.group("pod")
    all_q = flat.new_empty((n_pod * flat.numel(),))
    dist.all_gather_into_tensor(all_q, flat, group=pod)
    all_q = all_q.view(n_pod, -1)
    all_s = scale.new_empty((n_pod * len(leaves),))
    dist.all_gather_into_tensor(all_s, scale, group=pod)
    all_s = all_s.view(n_pod, -1)
    red, off = {}, 0
    for i, (n, t) in enumerate(zip(names, tgts)):
        k = t.numel()
        blocks, ss = all_q[:, off:off + k], all_s[:, of[i]]
        acc = ss[0] * blocks[0].to(torch.float32)
        for j in range(1, n_pod):
            acc = acc + ss[j] * blocks[j].to(torch.float32)
        red[n] = (acc / n_pod).view(t.shape)
        off += k
    return red, dict(zip(names, tgts))


@torch.no_grad()
def _pod_mean(loss: torch.Tensor, ctx: ShardCtx, n_pod: int) -> torch.Tensor:
    """The mean of the pods' losses, summed in pod order."""
    losses = loss.new_empty((n_pod,))
    dist.all_gather_into_tensor(losses, loss.reshape(1),
                                group=ctx.group("pod"))
    total = losses[0]
    for i in range(1, n_pod):
        total = total + losses[i]
    return total / n_pod


def init_train_state(gen: torch.Generator, cfg: ModelConfig, opt: OptConfig,
                     compress_dcn: bool = False,
                     ctx: Optional[ShardCtx] = None
                     ) -> Tuple[M.Model, Dict[str, Any]]:
    """A model on ``gen``'s device drawn from ``gen``, its parameters
    requiring grad, and its optimizer state. With ``ctx`` the parameters
    are laid onto its mesh (``shard_model``: every rank draws the same
    weights and keeps its blocks) and the state follows their placements.
    ``compress_dcn`` adds the pod branch's error-feedback state
    ``dcn_error``: float32 zeros like every parameter."""
    params = M.init_model(gen, cfg).requires_grad_(True)
    if ctx is not None:
        shard_model(params, cfg, ctx)
    opt_state = init_opt_state(params)
    if compress_dcn:
        opt_state["dcn_error"] = {
            n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.named_parameters()}
    return params, opt_state
