"""The training step: gradients over microbatches, global-norm clipping and
AdamW.

Counterpart of the single-device path of ``repro.train.train_step``. The
loss runs on the models' plain mixers (``model.loss_fn``), as the
reference trains on its XLA paths: the kernels have no backward. Gradients
accumulate in float32 as ``g / n_mb`` over the microbatches, as the
reference's scan does. The pod-mesh branch (an int8-compressed DCN
all-reduce with error feedback) and any mesh context are not ported yet and
raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, init_opt_state)

POD_TODO = ("training over a mesh (the pod branch with compressed DCN "
            "gradients, sharded state) is not ported yet: ROADMAP §1 item 8 "
            "(distributed)")

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
                   shape: ShapeConfig, ctx=None
                   ) -> Tuple[Dict[str, Optional[torch.Tensor]],
                              torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean float32 grads over the (possibly microbatched) batch, keyed by
    parameter name, the loss, and the metrics: ``loss_fn``'s {"ce", "aux"}
    for one microbatch, {"ce": loss, "aux": 0} for several, as in the
    reference. A parameter the loss does not reach has a grad of ``None``
    with one microbatch and zeros with several (the optimizer takes
    ``None`` as zeros)."""
    if ctx is not None:
        raise NotImplementedError(POD_TODO)
    n_mb = shape.num_microbatches
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


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, opt: OptConfig,
                    ctx=None, compress_dcn: bool = False
                    ) -> Callable[..., Tuple[nn.Module, Any,
                                             Dict[str, torch.Tensor]]]:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: grads, clipping to ``opt.grad_clip``, AdamW; metrics
    ``loss``, ``grad_norm`` and ``lr``. The parameters and the optimizer
    state are updated in place. A mesh context or ``compress_dcn`` raises
    (ROADMAP §1 item 8)."""
    if ctx is not None or compress_dcn:
        raise NotImplementedError(POD_TODO)

    def train_step(params, opt_state, batch):
        grads, loss, _ = grads_and_loss(params, cfg, batch, shape)
        grads, gnorm = clip_by_global_norm(grads, opt.grad_clip)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **om}
    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig, opt: OptConfig,
                     compress_dcn: bool = False
                     ) -> Tuple[M.Model, Dict[str, Any]]:
    """A model on ``gen``'s device drawn from ``gen``, its parameters
    requiring grad, and its optimizer state. ``compress_dcn`` (the pod
    branch's error-feedback state) raises (ROADMAP §1 item 8)."""
    if compress_dcn:
        raise NotImplementedError(POD_TODO)
    params = M.init_model(gen, cfg).requires_grad_(True)
    return params, init_opt_state(params)
