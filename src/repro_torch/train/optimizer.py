"""AdamW with float32 master weights and moments, a warmup-cosine schedule
and global-norm clipping.

Counterpart of ``repro.train.optimizer``, written as the reference writes
its update (not ``torch.optim.AdamW``). The state is ``{"step": int32
tensor, "master": {name: fp32}, "m": {name: fp32}, "v": {name: fp32}}``
keyed by the model's parameter names; it lives on the parameters' device.
The update runs in place: the master weights and moments are rewritten and
the parameters take the new master weights in their own type.

A parameter that the loss does not reach has a grad of ``None`` in PyTorch
where JAX has zeros (hubert's token ``embed`` table, an expert no token
reaches): every function here takes ``None`` as zeros, so its moments still
decay and weight decay still applies to its master weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

Grads = Mapping[str, Optional[torch.Tensor]]


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_schedule(opt: OptConfig, step: Union[int, torch.Tensor]
                ) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * peak_lr``; a
    float32 scalar on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, opt.warmup_steps)
    decay_steps = max(1.0, opt.total_steps - opt.warmup_steps)
    frac = torch.clamp((step - opt.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = opt.min_lr_ratio + (1 - opt.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return opt.peak_lr * torch.where(step < opt.warmup_steps, warm, cos)


def init_opt_state(params: nn.Module) -> Dict[str, object]:
    """Step 0, float32 master copies of the parameters, zero moments."""
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in named.items()},
        "m": {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in named.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in named.items()},
    }


def global_norm(grads: Grads) -> torch.Tensor:
    """sqrt of the sum of squares of every grad, in float32 (``None`` is
    zeros)."""
    sums = [torch.sum(torch.square(g.float())) for g in grads.values()
            if g is not None]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Grads, max_norm: float
                        ) -> Tuple[Dict[str, Optional[torch.Tensor]],
                                   torch.Tensor]:
    """(grads in float32 scaled by min(1, max_norm / (norm + 1e-9)), the
    norm). Float32 grads are scaled in place; ``None`` stays ``None``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {n: None if g is None else g.float().mul_(scale)
            for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params: nn.Module, grads: Grads, state: Dict[str, object],
                 opt: OptConfig
                 ) -> Tuple[nn.Module, Dict[str, object],
                            Dict[str, torch.Tensor]]:
    """One AdamW step, in place, with float32 grads (already clipped):
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, master -= lr (m_hat /
    (sqrt(v_hat) + eps) + weight_decay master), and each parameter set to
    its master weights in its own type. Returns (params, state,
    {"lr": lr})."""
    step = state["step"] + 1
    lr = lr_schedule(opt, step)
    b1t = 1 - torch.pow(opt.b1, step.float())
    b2t = 1 - torch.pow(opt.b2, step.float())
    for name, p in params.named_parameters():
        m, v, master = (state[k][name] for k in ("m", "v", "master"))
        g = grads.get(name)
        m.mul_(opt.b1)
        v.mul_(opt.b2)
        if g is not None:
            g = g.float()
            m.add_((1 - opt.b1) * g)
            v.add_((1 - opt.b2) * torch.square(g))
        upd = (m / b1t) / (torch.sqrt(v / b2t) + opt.eps) \
            + opt.weight_decay * master
        master.sub_(lr * upd)
        p.copy_(master)
    state["step"] = step
    return params, state, {"lr": lr}
