"""Mixture-of-experts with capacity-bounded gather dispatch.

Counterpart of the single-device path of ``repro.models.moe``:

  * token-choice routing (top-k of an fp32 softmax; or, with
    ``scoring="sigmoid"``, of fp32 sigmoid scores plus a per-expert
    correction bias that only selects, the weights renormalised over the
    top-k and scaled by ``routed_scaling``) with a per-expert
    capacity C = ``expert_capacity``; tokens over capacity are dropped
    (their residual passes through), relaxed to ``INFERENCE_CAPACITY_FACTOR``
    at inference, or with ``dropless`` (a sigmoid router with a selection
    bias loads some experts past that factor) set at inference to the
    largest load of the call, read on the host, so no token is dropped;
  * each expert picks the tokens routed to it by sequence priority (the
    earliest first): a top-C over ``-position`` where assigned, ``-inf``
    elsewhere, gives a (B,E,C) index tensor and its ``valid`` mask;
  * the tokens are gathered into (B,E,C,D), the three expert products run
    as batched matmuls over the experts, and a scatter-add
    (``index_add_``) combines them back into (B,S,D).

An expert layer may hold a share of the experts (``held_experts`` from
``held_from``: an expert-parallel rank's share at world size 1). It routes
over all of them and computes only its own experts' part of the output,
which goes on as the layer's output; nothing stands in for the others.

The reference computes these with XLA ops, outside any Pallas kernel, so
the port uses PyTorch's ``topk``, indexing, ``bmm`` and ``index_add_``.

Over a mesh (``ctx``) the FFN is the reference's expert-parallel
``_moe_ffn_shardmap``: each rank runs its LOCAL experts (the tp block of
the stacked weights, gathered over the fsdp axis) over its LOCAL batch
rows, routing with the router over all E; one sum over tp combines the
experts (and the shared experts' hidden block). The aux loss is each data
shard's own Switch loss averaged over every mesh axis, as the reference's
``pmean``: a product of two means per shard, so it is not the aux of the
whole batch.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed.sharding import fsdp_gather, tp_part
from repro_torch.models.layers import (MLP, Params, _mlp_split,
                                       _trunc_normal, dense_init, dt, mlp,
                                       param, tp_region)

INFERENCE_CAPACITY_FACTOR = 4.0   # relaxed at inference (drop ~never)


def expert_capacity(num_tokens: int, moe: MoEConfig,
                    factor: Optional[float] = None) -> int:
    """Slots per expert and batch row: ``num_tokens * top_k * factor / E``,
    at least ``top_k`` and at most ``num_tokens``."""
    f = moe.capacity_factor if factor is None else factor
    cap = int(num_tokens * moe.top_k * f / moe.num_experts)
    return min(max(moe.top_k, cap), num_tokens)


def _stacked_init(gen: Optional[torch.Generator], n: int, in_dim: int,
                  out_dim: int, dtype: torch.dtype, device):
    """``n`` fan-in truncated-normal ``(in_dim, out_dim)`` matrices stacked
    as one ``(n, in_dim, out_dim)`` parameter, made in float32 and cast to
    ``dtype`` (one float32 copy of the stack at a time); uninitialised when
    ``gen`` is None."""
    if gen is None:
        return param(torch.empty((n, in_dim, out_dim), dtype=dtype,
                                 device=device))
    w = _trunc_normal(gen, (n, in_dim, out_dim), device)
    return param(w.mul_(1.0 / math.sqrt(in_dim)).to(dtype))


class MoE(Params):
    """``router`` (D, E) float32 whatever the parameter type, and with
    sigmoid scoring its selection bias ``router_bias`` (E,) float32; the
    held experts as stacked ``w_gate``/``w_up`` (E held, D, F) and
    ``w_down`` (E held, F, D); and ``shared`` (a SwiGLU MLP of
    ``shared_d_ff``) when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        moe = cfg.moe
        dtype = dtype or dt(cfg.param_dtype)
        d, E, f = cfg.d_model, moe.num_experts, moe.expert_d_ff
        El = held(moe)[1]
        self.router = dense_init(gen, d, E, torch.float32, device)
        if moe.scoring == "sigmoid":
            self.router_bias = param(torch.zeros((E,), device=device))
        self.w_gate = _stacked_init(gen, El, d, f, dtype, device)
        self.w_up = _stacked_init(gen, El, d, f, dtype, device)
        self.w_down = _stacked_init(gen, El, f, d, dtype, device)
        if moe.num_shared_experts:
            self.shared = MLP(gen, d, moe.shared_d_ff, dtype, device)


def held(moe: MoEConfig) -> Tuple[int, int]:
    """(first expert held, experts held): all of them unless the config
    holds a share."""
    return moe.held_from, moe.held_experts or moe.num_experts


def route(router_w: torch.Tensor, x: torch.Tensor, moe: MoEConfig,
          bias: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (combine weights (B,S,E) dense fp32, zero where a token is
    not routed; top-k expert ids (B,S,K); the Switch load-balance loss
    E * sum_e f_e p_e). With sigmoid scoring the top-k are those of the
    scores plus ``bias`` (the selection's correction), weighted by the
    scores alone, and the loss's p_e are the scores normalised."""
    logits = x.float() @ router_w.float()
    if moe.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        top_ids = torch.topk(scores + bias, moe.top_k, dim=-1)[1]
        top_w = scores.gather(-1, top_ids)
        probs = scores / scores.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
        top_w, top_ids = torch.topk(probs, moe.top_k, dim=-1)      # (B,S,K)
    if moe.norm_topk_prob:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)
    if moe.routed_scaling != 1.0:
        top_w = top_w * moe.routed_scaling
    onehot = F.one_hot(top_ids, moe.num_experts).float()          # (B,S,K,E)
    dense_w = torch.einsum("bsk,bske->bse", top_w, onehot)
    frac_tokens = onehot.sum(dim=2).mean(dim=(0, 1)) / moe.top_k
    frac_probs = probs.mean(dim=(0, 1))
    aux = moe.num_experts * torch.sum(frac_tokens * frac_probs)
    return dense_w, top_ids, aux


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor, ctx=None,
            inference: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x (B,S,D) -> (out (B,S,D) in x's type, aux loss scalar).

    Training uses the configured capacity factor; inference relaxes it to
    ``INFERENCE_CAPACITY_FACTOR``. With a mesh context (``ctx``) x is the
    residual's local block and the dispatch is expert-parallel
    (:func:`_moe_ffn_sharded`); the experts must divide tp, as they must
    for the reference's ``_moe_ffn_shardmap``."""
    if ctx is not None:
        return _moe_ffn_sharded(params, cfg, x, ctx, inference)
    moe = cfg.moe
    C = expert_capacity(x.shape[1], moe,
                        INFERENCE_CAPACITY_FACTOR if inference else None)
    dense_w, _, aux = _routed(params, x, moe)                      # (B,S,E)
    e0, El = held(moe)
    if El != moe.num_experts:                # this layer's share of them
        dense_w = dense_w[..., e0:e0 + El]
    if inference and moe.dropless and x.shape[1] > C:
        C = max(1, int((dense_w > 0).sum(1).amax()))
    out = _experts(x, dense_w, params["w_gate"], params["w_up"],
                   params["w_down"], C)
    if moe.num_shared_experts:
        out = out + mlp(params["shared"], x)
    return out, aux


def _routed(params, x: torch.Tensor, moe: MoEConfig):
    """:func:`route` with the layer's selection bias where it has one."""
    if "router_bias" in params:
        return route(params["router"], x, moe, params["router_bias"])
    return route(params["router"], x, moe)


def _experts(x: torch.Tensor, dense_w: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor, w_down: torch.Tensor,
             C: int) -> torch.Tensor:
    """The routed experts' output (B,S,D) for the experts of the stacked
    weights (all of them, or a tp rank's), ``dense_w`` (B,S,E) their
    combine weights, C slots per expert and batch row."""
    B, S, D = x.shape
    E = dense_w.shape[-1]
    # expert-side selection of routed tokens (sequence priority). The slots
    # past an expert's routed tokens hold -inf scores in an unspecified
    # order; they are masked by ``valid`` and their inputs zeroed, so their
    # outputs are exactly 0 whichever tokens they point at.
    neg_pos = -torch.arange(S, dtype=torch.float32, device=x.device)
    score = torch.where(dense_w.transpose(1, 2) > 0.0, neg_pos,
                        float("-inf"))                             # (B,E,S)
    top_score, token_idx = torch.topk(score, C, dim=-1)            # (B,E,C)
    valid = torch.isfinite(top_score)

    # dispatch: gather tokens into (B,E,C,D)
    b_idx = torch.arange(B, device=x.device)[:, None, None]
    e_idx = torch.arange(E, device=x.device)[None, :, None]
    xin = x[b_idx, token_idx]                                      # (B,E,C,D)
    w_in = dense_w[b_idx, token_idx, e_idx]                        # (B,E,C)
    xin = torch.where(valid[..., None], xin, 0.0)

    # expert compute: one batched matmul over the experts per product
    xe = xin.transpose(0, 1).reshape(E, B * C, D)
    gate = torch.bmm(xe, w_gate)
    up = torch.bmm(xe, w_up)
    y = torch.bmm(F.silu(gate) * up, w_down)                       # (E,BC,D)
    y = y.reshape(E, B, C, D).transpose(0, 1)                      # (B,E,C,D)
    y = y * torch.where(valid, w_in, 0.0).to(y.dtype)[..., None]

    # combine: scatter-add back to (B,S,D)
    rows = (b_idx * S + token_idx).reshape(-1)
    out = torch.zeros((B * S, D), dtype=y.dtype, device=x.device)
    out.index_add_(0, rows, y.reshape(-1, D))
    return out.reshape(B, S, D)


def _moe_ffn_sharded(params, cfg: ModelConfig, x: torch.Tensor, ctx,
                     inference: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ffn_shardmap`` on this rank: its local experts
    (the tp block, gathered over fsdp) over its local rows, the router over
    all E, the experts' outputs (plus the shared experts' hidden block)
    summed over tp, and the aux averaged over every mesh axis."""
    moe = cfg.moe
    E = moe.num_experts
    if held(moe)[1] != E:
        raise ValueError("an expert layer that holds a share of the experts "
                         "runs at world size 1 only")
    if E % ctx.tp_size:
        raise ValueError(f"{E} experts do not split over {ctx.tp_size} tp "
                         f"ranks: the expert-parallel dispatch needs them to")
    params = fsdp_gather(params, cfg, ctx)
    wg, wu, wd = (tp_part(ctx, params[n], 0, E)
                  for n in ("w_gate", "w_up", "w_down"))
    El = E // ctx.tp_size
    e0 = ctx.tp_rank * El
    shared = None
    if moe.num_shared_experts:
        shared, partial = _mlp_split(params["shared"], ctx, moe.shared_d_ff)
        if not partial and ctx.tp_size > 1:
            whole = shared
            # every tp rank holds the whole shared MLP: one rank adds it
            shared = (lambda h: whole(h) if ctx.tp_rank == 0
                      else torch.zeros_like(h))

    def region(h):
        C = expert_capacity(h.shape[1], moe, INFERENCE_CAPACITY_FACTOR
                            if inference else None)
        dense_w, _, aux = _routed(params, h, moe)
        out = _experts(h, dense_w[..., e0:e0 + El], wg, wu, wd, C)
        if shared is not None:
            out = out + shared(h)
        return out, aux
    out, aux = tp_region(ctx, (region, ctx.tp_size > 1), x)
    return out.to(x.dtype), ctx.pmean(aux, ctx.axis_names)
