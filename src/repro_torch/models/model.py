"""Top-level model: embeddings + stack + head; forward and decode entry
points; analytic parameter counts.

Counterpart of ``repro.models.model`` for token inputs (``{"tokens": (B,S)
int}``). The vision and audio frontends, and the training loss
(``loss_fn``, ``chunked_cross_entropy``), are not ported yet (ROADMAP §1
items 4 and 5).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (Embedding, Params, RMSNorm, dense_init,
                                       dt, embed, rmsnorm)

FRONTEND_TODO = ("the {kind} frontend is not ported yet: the port takes "
                 "token inputs only (ROADMAP §1 item 4, frontends)")


class Model(Params):
    """``embed`` (the padded vocab table), ``stack``, ``final_norm`` and,
    unless the embeddings are tied, ``head`` (D, V padded). Made on
    ``device`` in ``dtype`` (the config's parameter type unless given),
    drawn from ``gen``, or uninitialised when ``gen`` is None."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.frontend.kind != "none":
            raise NotImplementedError(FRONTEND_TODO.format(
                kind=cfg.frontend.kind))
        dtype = dtype or dt(cfg.param_dtype)
        v_pad = padded_vocab(cfg.vocab)
        self.embed = Embedding(gen, v_pad, cfg.d_model, dtype, device)
        self.stack = tf.Stack(cfg, gen, device, dtype)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.head = dense_init(gen, cfg.d_model, v_pad, dtype, device)


def init_model(gen: torch.Generator, cfg: ModelConfig) -> Model:
    """Random weights on ``gen``'s device, drawn from ``gen``."""
    return Model(cfg, gen, gen.device)


def apply_frontend(params, cfg: ModelConfig,
                   inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The (B,S,D) input sequence: token embeddings."""
    if cfg.frontend.kind != "none":
        raise NotImplementedError(FRONTEND_TODO.format(
            kind=cfg.frontend.kind))
    return embed(params["embed"], inputs["tokens"])


def forward(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
            inference: bool = False) -> torch.Tensor:
    """Hidden states after the final norm: (B,S,D). ``inference`` relaxes
    the MoE capacity, as prefill and decode do; the MoE aux loss is not
    returned (the port serves only)."""
    x = apply_frontend(params, cfg, inputs).to(dt(cfg.compute_dtype))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x = tf.stack_forward(params["stack"], cfg, x, positions, inference)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def head_table(params, cfg: ModelConfig) -> torch.Tensor:
    """(V padded, D) unembedding table."""
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    return params["head"].T


def logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of hidden states (..., D) over the padded vocab, the pad
    entries masked to -1e30."""
    table = head_table(params, cfg)
    out = x.float() @ table.float().T
    if table.shape[0] > cfg.vocab:
        pad = torch.arange(table.shape[0], device=x.device) >= cfg.vocab
        out = out.masked_fill(pad, -1e30)
    return out


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int,
                      device) -> Dict[str, Any]:
    return tf.init_caches(cfg, batch, capacity, device)


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                caches) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens (B,1) -> (logits (B,V) fp32, new caches)."""
    x = embed(params["embed"], tokens).to(dt(cfg.compute_dtype))
    x, caches = tf.stack_decode(params["stack"], caches, cfg, x)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits(params, cfg, x)[:, 0], caches


# ---------------------------------------------------------------------------
# analytic parameter counts (for MODEL_FLOPS roofline term)
# ---------------------------------------------------------------------------

def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    d, V = cfg.d_model, cfg.vocab
    hd = cfg.resolved_head_dim
    total = V * d * (1 if cfg.tie_embeddings else 2)        # embed + head

    def attn_params():
        if cfg.attention == "mla":
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * cfg.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * cfg.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + cfg.n_heads * m.v_head_dim * d)
        return d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)

    def mlp_params(ff):
        return 3 * d * ff

    def mamba_params():
        s = cfg.ssm
        d_in = s.expand * d
        H = d_in // s.head_dim
        conv_ch = d_in + 2 * s.n_groups * s.d_state
        return (d * (2 * d_in + 2 * s.n_groups * s.d_state + H)
                + s.d_conv * conv_ch + d_in * d)

    def rwkv_params():
        c = cfg.rwkv
        return (5 * d * d                 # r,k,v,g,o projections
                + d * c.mix_lora * 5 * 2  # mixing adapters (approx)
                + d * c.decay_lora * 2
                + 2 * d * cfg.d_ff + d * d)  # channel mix

    if cfg.block_pattern == "zamba_hybrid":
        n_sites = cfg.n_layers // cfg.attn_every
        total += cfg.n_layers * mamba_params()
        total += attn_params() + mlp_params(cfg.d_ff)       # shared block
        total += n_sites * 2 * (d * tf.ZAMBA_LORA_RANK
                                + tf.ZAMBA_LORA_RANK * cfg.n_heads * hd)
        return total
    if cfg.block_kind == "mamba2":
        return total + cfg.n_layers * mamba_params()
    if cfg.block_kind == "rwkv6":
        return total + cfg.n_layers * rwkv_params()
    # attention archs
    per_layer = attn_params()
    if cfg.moe is not None:
        m = cfg.moe
        n_moe = cfg.n_layers - m.first_k_dense
        total += m.first_k_dense * (per_layer + mlp_params(m.dense_d_ff))
        router = d * m.num_experts
        if active_only:
            expert = 3 * d * m.expert_d_ff * m.top_k
        else:
            expert = 3 * d * m.expert_d_ff * m.num_experts
        shared = 3 * d * m.shared_d_ff if m.num_shared_experts else 0
        total += n_moe * (per_layer + router + expert + shared)
        return total
    return total + cfg.n_layers * (per_layer + mlp_params(cfg.d_ff))
