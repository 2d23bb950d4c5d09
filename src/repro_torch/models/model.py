"""Top-level model: embeddings, modality frontends, stack and head; the
forward, training-loss and decode entry points; analytic parameter counts.

Counterpart of ``repro.models.model``. Inputs are dicts:

  LM:      {"tokens": (B,S) int, "labels": (B,S) int}
  [vlm]:   + {"image_embeds": (B,P,feat)}: precomputed patch embeddings,
           through the ``vision_patches`` connector and prepended to the text
  [audio]: {"features": (B,S,feat), "labels": (B,S)}: precomputed frames,
           through the ``audio_frames`` projection

``forward`` runs the mixers on the kernels (prefill and serving) unless
``use_kernels=False``; ``loss_fn`` passes that, as the reference trains on
its XLA paths: the kernels have no backward.

Over a mesh (``ctx``) the inputs are this rank's batch rows; the token
table is looked up in its tp block of vocab rows, the frontend and the
head table are gathered whole (the CE runs on every tp rank; a
vocab-parallel CE is later work), and the CE's sum and count are summed
over the data-parallel axes, so the loss is that of the whole batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.distributed.sharding import (  # noqa: F401 (shard_caches)
    fsdp_gather, shard_caches, tp_whole)
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (Embedding, Params, RMSNorm, dense_init,
                                       dt, embed, rmsnorm)


class Frontend(Params):
    """The modality frontend's parameters, with the reference's names:
    ``vision_patches`` has ``norm`` (over the features), ``fc1`` and
    ``fc2``; ``audio_frames`` has ``proj`` and ``norm`` (over d_model)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: torch.dtype):
        super().__init__()
        fe, d = cfg.frontend, cfg.d_model
        if fe.kind == "vision_patches":
            self.norm = RMSNorm(fe.feature_dim, dtype, device)
            self.fc1 = dense_init(gen, fe.feature_dim, d, dtype, device)
            self.fc2 = dense_init(gen, d, d, dtype, device)
        elif fe.kind == "audio_frames":
            self.proj = dense_init(gen, fe.feature_dim, d, dtype, device)
            self.norm = RMSNorm(d, dtype, device)
        else:
            raise ValueError(f"unknown frontend kind {fe.kind!r}")


class Model(Params):
    """``embed`` (the padded vocab table), ``stack``, ``final_norm``, unless
    the embeddings are tied ``head`` (D, V padded), and for a vision or
    audio config ``frontend``. Made on ``device`` in ``dtype`` (the config's
    parameter type unless given), drawn from ``gen``, or uninitialised when
    ``gen`` is None."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or dt(cfg.param_dtype)
        v_pad = padded_vocab(cfg.vocab)
        self.embed = Embedding(gen, v_pad, cfg.d_model, dtype, device)
        self.stack = tf.Stack(cfg, gen, device, dtype)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.head = dense_init(gen, cfg.d_model, v_pad, dtype, device)
        if cfg.frontend.kind != "none":
            self.frontend = Frontend(cfg, gen, device, dtype)


def init_model(gen: torch.Generator, cfg: ModelConfig) -> Model:
    """Random weights on ``gen``'s device, drawn from ``gen``."""
    return Model(cfg, gen, gen.device)


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------

def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted type of the two, as JAX's einsum promotes a
    float32 input against bf16 weights."""
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t)


def apply_frontend(params, cfg: ModelConfig,
                   inputs: Dict[str, torch.Tensor], ctx=None) -> torch.Tensor:
    """The (B,S,D) input sequence from the modality inputs: token
    embeddings; for ``vision_patches`` the image embeddings through rmsnorm,
    fc1, tanh-gelu and fc2, cast to the embeddings' type and prepended; for
    ``audio_frames`` the features through proj and rmsnorm. Over a mesh the
    frontend's weights are gathered whole."""
    fe = cfg.frontend
    d = cfg.d_model
    f = None
    if fe.kind != "none":
        f = fsdp_gather(params["frontend"], cfg, ctx)
        if ctx is not None:
            f = {**f, **{n: tp_whole(ctx, f[n], 1, d)
                         for n in ("fc1", "fc2", "proj") if n in f}}
    if fe.kind == "vision_patches":
        h = rmsnorm(f["norm"], inputs["image_embeds"], cfg.norm_eps)
        h = _dense(F.gelu(_dense(h, f["fc1"]), approximate="tanh"), f["fc2"])
        txt = _embed(params, cfg, inputs["tokens"], ctx)
        return torch.cat([h.to(txt.dtype), txt], dim=1)
    if fe.kind == "audio_frames":
        return rmsnorm(f["norm"], _dense(inputs["features"], f["proj"]),
                       cfg.norm_eps)
    return _embed(params, cfg, inputs["tokens"], ctx)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           ctx) -> torch.Tensor:
    return embed(fsdp_gather(params["embed"], cfg, ctx), tokens, ctx,
                 padded_vocab(cfg.vocab))


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
            remat: bool = False, inference: bool = False,
            use_kernels: bool = True, ctx=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hidden states after the final norm (B,S,D), and the summed MoE aux
    loss. ``inference`` relaxes the MoE capacity, as prefill and decode do;
    ``remat`` checkpoints each block; ``use_kernels=False`` takes the plain
    mixers (training). Over a mesh (``ctx``) the inputs and the hidden
    states are this rank's rows (with ``sequence_parallel`` the residual
    holds this rank's block of positions between blocks; every position
    comes back)."""
    x = apply_frontend(params, cfg, inputs, ctx).to(dt(cfg.compute_dtype))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    sp = ctx is not None and ctx.sequence_parallel and ctx.tp_size > 1
    if sp:
        x = ctx.constrain(x, None, ctx.tp_axis)
    x, aux = tf.stack_forward(params["stack"], cfg, x, positions, inference,
                              remat, use_kernels, ctx)
    x = rmsnorm(fsdp_gather(params["final_norm"], cfg, ctx), x, cfg.norm_eps)
    if sp:
        x = ctx.gather(x, None, ctx.tp_axis)
    return x, aux


def head_table(params, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """(V padded, D) unembedding table (over a mesh gathered whole)."""
    v_pad = padded_vocab(cfg.vocab)
    if cfg.tie_embeddings:
        table = fsdp_gather(params["embed"], cfg, ctx)["table"]
        return table if ctx is None else tp_whole(ctx, table, 0, v_pad)
    head = fsdp_gather(params["head"], cfg, ctx)
    return (head if ctx is None else tp_whole(ctx, head, 1, v_pad)).T


def _vocab_logits(x: torch.Tensor, table: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """fp32 logits of hidden states (..., D) against a (V padded, D) table,
    the entries past ``vocab`` masked to -1e30."""
    out = x.float() @ table.float().T
    if table.shape[0] > vocab:
        pad = torch.arange(table.shape[0], device=x.device) >= vocab
        out = out.masked_fill(pad, -1e30)
    return out


def logits(params, cfg: ModelConfig, x: torch.Tensor,
           ctx=None) -> torch.Tensor:
    """fp32 logits of hidden states (..., D) over the padded vocab, the pad
    entries masked to -1e30."""
    return _vocab_logits(x, head_table(params, cfg, ctx), cfg.vocab)


def _ce_chunk(xb: torch.Tensor, table: torch.Tensor, lb: torch.Tensor,
              vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed CE, count) of one sequence chunk: fp32 logits (B,chunk,V),
    the padded vocab masked to -1e30, labels < 0 ignored."""
    logits_ = _vocab_logits(xb, table, vocab)
    logz = torch.logsumexp(logits_, dim=-1)
    gold = logits_.gather(-1, lb.clamp(min=0).long()[..., None])[..., 0]
    mask = (lb >= 0).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor, vocab: int,
                          chunk: int = 512) -> torch.Tensor:
    """Mean CE without keeping the (B,S,V) logits: x (B,S,D) hidden, table
    (V padded, D), labels (B,S) with -100 ignored. Sequence chunks of
    ``chunk`` (the last one short) each run under ``torch.utils.checkpoint``,
    so backward recomputes one chunk's fp32 logits at a time, as the
    reference's rematerialised scan does."""
    tot, cnt = _ce_sums(x, table, labels, vocab, chunk)
    return tot / torch.clamp(cnt, min=1.0)


def _ce_sums(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
             vocab: int, chunk: int = 512
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed CE, count of labelled positions) of :func:`chunked_cross_
    entropy`."""
    S = x.shape[1]
    chunk = min(chunk, S)
    table = table.float()
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for c0 in range(0, S, chunk):
        t, c = checkpoint(_ce_chunk, x[:, c0:c0 + chunk], table,
                          labels[:, c0:c0 + chunk], vocab,
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot, cnt


def loss_fn(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
            remat: bool = True, aux_weight: float = 0.01, ctx=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss on the plain mixers: next-token CE (the vision prefix's
    positions ignored), or a per-frame CE for an encoder (``causal=False``:
    no shift), plus ``aux_weight`` times the MoE aux loss. Returns (total,
    {"ce", "aux"}). Over a mesh (``ctx``) the inputs are this rank's rows
    and the loss is the whole batch's: the CE's sum and count summed over
    the data-parallel axes, the aux the reference's sharded one."""
    x, aux = forward(params, cfg, inputs, remat=remat, use_kernels=False,
                     ctx=ctx)
    labels = inputs["labels"]
    if cfg.causal:
        if cfg.frontend.kind == "vision_patches":
            P = cfg.frontend.num_prefix_tokens
            ignore = torch.full(labels.shape[:1] + (P,), -100,
                                dtype=labels.dtype, device=labels.device)
            labels = torch.cat([ignore, labels], dim=1)
        x, labels = x[:, :-1], labels[:, 1:]
    table = head_table(params, cfg, ctx)
    if ctx is None:
        ce = chunked_cross_entropy(x, table, labels, cfg.vocab)
    else:
        tot, cnt = _ce_sums(x, table, labels, cfg.vocab)
        ce = ctx.psum(tot, ctx.dp_axes) / torch.clamp(
            ctx.psum(cnt, ctx.dp_axes), min=1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int,
                      device) -> Dict[str, Any]:
    return tf.init_caches(cfg, batch, capacity, device)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                caches, ctx=None) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens (B,1) -> (logits (B,V) fp32, new caches).
    Runs under ``torch.no_grad()``: a trainable model builds no graph.

    Over a mesh (``ctx``) the caches are laid out by ``shard_caches``
    (``cache_pspecs``' placements, each rank its blocks) and stay so from
    one step to the next; ``tokens`` and the logits are this rank's
    rows of the batch (the caches' rows: over the data axes when the batch
    splits over them, else every row), the logits whole over the vocab.
    Each block gathers its weights over the fsdp axis and runs its mixer on
    its cache's layout (`repro_torch.models.attention.decode_attention`,
    ``mamba2_decode``, ``rwkv6_decode``, the expert-parallel MoE); the head
    computes this rank's vocab block, gathered over tp."""
    if ctx is None:
        x = embed(params["embed"], tokens).to(dt(cfg.compute_dtype))
        x, caches = tf.stack_decode(params["stack"], caches, cfg, x)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return logits(params, cfg, x)[:, 0], caches
    x = _embed(params, cfg, tokens, ctx).to(dt(cfg.compute_dtype))
    x, caches = tf.stack_decode(params["stack"], caches, cfg, x, ctx)
    x = rmsnorm(fsdp_gather(params["final_norm"], cfg, ctx), x, cfg.norm_eps)
    return _vocab_parallel_logits(params, cfg, x, ctx)[:, 0], caches


def _vocab_parallel_logits(params, cfg: ModelConfig, x: torch.Tensor,
                           ctx) -> torch.Tensor:
    """:func:`logits` over the mesh from the head's tp block of vocab rows
    (its rule's layout): this rank's block of logits, gathered over tp;
    a head whole over tp gives them all at once."""
    v_pad = padded_vocab(cfg.vocab)
    if cfg.tie_embeddings:
        table = fsdp_gather(params["embed"], cfg, ctx)["table"]
    else:
        table = fsdp_gather(params["head"], cfg, ctx).T
    if table.shape[0] == v_pad:
        return _vocab_logits(x, table, cfg.vocab)
    out = ctx.gather(x.float() @ table.float().T,
                     *((None,) * (x.dim() - 1)), ctx.tp_axis)
    pad = torch.arange(v_pad, device=x.device) >= cfg.vocab
    return out.masked_fill(pad, -1e30)


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
