"""Blocks and layer stacks: full-sequence forward, prefill and decode.

Counterpart of ``repro.models.transformer``. The reference stacks each
group's parameters along a leading layer axis and scans over it; here a
stack is an ``nn.ModuleList`` of per-layer blocks and a Python loop, and
caches are lists of per-layer caches. Two patterns:

  * ``uniform``      -- one homogeneous list of ``attn_mlp`` blocks (dense
                        FFN, or MoE FFN when the config has ``moe``, after
                        a ``prefix`` of ``first_k_dense`` dense blocks),
                        ``mamba2`` blocks or ``rwkv6`` blocks (time-mix and
                        channel-mix, each after its norm).
  * ``zamba_hybrid`` -- groups of ``attn_every`` Mamba2 blocks, each group
                        followed by the SHARED attention block (weights
                        shared across sites, per-site LoRA deltas on q and
                        k); the remainder layers form a tail.

The full-sequence forward (``stack_forward``) returns the summed MoE aux
loss beside the hidden states. Its ``use_kernels`` chooses the mixers: the
kernels (prefill and serving) or the plain counterparts of the reference's
XLA paths (training, ``use_kernels=False``: the kernels have no backward).
With ``remat`` every block runs under ``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint`` over its layer scan.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rw
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (MLP, Params, RMSNorm, const,
                                       dense_init, dt, mlp, rmsnorm)

ZAMBA_LORA_RANK = 64


# ---------------------------------------------------------------------------
# single blocks
# ---------------------------------------------------------------------------

class Block(Params):
    """One block: Mamba2 mixer, RWKV6 time-mix + channel-mix, or attention
    + an FFN: ``moe`` when ``use_moe``, else the dense SwiGLU ``mlp`` (of
    ``moe.dense_d_ff`` in the dense prefix of a MoE config)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None,
                 use_moe: bool = False):
        super().__init__()
        dtype = dtype or dt(cfg.param_dtype)
        if cfg.block_kind == "mamba2":
            self.norm = RMSNorm(cfg.d_model, dtype, device)
            self.mixer = m2.Mamba2(cfg, gen, device, dtype)
            return
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        if cfg.block_kind == "rwkv6":
            self.mixer = rw.RWKV6(cfg, gen, device, dtype)
            return
        self.attn = attn_mod.Attention(cfg, gen, device, dtype)
        if use_moe:
            self.moe = moe_mod.MoE(cfg, gen, device, dtype)
            return
        d_ff = (cfg.moe.dense_d_ff if cfg.moe and cfg.moe.first_k_dense
                else cfg.d_ff)
        self.mlp = MLP(gen, cfg.d_model, d_ff, dtype, device)


def init_block(gen: torch.Generator, cfg: ModelConfig,
               use_moe: bool = False) -> Block:
    return Block(cfg, gen, gen.device, use_moe=use_moe)


def _ffn(params, cfg: ModelConfig, h: torch.Tensor, inference: bool
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on its normed input and its aux loss: MoE (a float32
    scalar), or the dense MLP (None)."""
    if "moe" in params:
        return moe_mod.moe_ffn(params["moe"], cfg, h, inference=inference)
    return mlp(params["mlp"], h), None


def _rwkv_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                  use_kernels: bool = True
                  ) -> Tuple[torch.Tensor, rw.RWKVState]:
    """An RWKV6 block over a whole sequence from a zero state, and its decode
    state (the WKV state and the last normed input of each sublayer)."""
    B, L, D = x.shape
    zeros = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    tm, s_final, x_tm = rw.rwkv6_time_mix(params["mixer"], cfg, h, zeros,
                                          use_kernels=use_kernels)
    x = x + tm
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    cm, x_cm = rw.rwkv6_channel_mix(params["mixer"], h, zeros)
    length = torch.full((B,), L, dtype=torch.int32, device=x.device)
    return x + cm, rw.RWKVState(s_final, x_tm, x_cm, length)


def block_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, inference: bool = False,
                  use_kernels: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward for one block: (x, aux loss). ``inference``
    relaxes a MoE FFN's capacity; ``use_kernels=False`` takes the plain
    mixers (training)."""
    zero = torch.zeros((), device=x.device)      # no aux loss
    if cfg.block_kind == "mamba2":
        return x + m2.mamba2_block(params["mixer"], cfg,
                                   rmsnorm(params["norm"], x, cfg.norm_eps),
                                   use_kernels), zero
    if cfg.block_kind == "rwkv6":
        return _rwkv_prefill(params, cfg, x, use_kernels)[0], zero
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    x = x + attn_mod.attention(params["attn"], cfg, h, positions,
                               use_kernels)
    out, aux = _ffn(params, cfg, rmsnorm(params["norm2"], x, cfg.norm_eps),
                    inference)
    return x + out, zero if aux is None else aux


def block_decode(params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Any) -> Tuple[torch.Tensor, Any]:
    """One-token decode for one block. cache: KVCache | SSMState |
    RWKVState."""
    if cfg.block_kind == "mamba2":
        h = rmsnorm(params["norm"], x, cfg.norm_eps)
        out, cache = m2.mamba2_decode(params["mixer"], cfg, h, cache)
        return x + out, cache
    if cfg.block_kind == "rwkv6":
        h = rmsnorm(params["norm1"], x, cfg.norm_eps)
        tm, cache = rw.rwkv6_decode(params["mixer"], cfg, h, cache)
        x = x + tm
        h = rmsnorm(params["norm2"], x, cfg.norm_eps)
        cm, x_cm = rw.rwkv6_channel_mix(params["mixer"], h, cache.x_cm)
        return x + cm, cache._replace(x_cm=x_cm)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    out, cache = attn_mod.decode_attention(params["attn"], cfg, h, cache)
    x = x + out
    return x + _ffn(params, cfg, rmsnorm(params["norm2"], x, cfg.norm_eps),
                    True)[0], cache


def block_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, Any]:
    """Forward one block and return its decode cache."""
    if cfg.block_kind == "mamba2":
        h = rmsnorm(params["norm"], x, cfg.norm_eps)
        out, state = m2.mamba2_prefill(params["mixer"], cfg, h)
        return x + out, state
    if cfg.block_kind == "rwkv6":
        return _rwkv_prefill(params, cfg, x)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    out, kv = attn_mod.attention_prefill(params["attn"], cfg, h, positions,
                                         capacity)
    x = x + out
    return x + _ffn(params, cfg, rmsnorm(params["norm2"], x, cfg.norm_eps),
                    True)[0], kv


# ---------------------------------------------------------------------------
# zamba shared attention block (+ per-site LoRA)
# ---------------------------------------------------------------------------

class SharedAttn(Params):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or dt(cfg.param_dtype)
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        self.attn = attn_mod.Attention(cfg, gen, device, dtype)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, dtype, device)


class SiteLoRA(Params):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or dt(cfg.param_dtype)
        d, hd, r = cfg.d_model, cfg.resolved_head_dim, ZAMBA_LORA_RANK
        self.a_q = dense_init(gen, d, r, dtype, device)
        self.b_q = const((r, cfg.n_heads * hd), 0.0, dtype, device)
        self.a_k = dense_init(gen, d, r, dtype, device)
        self.b_k = const((r, cfg.n_kv_heads * hd), 0.0, dtype, device)


def init_shared_attn(gen: torch.Generator, cfg: ModelConfig) -> SharedAttn:
    return SharedAttn(cfg, gen, gen.device)


def init_site_lora(gen: torch.Generator, cfg: ModelConfig) -> SiteLoRA:
    return SiteLoRA(cfg, gen, gen.device)


def _lora_adjusted_attn_params(shared, lora) -> Dict[str, torch.Tensor]:
    """Per-site attention weights: wq + a_q@b_q and wk + a_k@b_k."""
    p = dict(shared.named_parameters(recurse=False))
    p["wq"] = shared["wq"] + lora["a_q"] @ lora["b_q"]
    p["wk"] = shared["wk"] + lora["a_k"] @ lora["b_k"]
    return p


def _shared_mlp(shared, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mlp(shared["mlp"], rmsnorm(shared["norm2"], x, cfg.norm_eps))


def shared_attn_forward(shared, lora, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor,
                        use_kernels: bool = True) -> torch.Tensor:
    ap = _lora_adjusted_attn_params(shared["attn"], lora)
    h = rmsnorm(shared["norm1"], x, cfg.norm_eps)
    return _shared_mlp(shared, cfg, x + attn_mod.attention(
        ap, cfg, h, positions, use_kernels))


def shared_attn_decode(shared, lora, cfg: ModelConfig, x: torch.Tensor,
                       cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    ap = _lora_adjusted_attn_params(shared["attn"], lora)
    h = rmsnorm(shared["norm1"], x, cfg.norm_eps)
    out, cache = attn_mod.decode_attention(ap, cfg, h, cache)
    return _shared_mlp(shared, cfg, x + out), cache


def shared_attn_prefill(shared, lora, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, capacity: int
                        ) -> Tuple[torch.Tensor, KVCache]:
    ap = _lora_adjusted_attn_params(shared["attn"], lora)
    h = rmsnorm(shared["norm1"], x, cfg.norm_eps)
    out, kv = attn_mod.attention_prefill(ap, cfg, h, positions, capacity)
    return _shared_mlp(shared, cfg, x + out), kv


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------

def _sites(cfg: ModelConfig) -> Tuple[int, int]:
    """(shared-attention sites, tail layers) of a zamba_hybrid stack."""
    n_sites = cfg.n_layers // cfg.attn_every
    return n_sites, cfg.n_layers - n_sites * cfg.attn_every


class Stack(Params):
    """All blocks of the configured pattern. zamba_hybrid: ``groups``
    (n_sites * attn_every Mamba2 blocks, in order), ``shared_attn``,
    ``loras`` (one per site) and ``tail``; uniform: ``layers`` (MoE blocks
    when the config has ``moe``), after a ``prefix`` of the MoE config's
    ``first_k_dense`` dense blocks."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()

        def blocks(n, use_moe=False):
            return nn.ModuleList(Block(cfg, gen, device, dtype, use_moe)
                                 for _ in range(n))
        if cfg.block_pattern == "zamba_hybrid":
            n_sites, n_tail = _sites(cfg)
            self.groups = blocks(n_sites * cfg.attn_every)
            self.shared_attn = SharedAttn(cfg, gen, device, dtype)
            self.loras = nn.ModuleList(SiteLoRA(cfg, gen, device, dtype)
                                       for _ in range(n_sites))
            if n_tail:
                self.tail = blocks(n_tail)
            return
        n_dense = _n_dense(cfg)
        if n_dense:
            self.prefix = blocks(n_dense)
        self.layers = blocks(cfg.n_layers - n_dense, cfg.moe is not None)


def _n_dense(cfg: ModelConfig) -> int:
    """Dense blocks ahead of a uniform MoE stack (0 without MoE)."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def _uniform(params) -> List[Tuple[str, List[Block]]]:
    """A uniform stack's block lists in order: ``prefix`` (where present),
    then ``layers``."""
    groups = [("prefix", list(params["prefix"]))] if "prefix" in params \
        else []
    return groups + [("layers", list(params["layers"]))]


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> Stack:
    return Stack(cfg, gen, gen.device)


def _site_groups(params, cfg: ModelConfig) -> List[List[Block]]:
    ge = cfg.attn_every
    return [list(params["groups"][i * ge:(i + 1) * ge])
            for i in range(len(params["loras"]))]


def _tail(params) -> List[Block]:
    return list(params["tail"]) if "tail" in params else []


def _maybe_remat(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``: its
    activations are recomputed in backward instead of saved."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def stack_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, inference: bool = False,
                  remat: bool = False, use_kernels: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward through all layers: (x, summed aux loss).
    ``inference`` relaxes the MoE capacity; ``remat`` checkpoints each block
    (and each shared-attention site); ``use_kernels=False`` takes the plain
    mixers (training)."""
    aux = torch.zeros((), device=x.device)

    def block(b, x):
        nonlocal aux
        x, a = _maybe_remat(remat, block_forward, b, cfg, x, positions,
                            inference, use_kernels)
        aux = aux + a
        return x
    if cfg.block_pattern == "zamba_hybrid":
        for group, lora in zip(_site_groups(params, cfg), params["loras"]):
            for b in group:
                x = block(b, x)
            x = _maybe_remat(remat, shared_attn_forward, params["shared_attn"],
                             lora, cfg, x, positions, use_kernels)
        for b in _tail(params):
            x = block(b, x)
        return x, aux
    for _, blocks in _uniform(params):
        for b in blocks:
            x = block(b, x)
    return x, aux


# ---------------------------------------------------------------------------
# decode and prefill (per-layer caches)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, capacity: int,
                device) -> Dict[str, List[Any]]:
    """Per-layer decode caches matching the stack: zamba_hybrid ``groups``
    (SSMState each), ``shared_kv`` (KVCache per site) and ``tail``; uniform
    ``layers`` and, ahead of a MoE stack's dense blocks, ``prefix``."""
    if cfg.block_pattern == "zamba_hybrid":
        n_sites, n_tail = _sites(cfg)

        def ssm(n):
            return [m2.init_ssm_state(cfg, batch, device) for _ in range(n)]
        caches = {"groups": ssm(n_sites * cfg.attn_every),
                  "shared_kv": [attn_mod.init_kv_cache(cfg, batch, capacity,
                                                       device)
                                for _ in range(n_sites)]}
        if n_tail:
            caches["tail"] = ssm(n_tail)
        return caches
    if cfg.block_kind == "mamba2":
        return {"layers": [m2.init_ssm_state(cfg, batch, device)
                           for _ in range(cfg.n_layers)]}
    if cfg.block_kind == "rwkv6":
        return {"layers": [rw.init_rwkv_state(cfg, batch, device)
                           for _ in range(cfg.n_layers)]}
    n_dense = _n_dense(cfg)

    def kv(n):
        return [attn_mod.init_kv_cache(cfg, batch, capacity, device)
                for _ in range(n)]
    caches = {"layers": kv(cfg.n_layers - n_dense)}
    if n_dense:
        caches["prefix"] = kv(n_dense)
    return caches


def stack_decode(params, caches, cfg: ModelConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, List[Any]]]:
    """One-token decode through all layers. Returns (x, new caches)."""
    if cfg.block_pattern == "zamba_hybrid":
        ge = cfg.attn_every
        new = {"groups": [], "shared_kv": []}
        for s, (group, lora) in enumerate(zip(_site_groups(params, cfg),
                                              params["loras"])):
            for j, block in enumerate(group):
                x, c = block_decode(block, cfg, x, caches["groups"][s * ge + j])
                new["groups"].append(c)
            x, kv = shared_attn_decode(params["shared_attn"], lora, cfg, x,
                                       caches["shared_kv"][s])
            new["shared_kv"].append(kv)
        if "tail" in params:
            new["tail"] = []
            for block, c in zip(params["tail"], caches["tail"]):
                x, c = block_decode(block, cfg, x, c)
                new["tail"].append(c)
        return x, new
    new = {}
    for kind, blocks in _uniform(params):
        new[kind] = []
        for block, c in zip(blocks, caches[kind]):
            x, c = block_decode(block, cfg, x, c)
            new[kind].append(c)
    return x, new


def stack_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, Dict[str, List[Any]]]:
    """Forward all layers, returning per-layer decode caches (the structure
    of :func:`init_caches`)."""
    if cfg.block_pattern == "zamba_hybrid":
        caches = {"groups": [], "shared_kv": []}
        for group, lora in zip(_site_groups(params, cfg), params["loras"]):
            for block in group:
                x, c = block_prefill(block, cfg, x, positions, capacity)
                caches["groups"].append(c)
            x, kv = shared_attn_prefill(params["shared_attn"], lora, cfg, x,
                                        positions, capacity)
            caches["shared_kv"].append(kv)
        if "tail" in params:
            caches["tail"] = []
            for block in params["tail"]:
                x, c = block_prefill(block, cfg, x, positions, capacity)
                caches["tail"].append(c)
        return x, caches
    caches = {}
    for kind, blocks in _uniform(params):
        caches[kind] = []
        for block in blocks:
            x, c = block_prefill(block, cfg, x, positions, capacity)
            caches[kind].append(c)
    return x, caches
