"""Blocks and layer stacks: full-sequence forward, prefill and decode.

Counterpart of ``repro.models.transformer``. The reference stacks each
group's parameters along a leading layer axis and scans over it; here a
stack is an ``nn.ModuleList`` of per-layer blocks and a Python loop, and
caches are lists of per-layer caches. Two patterns:

  * ``uniform``      -- one homogeneous list of ``attn_mlp`` blocks (dense
                        FFN, or MoE FFN when the config has ``moe``, after
                        a ``prefix`` of ``first_k_dense`` dense blocks),
                        ``mamba2`` blocks or ``rwkv6`` blocks (time-mix and
                        channel-mix, each after its norm). With
                        ``layer_mixers`` each ``attn_mlp`` block's mixer is
                        the attention or KDA (Kimi-Linear), layer by layer,
                        and so is its cache: a ``KVCache`` or a
                        ``KDAState``.
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

Over a mesh (``ctx``) every block first gathers its weights over the fsdp
axis (``fsdp_gather``, the reference's explicit ZeRO-3 prefetch; under
remat the gather runs again in backward), and the residual between blocks
is this rank's batch rows, replicated over tp, or with
``sequence_parallel`` also cut to its block of positions: the reference
pins it ``(dp, None, None)`` or ``(dp, tp, None)``. The mixers and FFNs
take and give that layout (`repro_torch.models.layers.tp_region`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.distributed.sharding import (fsdp_gather, local,
                                              placed_like, tp_part,
                                              tp_whole)
from repro_torch.models import attention as attn_mod
from repro_torch.models import kda as kda_mod
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
    """One block: Mamba2 mixer, RWKV6 time-mix + channel-mix, or a mixer
    (``attn``, or ``kda`` where ``mixer`` says so) + an FFN: ``moe`` when
    ``use_moe``, else the dense SwiGLU ``mlp`` (of ``moe.dense_d_ff`` in
    the dense prefix of a MoE config)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None,
                 use_moe: bool = False, mixer: str = "attn"):
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
        if mixer == "kda":
            self.kda = kda_mod.KDA(cfg, gen, device, dtype)
        else:
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


def _dense_d_ff(cfg: ModelConfig) -> int:
    """The hidden width of a block's dense FFN."""
    return (cfg.moe.dense_d_ff if cfg.moe and cfg.moe.first_k_dense
            else cfg.d_ff)


def _ffn(params, cfg: ModelConfig, h: torch.Tensor, inference: bool,
         ctx=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on its normed input and its aux loss: MoE (a float32
    scalar), or the dense MLP (None)."""
    if "moe" in params:
        return moe_mod.moe_ffn(params["moe"], cfg, h, ctx=ctx,
                               inference=inference)
    return mlp(params["mlp"], h, ctx, _dense_d_ff(cfg)), None


def _rwkv_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                  use_kernels: bool = True, ctx=None,
                  whole_state: bool = True
                  ) -> Tuple[torch.Tensor, rw.RWKVState]:
    """An RWKV6 block over a whole sequence from a zero state, and its decode
    state (the WKV state and the last normed input of each sublayer)."""
    B, L, D = x.shape
    zeros = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    tm, s_final, x_tm = rw.rwkv6_time_mix(params["mixer"], cfg, h, zeros,
                                          use_kernels=use_kernels, ctx=ctx,
                                          whole_state=whole_state)
    x = x + tm
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    cm, x_cm = rw.rwkv6_channel_mix(params["mixer"], h, zeros, ctx, cfg)
    length = torch.full((B,), L, dtype=torch.int32, device=x.device)
    return x + cm, rw.RWKVState(s_final, x_tm, x_cm, length)


def block_forward(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, inference: bool = False,
                  use_kernels: bool = True, ctx=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward for one block: (x, aux loss). ``inference``
    relaxes a MoE FFN's capacity; ``use_kernels=False`` takes the plain
    mixers (training); ``ctx`` runs it over the mesh."""
    zero = torch.zeros((), device=x.device)      # no aux loss
    params = fsdp_gather(params, cfg, ctx)       # explicit ZeRO-3 prefetch
    if cfg.block_kind == "mamba2":
        return x + m2.mamba2_block(params["mixer"], cfg,
                                   rmsnorm(params["norm"], x, cfg.norm_eps),
                                   use_kernels, ctx), zero
    if cfg.block_kind == "rwkv6":
        return _rwkv_prefill(params, cfg, x, use_kernels, ctx,
                             whole_state=False)[0], zero
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if "kda" in params:
        x = x + kda_mod.kda_prefill(params["kda"], cfg, h, ctx)[0]
    else:
        x = x + attn_mod.attention(params["attn"], cfg, h, positions,
                                   use_kernels, ctx)
    out, aux = _ffn(params, cfg, rmsnorm(params["norm2"], x, cfg.norm_eps),
                    inference, ctx)
    return x + out, zero if aux is None else aux


def block_decode(params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Any, ctx=None, marks=None
                 ) -> Tuple[torch.Tensor, Any]:
    """One-token decode for one block. cache: KVCache | KDAState |
    SSMState | RWKVState. Over a mesh (``ctx``) the block's weights are
    gathered over the fsdp axis first and the cache is this rank's
    ``DTensor`` blocks (`repro_torch.distributed.sharding.shard_caches`).
    ``marks`` (a recording's ``telemetry.DeviceMarks``) closes a span
    after the mixer and one after the FFN of an attention or KDA block."""
    params = fsdp_gather(params, cfg, ctx)
    if cfg.block_kind == "mamba2":
        h = rmsnorm(params["norm"], x, cfg.norm_eps)
        out, cache = m2.mamba2_decode(params["mixer"], cfg, h, cache, ctx)
        return x + out, cache
    if cfg.block_kind == "rwkv6":
        h = rmsnorm(params["norm1"], x, cfg.norm_eps)
        tm, cache = rw.rwkv6_decode(params["mixer"], cfg, h, cache, ctx)
        x = x + tm
        h = rmsnorm(params["norm2"], x, cfg.norm_eps)
        cm, x_cm = rw.rwkv6_channel_mix(params["mixer"], h, local(cache.x_cm),
                                        ctx, cfg)
        return x + cm, cache._replace(x_cm=placed_like(x_cm, cache.x_cm))
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if "kda" in params:
        out, cache = kda_mod.kda_decode(params["kda"], cfg, h, cache, ctx)
    else:
        out, cache = attn_mod.decode_attention(params["attn"], cfg, h, cache,
                                               ctx)
    if marks is not None:
        marks.mark("kda" if "kda" in params else cfg.attention)
    x = x + out
    x = x + _ffn(params, cfg, rmsnorm(params["norm2"], x, cfg.norm_eps),
                 True, ctx)[0]
    if marks is not None:
        marks.mark("moe" if "moe" in params else "mlp")
    return x, cache


def block_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, capacity: int, ctx=None
                  ) -> Tuple[torch.Tensor, Any]:
    """Forward one block and return its decode cache (over a mesh, the
    cache of this rank's rows, whole over tp but for the kv heads that
    the decode's layout splits over it)."""
    params = fsdp_gather(params, cfg, ctx)       # explicit ZeRO-3 prefetch
    if cfg.block_kind == "mamba2":
        h = rmsnorm(params["norm"], x, cfg.norm_eps)
        out, state = m2.mamba2_prefill(params["mixer"], cfg, h, ctx=ctx)
        return x + out, state
    if cfg.block_kind == "rwkv6":
        return _rwkv_prefill(params, cfg, x, ctx=ctx)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if "kda" in params:
        out, kv = kda_mod.kda_prefill(params["kda"], cfg, h, ctx)
    else:
        out, kv = attn_mod.attention_prefill(params["attn"], cfg, h,
                                             positions, capacity, ctx)
    x = x + out
    return x + _ffn(params, cfg, rmsnorm(params["norm2"], x, cfg.norm_eps),
                    True, ctx)[0], kv


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


def _lora_adjusted_attn_params(shared, lora, cfg: Optional[ModelConfig] = None,
                               ctx=None) -> Dict[str, torch.Tensor]:
    """Per-site attention weights: wq + a_q@b_q and wk + a_k@b_k. Over a
    mesh each b takes the tp layout of the weight it adjusts (wk is whole
    where the kv heads do not divide tp, b_k is cut on its columns)."""
    p = (dict(shared.named_parameters(recurse=False))
         if isinstance(shared, nn.Module) else
         {k: v for k, v in shared.items() if isinstance(v, torch.Tensor)})
    b_q, b_k = lora["b_q"], lora["b_k"]
    if ctx is not None:
        hd = cfg.resolved_head_dim
        b_q, b_k = (_like(ctx, b, p[w], n * hd) for b, w, n in (
            (b_q, "wq", cfg.n_heads), (b_k, "wk", cfg.n_kv_heads)))
    p["wq"] = shared["wq"] + lora["a_q"] @ b_q
    p["wk"] = shared["wk"] + lora["a_k"] @ b_k
    return p


def _like(ctx, b: torch.Tensor, w: torch.Tensor, full: int) -> torch.Tensor:
    """``b`` (r, full) on the tp layout of ``w``'s columns."""
    if b.shape[1] == w.shape[1]:
        return b
    if w.shape[1] == full:
        return tp_whole(ctx, b, 1, full)
    return tp_part(ctx, b, 1, full)


def _shared_mlp(shared, cfg: ModelConfig, x: torch.Tensor,
                ctx=None) -> torch.Tensor:
    return x + mlp(shared["mlp"], rmsnorm(shared["norm2"], x, cfg.norm_eps),
                   ctx, cfg.d_ff)


def shared_attn_forward(shared, lora, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor,
                        use_kernels: bool = True, ctx=None) -> torch.Tensor:
    shared, lora = fsdp_gather((shared, lora), cfg, ctx)
    ap = _lora_adjusted_attn_params(shared["attn"], lora, cfg, ctx)
    h = rmsnorm(shared["norm1"], x, cfg.norm_eps)
    return _shared_mlp(shared, cfg, x + attn_mod.attention(
        ap, cfg, h, positions, use_kernels, ctx), ctx)


def shared_attn_decode(shared, lora, cfg: ModelConfig, x: torch.Tensor,
                       cache: KVCache, ctx=None
                       ) -> Tuple[torch.Tensor, KVCache]:
    shared, lora = fsdp_gather((shared, lora), cfg, ctx)
    ap = _lora_adjusted_attn_params(shared["attn"], lora, cfg, ctx)
    h = rmsnorm(shared["norm1"], x, cfg.norm_eps)
    out, cache = attn_mod.decode_attention(ap, cfg, h, cache, ctx)
    return _shared_mlp(shared, cfg, x + out, ctx), cache


def shared_attn_prefill(shared, lora, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, capacity: int, ctx=None
                        ) -> Tuple[torch.Tensor, KVCache]:
    shared, lora = fsdp_gather((shared, lora), cfg, ctx)
    ap = _lora_adjusted_attn_params(shared["attn"], lora, cfg, ctx)
    h = rmsnorm(shared["norm1"], x, cfg.norm_eps)
    out, kv = attn_mod.attention_prefill(ap, cfg, h, positions, capacity,
                                         ctx)
    return _shared_mlp(shared, cfg, x + out, ctx), kv


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

        def blocks(n, use_moe=False, first=0):
            return nn.ModuleList(Block(cfg, gen, device, dtype, use_moe,
                                       _mixer(cfg, first + i))
                                 for i in range(n))
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
        self.layers = blocks(cfg.n_layers - n_dense, cfg.moe is not None,
                             n_dense)


def _mixer(cfg: ModelConfig, layer: int) -> str:
    """The mixer of an ``attn_mlp`` layer: ``attn``, or ``kda`` where the
    config's ``layer_mixers`` says so."""
    return cfg.layer_mixers[layer] if cfg.layer_mixers else "attn"


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
                  remat: bool = False, use_kernels: bool = True, ctx=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward through all layers: (x, summed aux loss).
    ``inference`` relaxes the MoE capacity; ``remat`` checkpoints each block
    (and each shared-attention site); ``use_kernels=False`` takes the plain
    mixers (training); ``ctx`` runs every block over the mesh."""
    aux = torch.zeros((), device=x.device)

    def block(b, x):
        nonlocal aux
        x, a = _maybe_remat(remat, block_forward, b, cfg, x, positions,
                            inference, use_kernels, ctx)
        aux = aux + a
        return x
    if cfg.block_pattern == "zamba_hybrid":
        for group, lora in zip(_site_groups(params, cfg), params["loras"]):
            for b in group:
                x = block(b, x)
            x = _maybe_remat(remat, shared_attn_forward, params["shared_attn"],
                             lora, cfg, x, positions, use_kernels, ctx)
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
    ``layers`` and, ahead of a MoE stack's dense blocks, ``prefix`` (a
    KDAState for each KDA layer of ``layer_mixers``)."""
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

    def kv(first, n):
        return [kda_mod.init_kda_state(cfg, batch, device)
                if _mixer(cfg, i) == "kda" else
                attn_mod.init_kv_cache(cfg, batch, capacity, device)
                for i in range(first, first + n)]
    caches = {"layers": kv(n_dense, cfg.n_layers - n_dense)}
    if n_dense:
        caches["prefix"] = kv(0, n_dense)
    return caches


def stack_decode(params, caches, cfg: ModelConfig, x: torch.Tensor,
                 ctx=None) -> Tuple[torch.Tensor, Dict[str, List[Any]]]:
    """One-token decode through all layers. Returns (x, new caches); ``ctx``
    runs every block over the mesh on caches from ``shard_caches``. Into
    the tracer that `repro_torch.core.telemetry.recording` made current, a
    uniform stack records two spans a block, ``serve.decode.<mixer>``
    (``kda``, ``mla`` or ``gqa``) and ``serve.decode.<ffn>`` (``moe`` or
    ``mlp``), each with ``device_s`` on a card."""
    if cfg.block_pattern == "zamba_hybrid":
        ge = cfg.attn_every
        new = {"groups": [], "shared_kv": []}
        for s, (group, lora) in enumerate(zip(_site_groups(params, cfg),
                                              params["loras"])):
            for j, block in enumerate(group):
                x, c = block_decode(block, cfg, x,
                                    caches["groups"][s * ge + j], ctx)
                new["groups"].append(c)
            x, kv = shared_attn_decode(params["shared_attn"], lora, cfg, x,
                                       caches["shared_kv"][s], ctx)
            new["shared_kv"].append(kv)
        if "tail" in params:
            new["tail"] = []
            for block, c in zip(params["tail"], caches["tail"]):
                x, c = block_decode(block, cfg, x, c, ctx)
                new["tail"].append(c)
        return x, new
    tr = telemetry.current()
    marks = (telemetry.DeviceMarks(tr, "serve.decode.", x.device)
             if tr.enabled else None)
    new = {}
    for kind, blocks in _uniform(params):
        new[kind] = []
        for block, c in zip(blocks, caches[kind]):
            x, c = block_decode(block, cfg, x, c, ctx, marks)
            new[kind].append(c)
    return x, new


def stack_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, capacity: int, ctx=None,
                  place: Optional[Callable[[str, int, Any], Any]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, List[Any]]]:
    """Forward all layers, returning per-layer decode caches (the structure
    of :func:`init_caches`); ``ctx`` runs every block over the mesh, and
    ``place(kind, i, cache)`` lays each layer's cache out as it comes
    (the sharded prefill's, so no layer's is held whole to the end)."""
    caches: Dict[str, List[Any]] = {}

    def keep(kind: str, c: Any) -> None:
        layers = caches.setdefault(kind, [])
        layers.append(c if place is None else place(kind, len(layers), c))
    if cfg.block_pattern == "zamba_hybrid":
        caches = {"groups": [], "shared_kv": []}
        for group, lora in zip(_site_groups(params, cfg), params["loras"]):
            for block in group:
                x, c = block_prefill(block, cfg, x, positions, capacity, ctx)
                keep("groups", c)
            x, kv = shared_attn_prefill(params["shared_attn"], lora, cfg, x,
                                        positions, capacity, ctx)
            keep("shared_kv", kv)
        if "tail" in params:
            caches["tail"] = []
            for block in params["tail"]:
                x, c = block_prefill(block, cfg, x, positions, capacity, ctx)
                keep("tail", c)
        return x, caches
    for kind, blocks in _uniform(params):
        caches[kind] = []
        for block in blocks:
            x, c = block_prefill(block, cfg, x, positions, capacity, ctx)
            keep(kind, c)
    return x, caches
