"""GQA attention (qk-norm, qkv-bias, sliding window, bidirectional): full
sequence, prefill into a decode cache, and one-token decode.

Counterpart of ``repro.models.attention`` for GQA. Full-sequence attention
(``attention`` and ``attention_prefill``) goes through
`repro_torch.kernels.ops.flash_attention`: the hand-written kernel on CUDA
tensors, its plain version on the CPU. The reference's ``attention_prefill``
always ran its einsum path (``grouped_sdpa``); the port takes the kernel in
both. Decode attends over the cache with the plain ``grouped_sdpa``, as the
reference does outside Pallas, and writes the cache in place. MLA is not
ported yet (ROADMAP §1 item 3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (Params, apply_rope, const, dense_init,
                                       dt, rmsnorm_nohead)

NEG_INF = -1e30
MLA_TODO = ("MLA attention (deepseek-v2-lite) is not ported yet: "
            "ROADMAP §1 item 3")


class KVCache(NamedTuple):
    """Fixed-capacity decode cache; ``length`` is per slot (B,) so that
    requests at different positions decode in one batch."""
    k: torch.Tensor          # (B, cap, n_kv, head_dim), post-rope keys
    v: torch.Tensor          # (B, cap, n_kv, head_dim)
    length: torch.Tensor     # (B,) int32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Attention(Params):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.attention == "mla":
            raise NotImplementedError(MLA_TODO)
        dtype = dtype or dt(cfg.param_dtype)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = dense_init(gen, d, nh * hd, dtype, device)
        self.wk = dense_init(gen, d, nkv * hd, dtype, device)
        self.wv = dense_init(gen, d, nkv * hd, dtype, device)
        self.wo = dense_init(gen, nh * hd, d, dtype, device)
        if cfg.qkv_bias:
            self.bq = const((nh * hd,), 0.0, dtype, device)
            self.bk = const((nkv * hd,), 0.0, dtype, device)
            self.bv = const((nkv * hd,), 0.0, dtype, device)
        if cfg.qk_norm:
            self.q_norm = const((hd,), 1.0, dtype, device)
            self.k_norm = const((hd,), 1.0, dtype, device)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Attention:
    return Attention(cfg, gen, gen.device)


# ---------------------------------------------------------------------------
# masks and the plain grouped attention
# ---------------------------------------------------------------------------

def attention_bias(q_len: int, kv_len: int, *, causal: bool, window: int,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) additive bias in fp32; q_offset is the absolute
    position of query 0."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    return torch.where(ok, 0.0, NEG_INF).float()


def grouped_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd) with H = KV*G -> (B,S,H,hd). Scores in
    fp32, probabilities rounded to v's type before the product, as the
    reference's einsum path does."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


# ---------------------------------------------------------------------------
# GQA forward (prefill / decode)
# ---------------------------------------------------------------------------

def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm_nohead(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm_nohead(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(params, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor):
    """Full-sequence attention through the kernel op; returns the output
    projection and the keys and values for a cache."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x, positions)
    o = ops.flash_attention(q, k, v, causal=cfg.causal,
                            window=cfg.sliding_window, scale=hd ** -0.5)
    return o.reshape(B, S, cfg.n_heads * hd) @ params["wo"], k, v


def attention(params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (prefill). x: (B,S,D)."""
    if cfg.attention == "mla":
        raise NotImplementedError(MLA_TODO)
    return _attend(params, cfg, x, positions)[0]


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int,
                  device) -> KVCache:
    if cfg.attention == "mla":
        raise NotImplementedError(MLA_TODO)
    dtype = dt(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    cap = min(capacity, cfg.sliding_window) if cfg.sliding_window \
        else capacity
    shape = (batch, cap, cfg.n_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=device))


def decode_attention(params, cfg: ModelConfig, x: torch.Tensor,
                     cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B,1,D). Returns (out (B,1,D), cache).

    Writes this token's key and value into ``cache.k``/``cache.v`` in place
    (the reference returns new arrays; the in-place write saves a copy of
    the whole cache per step) and returns the cache with ``length + 1``.
    Sliding-window configs keep a ring of ``window`` slots. A slot whose
    position is past the capacity (an idle slot that kept counting) writes
    nothing, as the reference's scatter drops out-of-range rows."""
    if cfg.attention == "mla":
        raise NotImplementedError(MLA_TODO)
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache.length
    q, k, v = _project_qkv(params, cfg, x, pos[:, None])
    cap = cache.k.shape[1]
    slot = (pos % cap if cfg.sliding_window else pos).long()
    fits = (slot < cap)[:, None, None]
    slot = slot.clamp(max=cap - 1)
    b_idx = torch.arange(B, device=x.device)
    cache.k[b_idx, slot] = torch.where(fits, k[:, 0].to(cache.k.dtype),
                                       cache.k[b_idx, slot])
    cache.v[b_idx, slot] = torch.where(fits, v[:, 0].to(cache.v.dtype),
                                       cache.v[b_idx, slot])
    slots = torch.arange(cap, device=x.device)[None, :]
    if cfg.sliding_window:
        valid = slots < torch.clamp(pos + 1, max=cap)[:, None]
    else:
        valid = slots <= pos[:, None]
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, None, :]
    out = grouped_sdpa(q, cache.k.to(q.dtype), cache.v.to(q.dtype), bias,
                       hd ** -0.5)
    out = out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]
    return out, KVCache(cache.k, cache.v, pos + 1)


def attention_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Like :func:`attention`, but also returns the populated KV cache for
    decode: absolute slots, or for a sliding window a ring where position p
    lives at slot p % cap."""
    if cfg.attention == "mla":
        raise NotImplementedError(MLA_TODO)
    B, S, _ = x.shape
    dtype = dt(cfg.compute_dtype)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    out, k, v = _attend(params, cfg, x, positions)
    win = cfg.sliding_window
    if win and win < max(S, capacity):
        cap = min(capacity, win)
        n_keep = min(S, cap)
        keep = torch.arange(S - n_keep, S, device=x.device)
        slots = keep % cap
        ck = torch.zeros((B, cap) + k.shape[2:], dtype=dtype, device=x.device)
        cv = torch.zeros_like(ck)
        ck[:, slots] = k[:, keep].to(dtype)
        cv[:, slots] = v[:, keep].to(dtype)
        return out, KVCache(ck, cv, lengths)
    if S > capacity:
        raise ValueError(f"prompt of {S} tokens exceeds the cache capacity "
                         f"{capacity}")
    ck = torch.zeros((B, capacity) + k.shape[2:], dtype=dtype,
                     device=x.device)
    cv = torch.zeros_like(ck)
    ck[:, :S] = k
    cv[:, :S] = v
    return out, KVCache(ck, cv, lengths)
