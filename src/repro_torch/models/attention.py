"""Attention: GQA (qk-norm, qkv-bias, sliding window, bidirectional) and
MLA (deepseek-v2): full sequence, prefill into a decode cache, and
one-token decode.

Counterpart of ``repro.models.attention``. Full-sequence attention
(``attention`` and ``attention_prefill``) goes through
`repro_torch.kernels.ops.flash_attention`: the hand-written kernel on CUDA
tensors, its plain version on the CPU. The reference's ``attention_prefill``
always ran its einsum path (``grouped_sdpa``); the port takes the kernel in
both. Decode attends over the cache with the plain ``grouped_sdpa``, as the
reference does outside Pallas, and writes the cache in place.

MLA (with ``mla.rope`` off, NoPE: the rope parts of q and k are not
rotated, as Kimi-Linear's ``mla_use_nope``) prefill decompresses per-head
keys and values from the latent and runs
them through the same kernel at one head dim for q, k and v, as the Pallas
kernel takes them: q = [q_nope, q_rope], k = [k_nope, k_rope] (the rope key
shared by every head), v zero-padded to that width, and the padded columns
of the output (exactly 0) cut off. On the CPU a prompt of
``BLOCKED_THRESHOLD`` tokens or more takes :func:`blocked_mla_core`, where
the reference does. MLA decode is the absorbed form, as the reference
computes it: the cache holds only the latent ``c_kv`` and the rope key,
and the attention over it goes through
`repro_torch.kernels.ops.mla_decode` (a flash-decode kernel over each
slot's cached positions on the card; the reference's arithmetic, its plain
version, on the CPU). Over tp-split latent caches the decode keeps its
plain code.

Training (``use_kernels=False``, which ``model.loss_fn`` passes) takes the
reference's own XLA paths instead, in plain PyTorch: ``grouped_sdpa`` over a
bias, or ``blocked_grouped_sdpa`` from ``BLOCKED_THRESHOLD`` tokens on; for
MLA the einsum path (``mla_core``), or ``blocked_mla_core`` from that
length. The kernels have no backward.

Over a mesh (``ctx``) each function runs on this rank's batch rows and,
where the heads divide tp, on its block of heads (the reference's
constraints of q, k and v over tp): q, k, v and the output projection on
the tp blocks of their weights, the output summed over tp. Where the kv
heads do not divide tp, k and v are computed whole, repeated to the query
heads and cut to this rank's block, as the reference does. Where the query
heads do not divide tp, every tp rank computes all heads. The prefill
hands the kernel plain contiguous local tensors, and its caches come back
whole (gathered over tp). The decode over a mesh takes its caches as
``shard_caches`` lays them out by ``cache_pspecs`` and keeps them so: the
kv heads over tp, or for long contexts and kv heads that do not divide tp
the positions (split-KV, the softmax's max and sum combined over tp); MLA's
latent caches on their latent and rope dims, or their positions.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (fsdp_gather, local,
                                              placed_like, shard_dims,
                                              splits_kv_heads, tp_part,
                                              tp_whole)
from repro_torch.kernels import ops
from repro_torch.models.layers import (Params, apply_rope, const, dense_init,
                                       dt, rmsnorm_nohead, tp_region)

NEG_INF = -1e30
BLOCKED_THRESHOLD = 8192     # plain paths: blocked from this length on
Q_CHUNK = 1024


class KVCache(NamedTuple):
    """Fixed-capacity decode cache; ``length`` is per slot (B,) so that
    requests at different positions decode in one batch. For MLA, k holds
    the latent c_kv and v the rope key."""
    k: torch.Tensor          # (B, cap, n_kv, head_dim) | MLA (B, cap, kv_lora)
    v: torch.Tensor          # (B, cap, n_kv, head_dim) | MLA (B, cap, rope)
    length: torch.Tensor     # (B,) int32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Attention(Params):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or dt(cfg.param_dtype)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        if cfg.attention == "mla":
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            self.wq = dense_init(gen, d, nh * qk, dtype, device)
            # joint down-projection: the latent c_kv and the shared rope key
            self.w_dkv = dense_init(gen, d, m.kv_lora_rank
                                    + m.qk_rope_head_dim, dtype, device)
            self.kv_norm = const((m.kv_lora_rank,), 1.0, dtype, device)
            self.w_uk = dense_init(gen, m.kv_lora_rank,
                                   nh * m.qk_nope_head_dim, dtype, device)
            self.w_uv = dense_init(gen, m.kv_lora_rank, nh * m.v_head_dim,
                                   dtype, device)
            self.wo = dense_init(gen, nh * m.v_head_dim, d, dtype, device)
            return
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


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: ModelConfig, use_kernels: bool) -> torch.Tensor:
    """The attention core, (B,S,H,hd): the kernel op, or the reference's
    plain paths (``grouped_sdpa`` over a bias, ``blocked_grouped_sdpa``
    from ``BLOCKED_THRESHOLD`` tokens on)."""
    S, hd = q.shape[1], q.shape[-1]
    win, scale = cfg.sliding_window, hd ** -0.5
    if use_kernels:
        return ops.flash_attention(q, k, v, causal=cfg.causal, window=win,
                                   scale=scale)
    if S >= BLOCKED_THRESHOLD:
        return blocked_grouped_sdpa(q, k, v, causal=cfg.causal, window=win,
                                    scale=scale)
    return grouped_sdpa(q, k, v, attention_bias(
        S, S, causal=cfg.causal, window=win, device=q.device), scale)


def _attend(params, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor, use_kernels: bool = True):
    """Full-sequence attention; returns the output projection and the keys
    and values for a cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    o = _sdpa(q, k, v, cfg, use_kernels)
    return o.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim) \
        @ params["wo"], k, v


def _local_cfg(cfg: ModelConfig, n_heads: int, n_kv_heads: int
               ) -> ModelConfig:
    """``cfg`` with a tp rank's head counts (the head dim kept)."""
    return dataclasses.replace(cfg, n_heads=n_heads, n_kv_heads=n_kv_heads,
                               head_dim=cfg.resolved_head_dim)


def _set(p: dict, ctx, fn, dims) -> dict:
    """``p`` with ``fn(ctx, w, dim, full)`` applied to each named weight it
    has (``dims``: name -> (dim, full))."""
    return {**p, **{n: fn(ctx, p[n], d, f) for n, (d, f) in dims.items()
                    if n in p}}


def _gqa_split(params, cfg: ModelConfig, ctx):
    """(this tp rank's weights, its config, the kv repeat G or 0, whether
    its output is a part of a sum over tp)."""
    tp, nh, nkv = ctx.tp_size, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q_dims = {"wq": (1, nh * hd), "bq": (0, nh * hd), "wo": (0, nh * hd)}
    kv_dims = {"wk": (1, nkv * hd), "wv": (1, nkv * hd),
               "bk": (0, nkv * hd), "bv": (0, nkv * hd)}
    if nh % tp:
        p = _set(_set(params, ctx, tp_whole, q_dims), ctx, tp_whole, kv_dims)
        return p, cfg, 0, False
    p = _set(params, ctx, tp_part, q_dims)
    if nkv % tp == 0:
        return (_set(p, ctx, tp_part, kv_dims),
                _local_cfg(cfg, nh // tp, nkv // tp), 0, tp > 1)
    # GQA with kv heads < tp: k and v whole, repeated to the query heads
    return (_set(p, ctx, tp_whole, kv_dims), _local_cfg(cfg, nh // tp, nkv),
            nh // nkv, True)


def _attention_tp(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, use_kernels: bool, ctx):
    """Attention over the mesh: (output in the residual's layout, k, v of
    this rank's kv heads, or of all of them where they do not divide
    tp)."""
    p, lcfg, G, partial = _gqa_split(fsdp_gather(params, cfg, ctx), cfg, ctx)

    def fn(h):
        B, S, _ = h.shape
        q, k, v = _project_qkv(p, lcfg, h, positions)
        kq, vq = k, v
        if G:
            kq, vq = (ctx.constrain(t.repeat_interleave(G, dim=2), None,
                                    None, ctx.tp_axis, None).contiguous()
                      for t in (k, v))
        o = _sdpa(q, kq, vq, lcfg, use_kernels)
        return o.reshape(B, S, lcfg.n_heads * lcfg.resolved_head_dim) \
            @ p["wo"], k, v
    return tp_region(ctx, (fn, partial), x)


def attention(params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, use_kernels: bool = True,
              ctx=None) -> torch.Tensor:
    """Full-sequence attention. x: (B,S,D). Through the kernel op, or with
    ``use_kernels=False`` (training) the reference's plain paths:
    ``grouped_sdpa`` over a bias, ``blocked_grouped_sdpa`` from
    ``BLOCKED_THRESHOLD`` tokens on. Over a mesh (``ctx``), x is the
    residual's local block and so is the output."""
    if cfg.attention == "mla":
        return mla_attention(params, cfg, x, positions, use_kernels, ctx)
    if ctx is not None:
        return _attention_tp(params, cfg, x, positions, use_kernels, ctx)[0]
    return _attend(params, cfg, x, positions, use_kernels)[0]


def blocked_grouped_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, scale: float,
                         q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Exact grouped attention one block of ``q_chunk`` queries at a time
    (the largest divisor of S up to it), with no (S,S) buffer; with a
    window only the (window + q_chunk)-wide key slab (rounded up to 128) a
    block is touched, as the reference's scan does. q (B,S,H,hd), k/v
    (B,S,KV,hd) -> (B,S,H,hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qc = min(q_chunk, S)
    while S % qc:
        qc -= 1
    use_slab = window > 0 and (window + qc) < S
    slab = min(S, ((window + qc + 127) // 128) * 128) if use_slab else S
    outs = []
    for q0 in range(0, S, qc):
        start = min(max(q0 + qc - slab, 0), S - slab) if use_slab else 0
        k_blk, v_blk = k[:, start:start + slab], v[:, start:start + slab]
        k_pos = start + torch.arange(slab, device=q.device)
        q_pos = q0 + torch.arange(qc, device=q.device)
        ok = torch.ones((qc, slab), dtype=torch.bool, device=q.device)
        if causal:
            ok &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            ok &= k_pos[None, :] > q_pos[:, None] - window
        bias = torch.where(ok, 0.0, NEG_INF).float()
        q_blk = q[:, q0:q0 + qc].reshape(B, qc, KV, H // KV, hd)
        scores = torch.einsum("bskgh,btkh->bkgst", q_blk.float(),
                              k_blk.float()) * scale
        probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgst,btkh->bskgh", probs, v_blk)
                    .reshape(B, qc, H, hd))
    return torch.cat(outs, dim=1)


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int,
                  device) -> KVCache:
    dtype = dt(cfg.compute_dtype)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.attention == "mla":
        m = cfg.mla
        return KVCache(
            k=torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype,
                          device=device),
            v=torch.zeros((batch, capacity, m.qk_rope_head_dim), dtype=dtype,
                          device=device),
            length=length)
    hd = cfg.resolved_head_dim
    cap = min(capacity, cfg.sliding_window) if cfg.sliding_window \
        else capacity
    shape = (batch, cap, cfg.n_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=length)


def _write_slots(buf: torch.Tensor, slot: torch.Tensor,
                 value: torch.Tensor) -> None:
    """buf[b, slot[b]] = value[b] in place for every batch row b whose slot
    is inside the capacity; a row past it writes nothing, as the
    reference's scatter drops out-of-range rows."""
    cap = buf.shape[1]
    b_idx = torch.arange(buf.shape[0], device=buf.device)
    fits = (slot < cap).reshape((-1,) + (1,) * (value.dim() - 1))
    slot = slot.clamp(max=cap - 1)
    buf[b_idx, slot] = torch.where(fits, value.to(buf.dtype), buf[b_idx, slot])


def decode_attention(params, cfg: ModelConfig, x: torch.Tensor,
                     cache: KVCache, ctx=None) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B,1,D). Returns (out (B,1,D), cache).

    Writes this token's key and value into ``cache.k``/``cache.v`` in place
    (the reference returns new arrays; the in-place write saves a copy of
    the whole cache per step) and returns the cache with ``length + 1``.
    Sliding-window configs keep a ring of ``window`` slots. A slot whose
    position is past the capacity (an idle slot that kept counting) writes
    nothing, as the reference's scatter drops out-of-range rows. Over a
    mesh (``ctx``) the cache is laid out by ``cache_pspecs``
    (:func:`_decode_attention_tp`) and x is this rank's rows."""
    if cfg.attention == "mla":
        return mla_decode(params, cfg, x, cache, ctx)
    if ctx is not None:
        return _decode_attention_tp(params, cfg, x, cache, ctx)
    pos = cache.length
    out = _gqa_decode(params, cfg, x, cache.k, cache.v, pos)
    return out, KVCache(cache.k, cache.v, pos + 1)


def _gqa_decode(params, cfg: ModelConfig, x: torch.Tensor, k_buf, v_buf,
                pos: torch.Tensor) -> torch.Tensor:
    """The decode of :func:`decode_attention` on the heads of the weights
    and buffers it is given, positions ``pos`` (B,); returns the output
    projection."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x, pos[:, None])
    cap = k_buf.shape[1]
    slot = (pos % cap if cfg.sliding_window else pos).long()
    _write_slots(k_buf, slot, k[:, 0])
    _write_slots(v_buf, slot, v[:, 0])
    slots = torch.arange(cap, device=x.device)[None, :]
    if cfg.sliding_window:
        valid = slots < torch.clamp(pos + 1, max=cap)[:, None]
    else:
        valid = slots <= pos[:, None]
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, None, :]
    out = grouped_sdpa(q, k_buf.to(q.dtype), v_buf.to(q.dtype), bias,
                       hd ** -0.5)
    return out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]


def _decode_attention_tp(params, cfg: ModelConfig, x: torch.Tensor,
                         cache: KVCache, ctx) -> Tuple[torch.Tensor, KVCache]:
    """GQA decode over the mesh, on the cache's ``cache_pspecs`` layout
    (``DTensor`` leaves from ``shard_caches``): batch rows over the data
    axes (``length`` whole on every rank), and over tp either the kv heads
    (this rank's heads as in the prefill, the output summed over tp) or,
    for long contexts or kv heads that do not divide tp, the positions
    (split-KV: :func:`_gqa_decode_split`). A cache whole over tp runs every
    head on every rank."""
    dims = shard_dims(cache.k)
    kb, vb = local(cache.k), local(cache.v)
    pos = ctx.constrain(local(cache.length), dims.get(0))
    new = cache._replace(length=placed_like(local(cache.length) + 1,
                                            cache.length))
    params = fsdp_gather(params, cfg, ctx)
    tp = ctx.tp_axis
    if ctx.tp_size == 1 or dims.get(2) == (tp,):
        p, lcfg, _, partial = _gqa_split(params, cfg, ctx)
        out = _gqa_decode(p, lcfg, x, kb, vb, pos)
        return (ctx.psum(out, tp) if partial else out), new
    hd = cfg.resolved_head_dim
    p = _set(params, ctx, tp_whole, {
        "wq": (1, cfg.n_heads * hd), "bq": (0, cfg.n_heads * hd),
        "wo": (0, cfg.n_heads * hd), "wk": (1, cfg.n_kv_heads * hd),
        "wv": (1, cfg.n_kv_heads * hd), "bk": (0, cfg.n_kv_heads * hd),
        "bv": (0, cfg.n_kv_heads * hd)})
    if dims.get(1) == (tp,):
        return _gqa_decode_split(p, cfg, x, kb, vb, pos, ctx), new
    return _gqa_decode(p, cfg, x, kb, vb, pos), new


def _split_probs(scores: torch.Tensor, valid: torch.Tensor, ctx):
    """Softmax over keys split over tp: ``scores`` (..., T_local) fp32 of
    this rank's keys, ``valid`` broadcast over them. The max and the sum
    are combined over tp (the max first), so every rank holds its keys'
    probabilities of the whole softmax, exact up to rounding."""
    scores = torch.where(valid, scores, NEG_INF)
    m = ctx.pmax(scores.amax(dim=-1, keepdim=True), ctx.tp_axis)
    e = torch.where(valid, torch.exp(scores - m), 0.0)
    return e / ctx.psum(e.sum(dim=-1, keepdim=True), ctx.tp_axis)


def _gqa_decode_split(p, cfg: ModelConfig, x: torch.Tensor, kb, vb,
                      pos: torch.Tensor, ctx) -> torch.Tensor:
    """Split-KV decode: this rank holds slots [r cap_l, (r + 1) cap_l) of
    the cache (a ring for a sliding window) and every head; it writes this
    token's key and value only when its slot falls there, attends over its
    slots (:func:`_split_probs`), and the weighted values are summed over
    tp in float32. ``p`` holds the whole weights."""
    B = x.shape[0]
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    cap_l = kb.shape[1]
    cap = cap_l * ctx.tp_size
    lo = ctx.tp_rank * cap_l
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    slot = (pos % cap if cfg.sliding_window else pos).long() - lo
    here = torch.where((slot >= 0) & (slot < cap_l), slot, cap_l)
    _write_slots(kb, here, k[:, 0])
    _write_slots(vb, here, v[:, 0])
    slots = lo + torch.arange(cap_l, device=x.device)[None, :]
    if cfg.sliding_window:
        valid = slots < torch.clamp(pos + 1, max=cap)[:, None]
    else:
        valid = slots <= pos[:, None]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          kb.float()) * hd ** -0.5
    probs = _split_probs(scores, valid[:, None, None, None, :], ctx)
    o = torch.einsum("bkgst,btkh->bskgh", probs.to(vb.dtype),
                     vb.to(q.dtype))
    o = ctx.psum(o.float(), ctx.tp_axis).to(q.dtype)
    return o.reshape(B, 1, H * hd) @ p["wo"]


def attention_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, capacity: int, ctx=None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Like :func:`attention`, but also returns the populated KV cache for
    decode: absolute slots, or for a sliding window a ring where position p
    lives at slot p % cap; for MLA the latent caches at slots [0, S). Over
    a mesh the cache holds this rank's rows, and its kv heads where the
    decode's layout splits them over tp (``splits_kv_heads``), else every
    kv head."""
    B, S, _ = x.shape
    dtype = dt(cfg.compute_dtype)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if cfg.attention == "mla":
        # the latents once: the reference computes them a second time for
        # the cache, to the same values
        out, c_kv, k_rope = _mla(params, cfg, x, positions, True, ctx)
        if S > capacity:
            raise ValueError(f"prompt of {S} tokens exceeds the cache "
                             f"capacity {capacity}")
        cache = init_kv_cache(cfg, B, capacity, x.device)
        cache.k[:, :S] = c_kv
        cache.v[:, :S] = k_rope
        return out, cache._replace(length=lengths)
    if ctx is None:
        out, k, v = _attend(params, cfg, x, positions)
    else:
        out, k, v = _attention_tp(params, cfg, x, positions, True, ctx)
        cap = min(capacity, cfg.sliding_window or capacity)
        if k.shape[2] != cfg.n_kv_heads and not splits_kv_heads(
                ctx, cap, cfg.n_kv_heads):       # this rank's kv heads
            k, v = (ctx.gather(t, None, None, ctx.tp_axis) for t in (k, v))
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_q(params, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """(q_nope, q_rope) (B,S,H,·), the rope applied to q_rope (unless the
    config's ``mla.rope`` is off)."""
    m = cfg.mla
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(
        B, S, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                             dim=-1)
    if not m.rope:                       # NoPE (Kimi-Linear)
        return q_nope, q_rope
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """Down-project to (c_kv (B,S,r), k_rope (B,S,rope)): c_kv rms-normed,
    k_rope rotated (unless ``mla.rope`` is off) and shared by every
    head."""
    m = cfg.mla
    c_kv, k_rope = (x @ params["w_dkv"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm_nohead(c_kv, params["kv_norm"], cfg.norm_eps)
    if not m.rope:                       # NoPE (Kimi-Linear)
        return c_kv, k_rope
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_attend(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, use_kernels: bool = True):
    """Full-sequence MLA with decompressed per-head keys and values; returns
    the output projection and the latents (c_kv, k_rope) for a cache. The
    core runs on the kernel op, or with ``use_kernels=False`` on the
    reference's einsum path (:func:`mla_core`; :func:`blocked_mla_core`
    from ``BLOCKED_THRESHOLD`` tokens on)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_latent(params, cfg, x, positions)
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(B, S, H, m.v_head_dim)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if S >= BLOCKED_THRESHOLD and (x.device.type == "cpu"
                                   or not use_kernels):
        out = blocked_mla_core(q_nope, q_rope, k_nope, k_rope, v, scale)
    elif not use_kernels:
        out = mla_core(q_nope, q_rope, k_nope, k_rope, v, scale, cfg.causal)
    else:
        out = mla_flash(q_nope, q_rope, k_nope, k_rope, v, scale,
                        causal=cfg.causal)
    out = out.reshape(B, S, H * m.v_head_dim) @ params["wo"]
    return out, c_kv, k_rope


def _mla(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
         use_kernels: bool, ctx):
    """:func:`_mla_attend`, over the mesh when ``ctx``: this rank's block of
    heads (q, k_nope and v over tp, as the reference constrains them) where
    they divide tp, the latents whole, the output summed over tp."""
    if ctx is None:
        return _mla_attend(params, cfg, x, positions, use_kernels)
    m, H, tp = cfg.mla, cfg.n_heads, ctx.tp_size
    dims = {"wq": (1, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            "w_uk": (1, H * m.qk_nope_head_dim),
            "w_uv": (1, H * m.v_head_dim), "wo": (0, H * m.v_head_dim)}
    params = fsdp_gather(params, cfg, ctx)
    if H % tp:
        p, lcfg = _set(params, ctx, tp_whole, dims), cfg
    else:
        p = _set(params, ctx, tp_part, dims)
        lcfg = _local_cfg(cfg, H // tp, cfg.n_kv_heads)
    return tp_region(ctx, (lambda h: _mla_attend(p, lcfg, h, positions,
                                                 use_kernels),
                           H % tp == 0 and tp > 1), x)


def mla_attention(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, use_kernels: bool = True,
                  ctx=None) -> torch.Tensor:
    """Full-sequence MLA. x: (B,S,D)."""
    return _mla(params, cfg, x, positions, use_kernels, ctx)[0]


def mla_core(q_nope, q_rope, k_nope, k_rope, v, scale: float,
             causal: bool = True) -> torch.Tensor:
    """The reference's einsum MLA core: scores in fp32 from the nope and
    rope parts over a (S,S) bias, probabilities rounded to v's type before
    the product. Shapes as :func:`mla_flash`."""
    S = q_nope.shape[1]
    scores = (torch.einsum("bshe,bthe->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshe,bte->bhst", q_rope.float(),
                             k_rope.float())) * scale
    bias = attention_bias(S, S, causal=causal, window=0,
                          device=q_nope.device)
    probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthe->bshe", probs, v)


def mla_flash(q_nope, q_rope, k_nope, k_rope, v, scale: float,
              causal: bool = True) -> torch.Tensor:
    """MLA's attention core on the flash-attention op at one head dim for
    q, k and v: q = [q_nope, q_rope], k = [k_nope, k_rope over every head],
    v zero-padded to that dim; the output's padded columns (0) cut off.
    q_nope/k_nope (B,S,H,nope), q_rope (B,S,H,rope), k_rope (B,S,rope), v
    (B,S,H,dv) -> (B,S,H,dv)."""
    B, S, H, _ = q_nope.shape
    q = torch.cat([q_nope, q_rope], dim=-1)
    hd, dv = q.shape[-1], v.shape[-1]
    if dv > hd:
        raise ValueError(f"v head dim {dv} exceeds the q/k head dim {hd}")
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, -1)],
                  dim=-1)
    o = ops.flash_attention(q, k, F.pad(v, (0, hd - dv)), causal=causal,
                            scale=scale)
    return o[..., :dv]


def blocked_mla_core(q_nope, q_rope, k_nope, k_rope, v, scale: float,
                     q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Causal MLA attention one block of ``q_chunk`` queries at a time (the
    largest divisor of S up to it), with no (S,S) buffer: scores in fp32
    from the nope and rope parts, probabilities rounded to v's type before
    the product, as the reference's scan does."""
    B, S, H, _ = q_nope.shape
    qc = min(q_chunk, S)
    while S % qc:
        qc -= 1
    k_pos = torch.arange(S, device=q_nope.device)
    kn, kr = k_nope.float(), k_rope.float()
    outs = []
    for q0 in range(0, S, qc):
        q_pos = q0 + torch.arange(qc, device=q_nope.device)
        bias = torch.where(k_pos[None, :] <= q_pos[:, None], 0.0,
                           NEG_INF).float()
        scores = (torch.einsum("bshe,bthe->bhst",
                               q_nope[:, q0:q0 + qc].float(), kn)
                  + torch.einsum("bshe,bte->bhst",
                                 q_rope[:, q0:q0 + qc].float(), kr)) * scale
        probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhst,bthe->bshe", probs, v))
    return torch.cat(outs, dim=1)


def mla_decode(params, cfg: ModelConfig, x: torch.Tensor,
               cache: KVCache, ctx=None) -> Tuple[torch.Tensor, KVCache]:
    """Absorbed-form one-token decode over the latent caches: score =
    (q_nope W_uk) c_kv + q_rope k_rope, in fp32; the probabilities rounded
    to the cache's type; the latent context through W_uv and wo. This
    token's c_kv and k_rope are written into the caches in place, and a slot
    past the capacity writes nothing, as in :func:`decode_attention`. Over
    a mesh (``ctx``) the caches follow ``cache_pspecs``
    (:func:`_mla_decode_tp`)."""
    if ctx is not None:
        return _mla_decode_tp(params, cfg, x, cache, ctx)
    pos = cache.length
    q_nope, q_rope = _mla_q(params, cfg, x, pos[:, None])
    c_kv, k_rope = _mla_latent(params, cfg, x, pos[:, None])
    _write_slots(cache.k, pos.long(), c_kv[:, 0])
    _write_slots(cache.v, pos.long(), k_rope[:, 0])
    return _mla_absorbed(params, cfg, q_nope, q_rope, cache.k, cache.v,
                         pos), KVCache(cache.k, cache.v, pos + 1)


def _mla_absorbed(params, cfg: ModelConfig, q_nope, q_rope, ck, cr,
                  pos: torch.Tensor) -> torch.Tensor:
    """The absorbed attention of :func:`mla_decode` over the latent caches
    ``ck`` (B,cap,r) and ``cr`` (B,cap,rope) after this token's write: the
    attention core over each slot's cached positions through
    `repro_torch.kernels.ops.mla_decode` (its kernel on the card, its plain
    version on the CPU), then W_uv and wo."""
    m = cfg.mla
    B = q_nope.shape[0]
    H, r = cfg.n_heads, m.kv_lora_rank
    w_uk = params["w_uk"].reshape(r, H, m.qk_nope_head_dim)
    q_abs = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], w_uk)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    lat = ops.mla_decode(q_abs, q_rope[:, 0], ck, cr, pos, scale)  # latent
    w_uv = params["w_uv"].reshape(r, H, m.v_head_dim)
    return torch.einsum("bhr,rhe->bhe", lat, w_uv).reshape(
        B, 1, H * m.v_head_dim) @ params["wo"]


def _mla_decode_tp(params, cfg: ModelConfig, x: torch.Tensor,
                   cache: KVCache, ctx) -> Tuple[torch.Tensor, KVCache]:
    """MLA decode over the mesh. The latent caches follow ``cache_pspecs``:
    batch rows over the data axes, and over tp either the latent and rope
    dims (the rule's choice where they divide tp: every head on every rank,
    the scores' sum over those dims and the latent context's product with
    W_uv summed over tp) or the positions (split-KV, long contexts: every
    head, this rank's slots, the softmax and the latent context combined
    over tp); at tp 1, or with caches whole over tp, the plain decode."""
    m = cfg.mla
    H, r = cfg.n_heads, m.kv_lora_rank
    dims_k, dims_v = shard_dims(cache.k), shard_dims(cache.v)
    ck, cr = local(cache.k), local(cache.v)
    pos = ctx.constrain(local(cache.length), dims_k.get(0))
    new = cache._replace(length=placed_like(local(cache.length) + 1,
                                            cache.length))
    tp = ctx.tp_axis
    p = _set(fsdp_gather(params, cfg, ctx), ctx, tp_whole, {
        "wq": (1, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
        "w_uk": (1, H * m.qk_nope_head_dim),
        "w_uv": (1, H * m.v_head_dim), "wo": (0, H * m.v_head_dim)})
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None])
    c_kv, k_rope = _mla_latent(p, cfg, x, pos[:, None])
    split_k, split_v = dims_k.get(2) == (tp,), dims_v.get(2) == (tp,)
    cap_k, cap_v = dims_k.get(1) == (tp,), dims_v.get(1) == (tp,)
    if ctx.tp_size == 1 or not (split_k or split_v or cap_k or cap_v):
        _write_slots(ck, pos.long(), c_kv[:, 0])
        _write_slots(cr, pos.long(), k_rope[:, 0])
        return _mla_absorbed(p, cfg, q_nope, q_rope, ck, cr, pos), new
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    w_uk = p["w_uk"].reshape(r, H, m.qk_nope_head_dim)
    w_uv = p["w_uv"].reshape(r, H, m.v_head_dim)
    B, cap_l = x.shape[0], ck.shape[1]
    if split_k and split_v:
        rl, el = ck.shape[2], cr.shape[2]
        r0, e0 = ctx.tp_rank * rl, ctx.tp_rank * el
        _write_slots(ck, pos.long(), c_kv[:, 0, r0:r0 + rl])
        _write_slots(cr, pos.long(), k_rope[:, 0, e0:e0 + el])
        q_abs = torch.einsum("bhe,rhe->bhr", q_nope[:, 0],
                             w_uk[r0:r0 + rl])
        scores = ctx.psum(
            torch.einsum("bhr,btr->bht", q_abs.float(), ck.float())
            + torch.einsum("bhe,bte->bht", q_rope[:, 0, :, e0:e0 + el]
                           .float(), cr.float()), tp) * scale
        valid = torch.arange(cap_l, device=x.device)[None, :] \
            <= pos[:, None]
        scores = torch.where(valid[:, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(ck.dtype)
        lat = torch.einsum("bht,btr->bhr", probs, ck)
        o = torch.einsum("bhr,rhe->bhe", lat, w_uv[r0:r0 + rl])
    elif cap_k and cap_v:
        lo = ctx.tp_rank * cap_l
        slot = pos.long() - lo
        here = torch.where((slot >= 0) & (slot < cap_l), slot, cap_l)
        _write_slots(ck, here, c_kv[:, 0])
        _write_slots(cr, here, k_rope[:, 0])
        q_abs = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], w_uk)
        scores = (torch.einsum("bhr,btr->bht", q_abs.float(), ck.float())
                  + torch.einsum("bhe,bte->bht", q_rope[:, 0].float(),
                                 cr.float())) * scale
        valid = (lo + torch.arange(cap_l, device=x.device))[None, :] \
            <= pos[:, None]
        probs = _split_probs(scores, valid[:, None, :], ctx)
        lat = ctx.psum(torch.einsum("bht,btr->bhr", probs.to(ck.dtype),
                                    ck).float(), tp).to(ck.dtype)
        o = torch.einsum("bhr,rhe->bhe", lat, w_uv)
    else:
        raise ValueError(f"MLA caches laid out {dims_k} and {dims_v}: the "
                         f"latent and rope caches must split alike")
    if split_k:
        o = ctx.psum(o.float(), tp).to(o.dtype)
    return o.reshape(B, 1, H * m.v_head_dim) @ p["wo"], new
