"""Kimi Delta Attention (KDA), the linear-attention mixer of Kimi-Linear
(arXiv:2510.26692): a gated delta rule whose state decays by a separate
rate for each key channel.

For each token t and head h, with K = V = ``kda.head_dim``:

  q, k, v = SiLU(causal depthwise conv(x W_{q,k,v}))  (short conv, no bias)
  q̂ = q / |q|, k̂ = k / |k|                           (per head)
  g   = -exp(A_log_h) * softplus(W_fb(W_fa x) + dt_bias)   (K,), <= 0
  β   = sigmoid(x W_b)_h
  S  <- Diag(exp(g)) S                                 (S is K x V, float32)
  S  <- S + β k̂ (v - Sᵀ k̂)ᵀ
  o   = Sᵀ q̂ K^-1/2
  y   = RMSNorm(o) * o_norm * sigmoid(W_gb(W_ga x) + b_g)_h
  out = concat_h(y) W_o

Names follow the model card's ``modeling_kimi.py``: ``wq``/``wk``/``wv``
(``q_proj``...), ``conv_q``/``conv_k``/``conv_v`` (``q_conv1d``...,
laid out (taps, channels)), ``f_a``/``f_b`` (``f_a_proj``/``f_b_proj``),
``A_log``, ``dt_bias``, ``w_beta`` (``b_proj``), ``g_a``/``g_b`` and
``g_bias`` (``g_a_proj``/``g_b_proj``), ``o_norm`` and ``wo``. The decay's
``A_log`` and ``dt_bias`` are float32 whatever the parameter type, as a
router is; the projections and the conv run in the compute type, the
rest in float32.

The prefill (:func:`kda_prefill`) takes the closed form over chunks of
``kda.chunk`` tokens: inside a chunk every decay is relative, exp(Γ_i -
Γ_j) with i >= j (Γ the decays' running sum), so nothing exceeds 1 and a
decay of -16 a token over a chunk cannot overflow; the delta rule's
triangular system is solved once a chunk, and only the state passes from
chunk to chunk. The decode (:func:`kda_decode`) is one step of the
recurrence over the cache's state, written in place. Both are plain
PyTorch. The state is float32; the conv keeps the last ``conv_size - 1``
projections of q, k and v in the compute type.

Over a mesh a KDA model is not served: the functions raise on a ``ctx``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, const, dense_init, dt, param

L2_EPS = 1e-6            # q and k normalised as x * rsqrt(|x|^2 + L2_EPS)
INTRA_ELEMENTS = 1 << 27  # (chunk, chunk, K) decays built at once, at most


class KDAState(NamedTuple):
    """A KDA layer's decode cache, the batch first in every field."""
    s: torch.Tensor          # (B, H, K, V) float32
    conv_q: torch.Tensor     # (B, conv_size - 1, H*K): the last projections
    conv_k: torch.Tensor     # (B, conv_size - 1, H*K)
    conv_v: torch.Tensor     # (B, conv_size - 1, H*V)


class KDA(Params):
    """The mixer's parameters (see the module's docstring for names)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or dt(cfg.param_dtype)
        k = cfg.kda
        d, H, hd = cfg.d_model, k.num_heads, k.head_dim
        HK = H * hd
        for n in ("wq", "wk", "wv"):
            setattr(self, n, dense_init(gen, d, HK, dtype, device))
        for n in ("conv_q", "conv_k", "conv_v"):
            setattr(self, n, dense_init(gen, k.conv_size, HK, dtype, device))
        # the decay's and the gate's low-rank pairs, head_dim wide
        self.f_a = dense_init(gen, d, hd, dtype, device)
        self.f_b = dense_init(gen, hd, HK, dtype, device)
        self.w_beta = dense_init(gen, d, H, dtype, device)
        self.g_a = dense_init(gen, d, hd, dtype, device)
        self.g_b = dense_init(gen, hd, HK, dtype, device)
        self.g_bias = const((HK,), 0.0, dtype, device)
        self.o_norm = const((hd,), 1.0, dtype, device)
        self.wo = dense_init(gen, HK, d, dtype, device)
        # A = exp(A_log) uniform over [1, 16]; dt = softplus(dt_bias)
        # log-uniform over [1e-3, 1e-1] (the paper's code's initialisation)
        a_log = torch.empty((H,), dtype=torch.float32, device=device)
        dt_bias = torch.empty((HK,), dtype=torch.float32, device=device)
        if gen is not None:
            a_log = torch.log(a_log.uniform_(1.0, 16.0, generator=gen))
            dts = torch.exp(dt_bias.uniform_(generator=gen)
                            * math.log(100.0) + math.log(1e-3))
            dt_bias = dts + torch.log(-torch.expm1(-dts))
        self.A_log = param(a_log)
        self.dt_bias = param(dt_bias)


def init_kda_state(cfg: ModelConfig, batch: int, device) -> KDAState:
    k = cfg.kda
    HK = k.num_heads * k.head_dim
    tail = (batch, k.conv_size - 1, HK)
    dtype = dt(cfg.compute_dtype)
    return KDAState(
        s=torch.zeros((batch, k.num_heads, k.head_dim, k.head_dim),
                      dtype=torch.float32, device=device),
        conv_q=torch.zeros(tail, dtype=dtype, device=device),
        conv_k=torch.zeros(tail, dtype=dtype, device=device),
        conv_v=torch.zeros(tail, dtype=dtype, device=device))


def state_bytes(cfg: ModelConfig) -> int:
    """Bytes of one slot's float32 state in one layer."""
    k = cfg.kda
    return 4 * k.num_heads * k.head_dim * k.head_dim


def _short_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SiLU of the causal depthwise conv of x (B,L,C) with taps w (Kc,C),
    after the earlier inputs ``tail`` (B,Kc-1,C), in float32; and the new
    tail, the last Kc-1 inputs."""
    L = x.shape[1]
    xs = torch.cat([tail.to(x.dtype), x], dim=1)
    if L == 1:
        out = torch.einsum("bkc,kc->bc", xs.float(), w.float())[:, None]
    else:
        wf = w.float()
        out = sum(xs[:, i:i + L].float() * wf[i] for i in range(w.shape[0]))
    return F.silu(out), xs[:, L:]


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def _inputs(params, cfg: ModelConfig, x: torch.Tensor, state: KDAState):
    """(q̂ scaled by K^-1/2, k̂, v, g, β) float32 of x (B,L,D) and the new
    conv tails."""
    k = cfg.kda
    B, L, _ = x.shape
    H, hd = k.num_heads, k.head_dim
    q, tq = _short_conv(x @ params["wq"], params["conv_q"], state.conv_q)
    kk, tk = _short_conv(x @ params["wk"], params["conv_k"], state.conv_k)
    v, tv = _short_conv(x @ params["wv"], params["conv_v"], state.conv_v)
    q = _l2norm(q.view(B, L, H, hd)) * hd ** -0.5
    kk = _l2norm(kk.view(B, L, H, hd))
    f = ((x @ params["f_a"]) @ params["f_b"]).float().view(B, L, H, hd)
    g = -torch.exp(params["A_log"].float())[:, None] * F.softplus(
        f + params["dt_bias"].float().view(H, hd))
    beta = torch.sigmoid((x @ params["w_beta"]).float())
    return q, kk, v.view(B, L, H, hd), g, beta, (tq, tk, tv)


def _output(params, cfg: ModelConfig, x: torch.Tensor,
            o: torch.Tensor) -> torch.Tensor:
    """The gated, normed heads o (B,L,H,V) float32 through W_o."""
    B, L, H, hd = o.shape
    gate = torch.sigmoid(((x @ params["g_a"]) @ params["g_b"]
                          + params["g_bias"]).float()).view(B, L, H, hd)
    y = o * torch.rsqrt(o.square().mean(-1, keepdim=True) + cfg.norm_eps)
    y = y * params["o_norm"].float() * gate
    return y.to(x.dtype).reshape(B, L, H * hd) @ params["wo"]


def kda_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, beta: torch.Tensor,
                s0: Optional[torch.Tensor], chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over a whole sequence in closed form, a chunk at a
    time. q, k (B,T,H,K) (q scaled), v (B,T,H,V), g (B,T,H,K) <= 0 and
    beta (B,T,H), float32; s0 (B,H,K,V) or None (zeros). Returns o
    (B,T,H,V) and the state after the last token.

    In a chunk with state S0 before it and Γ_i = g_1 + ... + g_i:
    u = (I + L diag(β))^-1 (v - (e^Γ ⊙ k) S0) with L_ij = Σ_c k_ic k_jc
    e^(Γ_ic - Γ_jc), j < i; o = (e^Γ ⊙ q) S0 + P diag(β) u with P the
    same sum over q_i and k_j, j <= i; S = e^(Γ_C) ⊙ S0 + (e^(Γ_C - Γ)
    ⊙ k)ᵀ diag(β) u. The chunks' triangular systems are solved together
    up front, the state passes from chunk to chunk as S' = M S + c (one
    batched product a chunk), and the outputs follow at once. A
    sequence not a multiple of the chunk is padded with tokens that change
    nothing (k = v = q = 0, g = 0, β = 0)."""
    B, T, H, K = k.shape
    V = v.shape[-1]
    C, BH = chunk, B * H
    N = -(-T // C)
    pad = N * C - T

    def blocks(t):                  # (B,T,H,...) -> (N,B*H,C,...)
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape((B, N, C, H) + t.shape[3:]).movedim(3, 1)
        return t.reshape((BH, N, C) + t.shape[4:]).transpose(0, 1)
    q, k, v, g = (blocks(t) for t in (q, k, v, g))
    beta = blocks(beta[..., None])                       # (N,BH,C,1)
    G = g.cumsum(-2)                                     # (N,BH,C,K)
    # inside a chunk k_i·k_j and q_i·k_j weighed by e^(Γ_i - Γ_j), i >= j:
    # the (C, C, K) decays of a few chunks at a time, clamped at 0 where
    # j > i (masked after the product), each product one batched matmul
    kq = torch.stack([k, q], dim=-2)                     # (N,BH,C,2,K)
    a = torch.empty((N, BH, C, 2, C), dtype=k.dtype, device=k.device)
    step = max(1, INTRA_ELEMENTS // (BH * C * C * K))
    for n0 in range(0, N, step):
        sl = slice(n0, n0 + step)
        e = (G[sl, :, :, None, :] - G[sl, :, None, :, :]).clamp_(max=0.0)
        e = e.exp_().mul_(k[sl, :, None, :, :])          # k_j e^(Γ_i - Γ_j)
        torch.matmul(kq[sl], e.transpose(-1, -2), out=a[sl])
        del e
    lower = torch.ones((C, C), dtype=torch.bool, device=k.device).tril()
    a_kk = a[..., 0, :].masked_fill(lower.logical_not().logical_or(
        torch.eye(C, dtype=torch.bool, device=k.device)), 0.0)
    a_qk = a[..., 1, :].masked_fill(~lower, 0.0)
    del a, kq
    # β ⊙ u = (I + diag(β) L)^-1 (β ⊙ (v - (e^Γ ⊙ k) S0)) = p_v - p_k S0
    eye = torch.eye(C, dtype=k.dtype, device=k.device)
    w = torch.linalg.solve_triangular(
        a_kk * beta + eye, torch.cat([beta * v, beta * k * torch.exp(G)], -1),
        upper=False, unitriangular=True)
    p_v, p_k = w[..., :V], w[..., V:]
    # the state from chunk to chunk is linear in it: S' = M S + c, with
    # M = Diag(e^(Γ_C)) - k_endᵀ p_k and c = k_endᵀ p_v; one product a chunk
    k_end = (k * torch.exp(G[..., -1:, :] - G)).transpose(-1, -2)
    m = torch.diag_embed(torch.exp(G[..., -1, :])) - k_end @ p_k
    c = k_end @ p_v
    s = torch.empty((N + 1, BH, K, V), dtype=k.dtype, device=k.device)
    if s0 is None:
        s[0].zero_()
    else:
        s[0].copy_(s0.reshape(BH, K, V))
    for n in range(N):
        torch.baddbmm(c[n], m[n], s[n], out=s[n + 1])
    # then every chunk's outputs at once from the state before it
    s_in = s[:N]
    out = (q * torch.exp(G)) @ s_in + a_qk @ (p_v - p_k @ s_in)
    out = out.transpose(0, 1).reshape(B, H, N * C, V).transpose(1, 2)
    return out[:, :T], s[N].reshape(B, H, K, V)


def kda_prefill(params, cfg: ModelConfig, x: torch.Tensor, ctx=None
                ) -> Tuple[torch.Tensor, KDAState]:
    """The mixer over whole sequences x (B,L,D) from a zero state: the
    output (B,L,D) and the decode cache after the last token."""
    if ctx is not None:
        raise ValueError("a KDA layer is not served over a mesh")
    zero = init_kda_state(cfg, x.shape[0], x.device)
    q, k, v, g, beta, tails = _inputs(params, cfg, x, zero)
    o, s = kda_chunked(q, k, v, g, beta, None, cfg.kda.chunk)
    return _output(params, cfg, x, o), KDAState(s, *tails)


def kda_decode(params, cfg: ModelConfig, x: torch.Tensor, state: KDAState,
               ctx=None) -> Tuple[torch.Tensor, KDAState]:
    """One token of every slot, x (B,1,D): the output (B,1,D) and the
    cache, advanced in place. With α = exp(g): u = v - Sᵀ(α ⊙ k̂) and
    o = Sᵀ(α ⊙ q̂) + β (k̂·q̂) u from one read of S, then S <- α ⊙ S +
    β k̂ uᵀ."""
    if ctx is not None:
        raise ValueError("a KDA layer is not served over a mesh")
    B = x.shape[0]
    H, hd = cfg.kda.num_heads, cfg.kda.head_dim
    q, k, v, g, beta, tails = _inputs(params, cfg, x, state)
    q, k, v, g, beta = q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0]
    a = torch.exp(g)                                     # (B,H,K)
    s = state.s.view(B * H, hd, hd)
    r = torch.stack([a * k, a * q], dim=2).view(B * H, 2, hd) @ s
    bu = beta[..., None] * (v - r[:, 0].view(B, H, hd))
    o = r[:, 1].view(B, H, hd) + (k * q).sum(-1, keepdim=True) * bu
    s.mul_(a.view(B * H, hd, 1)).baddbmm_(k.reshape(B * H, hd, 1),
                                          bu.reshape(B * H, 1, hd))
    for dst, src in zip((state.conv_q, state.conv_k, state.conv_v), tails):
        dst.copy_(src)
    return _output(params, cfg, x, o[:, None]), state
