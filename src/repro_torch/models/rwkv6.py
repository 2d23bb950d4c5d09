"""RWKV6 "Finch" block: time-mix (the WKV6 recurrence with data-dependent
per-channel decay) and channel-mix FFN.

Counterpart of ``repro.models.rwkv6``. Recurrence per head (key dim N,
value dim N):

    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
    o_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])

with w_t = exp(-exp(w0 + lora_w(x))) in (0,1), data-dependent, float32.

  * ``rwkv6_time_mix`` on a whole sequence from a zero state (prefill and
    forward) goes through `repro_torch.kernels.ops.rwkv6_wkv`: the
    hand-written kernel on CUDA tensors, its plain version on the CPU; with
    ``use_kernels=False`` (training: the kernel has no backward) through
    ``wkv_chunked``, as the reference's time-mix runs it.
  * ``wkv_naive`` / ``wkv_chunked``: the reference's two forms in plain
    PyTorch, both with an initial state ``s0``. ``wkv_naive`` is the decode
    step; ``wkv_chunked`` keeps the reference's rounding of the intra-chunk
    scores to r's type and its chunk shrunk to a divisor of L. A chunked
    call with ``s0`` on CUDA lies on no path and no kernel takes a state,
    so it raises.
  * ``rwkv6_decode``: the single-token time-mix on the carried state.

Over a mesh (``ctx``) the time-mix runs on this rank's batch rows and,
where the heads divide tp, on its block of heads: the reference shards v,
w and the state over tp on the value channels; here the split is by whole
heads (each head's recurrence is independent, so the sums are the same),
which keeps the recurrence, the bonus and the state of a head on one rank.
r, k and the decay come from the column blocks of their whole weights, v
and g from their tp blocks, the RMSNorm ``ln_x`` over all of D has its mean
of squares summed over tp, and ``wo``'s row block gives a part summed over
tp. The channel-mix runs its hidden block and sums it over tp. The
prefill's state comes back whole (gathered over tp).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import fsdp_gather, tp_part, tp_whole
from repro_torch.kernels import ops
from repro_torch.models.layers import (Params, RMSNorm, const, dense_init, dt,
                                       param, rmsnorm, tp_region)


class RWKVState(NamedTuple):
    s: torch.Tensor          # (B, H, N, N) float32 wkv state
    x_tm: torch.Tensor       # (B, D) previous token (time-mix shift)
    x_cm: torch.Tensor       # (B, D) previous token (channel-mix shift)
    length: torch.Tensor     # (B,) int32


# ---------------------------------------------------------------------------
# WKV core in plain PyTorch
# ---------------------------------------------------------------------------

def _zero_state(r: torch.Tensor) -> torch.Tensor:
    B, _, H, N = r.shape
    return torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)


def wkv_naive(r, k, v, w, u, s0=None):
    """The recurrence, step by step. r/k/v/w (B,L,H,N); u (H,N). Returns
    (out in r's type, s float32)."""
    s = _zero_state(r) if s0 is None else s0
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhi,bhj->bhij", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf * kv))
        s = wf[:, t, ..., None] * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = 16):
    """The reference's chunk-parallel form, same signature as
    :func:`wkv_naive`: the chunk shrinks to a divisor of L, and the
    intra-chunk scores are rounded to r's type before their product with
    v, as the reference does."""
    B, L, H, N = r.shape
    Q = min(chunk, L)
    while L % Q:
        Q -= 1
    cdt = r.dtype
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      -1)
    s = _zero_state(r) if s0 is None else s0
    outs = []
    for c0 in range(0, L, Q):
        r_c, k_c, v_c = r[:, c0:c0 + Q], k[:, c0:c0 + Q], v[:, c0:c0 + Q]
        lw = torch.log(torch.clamp(w[:, c0:c0 + Q].float(), min=1e-20))
        lcum = torch.cumsum(lw, dim=1)                   # inclusive (B,Q,H,N)
        lprev = lcum - lw                                # exclusive
        diff = lprev[:, :, None] - lcum[:, None, :]      # (B,Q,Q,H,N)
        pair = torch.where(mask[None, :, :, None, None], torch.exp(diff), 0.0)
        scores = torch.einsum("bqhi,bqjhi,bjhi->bqjh", r_c.float(), pair,
                              k_c.float())
        o = torch.einsum("bqjh,bjhn->bqhn", scores.to(cdt), v_c).float()
        bonus = torch.einsum("bqhi,hi,bqhi->bqh", r_c.float(), u.float(),
                             k_c.float())
        o = o + bonus[..., None] * v_c.float()
        o = o + torch.einsum("bqhi,bhin->bqhn", r_c.float() * torch.exp(lprev),
                             s)
        decay_to_end = torch.exp(lcum[:, -1:] - lcum)
        s = s * torch.exp(lcum[:, -1])[..., None] + torch.einsum(
            "bqhi,bqhn->bhin", k_c.float() * decay_to_end, v_c.float())
        outs.append(o.to(cdt))
    return torch.cat(outs, dim=1), s


# ---------------------------------------------------------------------------
# block parameters
# ---------------------------------------------------------------------------

class RWKV6(Params):
    """Time-mix and channel-mix parameters of one block, with the names and
    layouts of the reference's ``init_rwkv6``. ``w0`` and ``u`` are float32
    whatever the parameter type."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = cfg.rwkv
        dtype = dtype or dt(cfg.param_dtype)
        D, N = cfg.d_model, c.head_dim
        H = D // N
        f32 = torch.float32
        # token-shift lerp bases for r, k, v, w, g (+ low-rank data part)
        self.mu = const((5, D), 0.5, dtype, device)
        self.mix_a = dense_init(gen, D, 5 * c.mix_lora, dtype, device)
        mix_b = torch.empty((5, c.mix_lora, D), dtype=f32, device=device)
        if gen is not None:
            mix_b.normal_(generator=gen)
        self.mix_b = param((mix_b * 0.01).to(dtype))
        self.wr = dense_init(gen, D, D, dtype, device)
        self.wk = dense_init(gen, D, D, dtype, device)
        self.wv = dense_init(gen, D, D, dtype, device)
        self.wg = dense_init(gen, D, D, dtype, device)
        self.wo = dense_init(gen, D, D, dtype, device)
        # data-dependent decay: w = exp(-exp(w0 + b(tanh(a(x)))))
        self.w0 = const((D,), -4.0, f32, device)
        self.decay_a = dense_init(gen, D, c.decay_lora, dtype, device)
        self.decay_b = dense_init(gen, c.decay_lora, D, dtype, device,
                                  scale=0.1)
        self.u = const((H, N), 0.5, f32, device)          # current-step bonus
        self.ln_x = RMSNorm(D, dtype, device)   # rmsnorm over all of D
        # channel-mix
        self.cm_mu = const((2, D), 0.5, dtype, device)
        self.cm_k = dense_init(gen, D, cfg.d_ff, dtype, device)
        self.cm_v = dense_init(gen, cfg.d_ff, D, dtype, device)
        self.cm_r = dense_init(gen, D, D, dtype, device)


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig) -> RWKV6:
    return RWKV6(cfg, gen, gen.device)


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Shifted sequence: position t sees token t-1. x (B,L,D); x_prev
    (B,D)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix_inputs(params, x: torch.Tensor, xs: torch.Tensor):
    """Data-dependent lerp between x and shifted x for r, k, v, w, g."""
    delta = xs - x                                       # (B,L,D)
    B, L, _ = x.shape
    low = torch.tanh(delta @ params["mix_a"]).reshape(B, L, 5, -1)
    return [x + delta * (params["mu"][i] + low[:, :, i] @ params["mix_b"][i])
            for i in range(5)]                           # r, k, v, w, g inputs


def rwkv6_time_mix(params, cfg: ModelConfig, x: torch.Tensor,
                   x_prev: torch.Tensor, s0: Optional[torch.Tensor] = None,
                   use_chunked: bool = True, use_kernels: bool = True,
                   ctx=None, whole_state: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time-mix. x (B,L,D); x_prev (B,D) the last token of the previous
    segment. Returns (out, s_final, x_last). ``use_chunked`` with no ``s0``
    is the kernel's call, unless ``use_kernels=False`` asks for
    :func:`wkv_chunked`; ``use_chunked=False`` the step recurrence. Over a
    mesh (from a zero state), x is the residual's local block and so is the
    output; s_final is gathered whole when ``whole_state``."""
    if ctx is None:
        return _time_mix(params, cfg, x, x_prev, s0, use_chunked,
                         use_kernels, lambda p, y: rmsnorm(p, y,
                                                           cfg.norm_eps))
    N, D = cfg.rwkv.head_dim, cfg.d_model
    H, tp = D // N, ctx.tp_size
    params = fsdp_gather(params, cfg, ctx)
    split = H % tp == 0 and tp > 1
    fn = tp_part if split else tp_whole
    p = {**params, **{n: fn(ctx, params[n], d, f) for n, (d, f) in {
        "wr": (1, D), "wk": (1, D), "wv": (1, D), "wg": (1, D),
        "wo": (0, D), "w0": (0, D), "decay_b": (1, D), "u": (0, H)}.items()}}
    p["ln_x"] = {"scale": fn(ctx, params["ln_x"]["scale"], 0, D)}

    def norm(pn, y):
        # RMSNorm over all of D: the mean of squares summed over tp
        ss = torch.sum(torch.square(y), dim=-1, keepdim=True,
                       dtype=torch.float32)
        inv = torch.rsqrt(ctx.psum(ss, ctx.tp_axis) / D
                          + cfg.norm_eps).to(y.dtype)
        return y * inv * pn["scale"].to(y.dtype)

    def region(h):
        return _time_mix(p, cfg, h, x_prev, s0, use_chunked, use_kernels,
                         norm if split else
                         (lambda pn, y: rmsnorm(pn, y, cfg.norm_eps)))
    out, s_final, x_last = tp_region(ctx, (region, split), x)
    if split and whole_state:
        s_final = ctx.gather(s_final, None, ctx.tp_axis)
    return out, s_final, x_last


def _time_mix(params, cfg: ModelConfig, x: torch.Tensor,
              x_prev: torch.Tensor, s0: Optional[torch.Tensor],
              use_chunked: bool, use_kernels: bool, norm):
    """The time-mix on the heads of the r, k, v, g, decay and ``wo`` blocks
    it is given (a tp rank's, or all); ``norm(params, y)`` is ``ln_x``."""
    N = cfg.rwkv.head_dim
    B, L, _ = x.shape
    H = params["wr"].shape[1] // N
    xs = _token_shift(x, x_prev)
    xr, xk, xv, xw, xg = _time_mix_inputs(params, x, xs)
    r = (xr @ params["wr"]).reshape(B, L, H, N)
    k = (xk @ params["wk"]).reshape(B, L, H, N)
    v = (xv @ params["wv"]).reshape(B, L, H, N)
    g = F.silu(xg @ params["wg"])
    dlow = torch.tanh(xw @ params["decay_a"])
    dlog = params["w0"] + (dlow @ params["decay_b"]).float()
    w = torch.exp(-torch.exp(dlog)).reshape(B, L, H, N)  # (0,1) decay, f32
    u = params["u"].contiguous()
    if not use_chunked:
        out, s_final = wkv_naive(r, k, v, w, u, s0)
    elif s0 is None and use_kernels:
        out, s_final = ops.rwkv6_wkv(r, k, v, w, u)
    elif x.device.type == "cuda" and use_kernels:
        raise NotImplementedError(
            "a chunked WKV from a carried state has no kernel: the CUDA "
            "kernel, like the TPU one, starts from a zero state")
    else:
        out, s_final = wkv_chunked(r, k, v, w, u, s0)
    out = norm(params["ln_x"], out.reshape(B, L, H * N)) * g
    return out @ params["wo"], s_final, x[:, -1, :]


def rwkv6_channel_mix(params, x: torch.Tensor, x_prev: torch.Tensor,
                      ctx=None, cfg: Optional[ModelConfig] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-mix FFN with token shift. Returns (out, x_last). Over a mesh
    (``ctx``, with ``cfg``), x is the residual's local block and so is the
    output: the hidden dim splits over tp where it divides, its product
    summed over tp before the receptance gate."""
    if ctx is None:
        return _channel_mix(params, x, x_prev, None)
    params = fsdp_gather(params, cfg, ctx)
    F_ = cfg.d_ff
    split = F_ % ctx.tp_size == 0 and ctx.tp_size > 1
    fn = tp_part if split else tp_whole
    p = {**params, "cm_k": fn(ctx, params["cm_k"], 1, F_),
         "cm_v": fn(ctx, params["cm_v"], 0, F_)}
    return tp_region(ctx, (lambda h: _channel_mix(
        p, h, x_prev, ctx if split else None), False), x)


def _channel_mix(params, x: torch.Tensor, x_prev: torch.Tensor, ctx):
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * params["cm_mu"][0]
    xr = x + (xs - x) * params["cm_mu"][1]
    kv = torch.square(F.relu(xk @ params["cm_k"])) @ params["cm_v"]
    if ctx is not None:
        kv = ctx.psum(kv, ctx.tp_axis)
    return torch.sigmoid(xr @ params["cm_r"]) * kv, x[:, -1, :]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> RWKVState:
    N = cfg.rwkv.head_dim
    D = cfg.d_model
    dtype = dt(cfg.compute_dtype)
    return RWKVState(
        s=torch.zeros((batch, D // N, N, N), dtype=torch.float32,
                      device=device),
        x_tm=torch.zeros((batch, D), dtype=dtype, device=device),
        x_cm=torch.zeros((batch, D), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def rwkv6_decode(params, cfg: ModelConfig, x: torch.Tensor,
                 state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    """Single-token time-mix on the carried state. x (B,1,D), the normed
    block input. Returns (time-mix out, the state with s, x_tm and length
    advanced); the caller applies channel-mix with ``x_cm``."""
    out, s_final, x_last = rwkv6_time_mix(params, cfg, x, state.x_tm,
                                          s0=state.s, use_chunked=False)
    return out, state._replace(s=s_final, x_tm=x_last,
                               length=state.length + 1)
