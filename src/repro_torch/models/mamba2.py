"""Mamba2 (SSD, state-space duality) block, zamba2-style.

Counterpart of ``repro.models.mamba2``. The projections stay split (z, x, B,
C, dt as separate matrices), as in the reference. Shapes: x (B,L,H,P); B/C
(B,L,G,N) with H = G*HG heads, HG per group; state h (B,G,HG,P,N);
log-decay a_t = dt_t * A_h with A negative.

  * ``mamba2_block`` / ``mamba2_prefill``: the full-sequence mixer, whose
    scan goes through `repro_torch.kernels.ops.mamba2_scan` (the
    hand-written kernel on CUDA tensors, its plain version on the CPU). The
    kernel takes any L in chunks of ``cfg.ssm.chunk`` with a short last one;
    the reference shrinks the chunk to a divisor of L. With
    ``use_kernels=False`` (training: the kernel has no backward) the scan is
    the reference's ``ssd_chunked`` at ``pick_chunk``, as its
    ``mamba2_block`` runs it.
  * ``ssd_naive`` / ``ssd_chunked``: the reference's two scans in plain
    PyTorch (the recurrence, and the chunked form with its rounding of the
    intra-chunk weights to x's type).
  * ``mamba2_decode``: the single-token step on the carried state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (Params, RMSNorm, const, dense_init, dt,
                                       param, rmsnorm)


class SSMState(NamedTuple):
    h: torch.Tensor          # (B, G, HG, P, N) float32
    conv_x: torch.Tensor     # (B, d_conv-1, d_inner) conv tail for x
    conv_B: torch.Tensor     # (B, d_conv-1, G*N)
    conv_C: torch.Tensor     # (B, d_conv-1, G*N)
    length: torch.Tensor     # (B,) int32


# ---------------------------------------------------------------------------
# core SSD in plain PyTorch
# ---------------------------------------------------------------------------

def ssd_naive(x, dt_, A, Bm, Cm, h0=None):
    """The recurrence, step by step. x (B,L,G,HG,P), dt (B,L,G,HG), A (G,HG),
    B/C (B,L,G,N). Returns (y in x's type, h_final float32)."""
    B, L, G, HG, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, G, HG, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    xf, dtf, Bf, Cf = x.float(), dt_.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(L):
        da = torch.exp(dtf[:, t] * A)
        h = h * da[..., None, None] + torch.einsum(
            "bgh,bghp,bgn->bghpn", dtf[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bghpn,bgn->bghp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked(x, dt_, A, Bm, Cm, h0=None, chunk: int = 128):
    """The reference's chunked SSD, same signature as :func:`ssd_naive`; L
    must be a multiple of the chunk. The intra-chunk weights are rounded to
    x's type before their product with x, as the reference does."""
    B, L, G, HG, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"seq {L} not divisible by chunk {Q}")
    f32 = torch.float32
    cdt = x.dtype
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = torch.zeros((B, G, HG, P, N), dtype=f32, device=x.device) \
        if h0 is None else h0
    ys = []
    for c0 in range(0, L, Q):
        x_c, B_c, C_c = x[:, c0:c0 + Q], Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        dt_c = dt_[:, c0:c0 + Q].float()
        cum = torch.cumsum(dt_c * A.float(), dim=1)           # (B,Q,G,HG)
        diff = cum[:, :, None] - cum[:, None, :]              # (B,Q,Q,G,HG)
        Lmat = torch.where(mask[None, :, :, None, None], torch.exp(diff), 0.0)
        Gmat = torch.einsum("bqgn,bkgn->bqkg", C_c, B_c)
        M = (Gmat[..., None].float() * Lmat * dt_c[:, None]).to(cdt)
        y = torch.einsum("bqkgh,bkghp->bqghp", M, x_c).float()
        y = y + torch.einsum("bqgn,bghpn->bqghp", C_c.float(), h) \
            * torch.exp(cum)[..., None]
        decay_to_end = torch.exp(cum[:, -1:] - cum)
        S = torch.einsum("bqgn,bqgh,bqghp->bghpn", B_c.float(),
                         dt_c * decay_to_end, x_c.float())
        h = h * torch.exp(cum[:, -1])[..., None, None] + S
        ys.append(y.to(cdt))
    return torch.cat(ys, dim=1).to(x.dtype), h


def pick_chunk(L: int, chunk: int) -> int:
    """Largest chunk size <= ``chunk`` that divides L."""
    c = min(chunk, L)
    while L % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.n_groups


class Mamba2(Params):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, dtype: Optional[torch.dtype] = None):
        super().__init__()
        s = cfg.ssm
        dtype = dtype or dt(cfg.param_dtype)
        d_inner, H, G = _dims(cfg)
        GN = G * s.d_state
        d = cfg.d_model
        self.in_z = dense_init(gen, d, d_inner, dtype, device)
        self.in_x = dense_init(gen, d, d_inner, dtype, device)
        self.in_B = dense_init(gen, d, GN, dtype, device)
        self.in_C = dense_init(gen, d, GN, dtype, device)
        self.in_dt = dense_init(gen, d, H, dtype, device)
        self.conv_x = self._conv(gen, s.d_conv, d_inner, dtype, device)
        self.conv_bx = const((d_inner,), 0.0, dtype, device)
        self.conv_B = self._conv(gen, s.d_conv, GN, dtype, device)
        self.conv_bB = const((GN,), 0.0, dtype, device)
        self.conv_C = self._conv(gen, s.d_conv, GN, dtype, device)
        self.conv_bC = const((GN,), 0.0, dtype, device)
        f32 = torch.float32
        dt0 = torch.empty((H,), dtype=f32, device=device)
        if gen is not None:
            lo, hi = torch.log(torch.tensor([s.dt_min, s.dt_max]))
            dt0 = torch.exp(torch.rand((H,), generator=gen, device=device)
                            * (hi - lo) + lo)
        self.dt_bias = param(dt0 + torch.log(-torch.expm1(-dt0)))
        self.A_log = param(torch.log(torch.arange(1, H + 1, dtype=f32,
                                                  device=device)))
        self.D = const((H,), 1.0, f32, device)
        self.norm = RMSNorm(d_inner, dtype, device)
        self.out_proj = dense_init(gen, d_inner, d, dtype, device)

    @staticmethod
    def _conv(gen, K: int, channels: int, dtype, device):
        w = torch.empty((K, channels), dtype=torch.float32, device=device)
        if gen is not None:
            w.normal_(generator=gen)
        return param((w * 0.1).to(dtype))


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> Mamba2:
    return Mamba2(cfg, gen, gen.device)


def _causal_conv(xs: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d + silu. xs (B,L,C), w (K,C)."""
    K, L = w.shape[0], xs.shape[1]
    pad = F.pad(xs, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu(out + b)


def mamba2_prefill(params, cfg: ModelConfig, u: torch.Tensor,
                   use_kernels: bool = True
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence mixer, u (B,L,D) -> (B,L,D), and the SSM state (final
    h and conv tails) for decode. The scan runs on the kernel op, or with
    ``use_kernels=False`` as :func:`ssd_chunked`."""
    s = cfg.ssm
    B, L, _ = u.shape
    d_inner, H, G = _dims(cfg)
    K = s.d_conv - 1
    z = u @ params["in_z"]
    xp, Bp, Cp = u @ params["in_x"], u @ params["in_B"], u @ params["in_C"]
    x = _causal_conv(xp, params["conv_x"], params["conv_bx"])
    Bm = _causal_conv(Bp, params["conv_B"], params["conv_bB"])
    Cm = _causal_conv(Cp, params["conv_C"], params["conv_bC"])
    dt_ = F.softplus((u @ params["in_dt"]).float() + params["dt_bias"])
    x = x.reshape(B, L, H, s.head_dim)
    A = -torch.exp(params["A_log"])
    Bm, Cm = Bm.reshape(B, L, G, s.d_state), Cm.reshape(B, L, G, s.d_state)
    if use_kernels:
        y, h = ops.mamba2_scan(x, dt_, A, Bm, Cm, chunk=s.chunk)
    else:
        HG = H // G
        y, h = ssd_chunked(x.reshape(B, L, G, HG, s.head_dim),
                           dt_.reshape(B, L, G, HG), A.reshape(G, HG), Bm,
                           Cm, chunk=pick_chunk(L, s.chunk))
        y = y.reshape(B, L, H, s.head_dim)
    y = y + x * params["D"][None, None, :, None].to(y.dtype)
    y = rmsnorm(params["norm"], y.reshape(B, L, d_inner) * F.silu(z),
                cfg.norm_eps)
    out = y @ params["out_proj"]
    cdt = dt(cfg.compute_dtype)

    def tail(a):
        return (F.pad(a, (0, 0, K - L, 0)) if L < K else a[:, L - K:]) \
            .to(cdt)
    state = SSMState(h=h.reshape(B, G, H // G, s.head_dim, s.d_state),
                     conv_x=tail(xp), conv_B=tail(Bp), conv_C=tail(Cp),
                     length=torch.full((B,), L, dtype=torch.int32,
                                       device=u.device))
    return out, state


def mamba2_block(params, cfg: ModelConfig, u: torch.Tensor,
                 use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence Mamba2 mixer. u: (B,L,D) -> (B,L,D)."""
    return mamba2_prefill(params, cfg, u, use_kernels)[0]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_ssm_state(cfg: ModelConfig, batch: int, device) -> SSMState:
    s = cfg.ssm
    d_inner, H, G = _dims(cfg)
    dtype = dt(cfg.compute_dtype)
    K = s.d_conv - 1

    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return SSMState(h=zeros(batch, G, H // G, s.head_dim, s.d_state,
                            dtype=torch.float32),
                    conv_x=zeros(batch, K, d_inner),
                    conv_B=zeros(batch, K, G * s.d_state),
                    conv_C=zeros(batch, K, G * s.d_state),
                    length=zeros(batch, dtype=torch.int32))


def _conv_step(tail: torch.Tensor, cur: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """One-token depthwise conv: tail (B,K-1,C), cur (B,C)."""
    window = torch.cat([tail, cur[:, None, :]], dim=1)
    out = F.silu(torch.einsum("bkc,kc->bc", window, w.to(cur.dtype)) + b)
    return out, window[:, 1:, :]


def mamba2_decode(params, cfg: ModelConfig, u: torch.Tensor,
                  state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """Single-token step. u: (B,1,D)."""
    s = cfg.ssm
    B = u.shape[0]
    d_inner, H, G = _dims(cfg)
    HG = H // G
    u0 = u[:, 0]
    z = u0 @ params["in_z"]
    x, cx = _conv_step(state.conv_x, u0 @ params["in_x"], params["conv_x"],
                       params["conv_bx"])
    Bm, cB = _conv_step(state.conv_B, u0 @ params["in_B"], params["conv_B"],
                        params["conv_bB"])
    Cm, cC = _conv_step(state.conv_C, u0 @ params["in_C"], params["conv_C"],
                        params["conv_bC"])
    dt_ = F.softplus((u0 @ params["in_dt"]).float()
                     + params["dt_bias"]).reshape(B, G, HG)
    x = x.reshape(B, G, HG, s.head_dim).float()
    Bm = Bm.reshape(B, G, s.d_state).float()
    Cm = Cm.reshape(B, G, s.d_state).float()
    A = -torch.exp(params["A_log"]).reshape(G, HG)
    h = state.h * torch.exp(dt_ * A)[..., None, None] \
        + torch.einsum("bgh,bghp,bgn->bghpn", dt_, x, Bm)
    y = torch.einsum("bghpn,bgn->bghp", h, Cm)
    y = y + x * params["D"].reshape(G, HG)[None, :, :, None]
    y = y.reshape(B, 1, d_inner).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z[:, None, :]), cfg.norm_eps)
    return y @ params["out_proj"], SSMState(h, cx, cB, cC, state.length + 1)
