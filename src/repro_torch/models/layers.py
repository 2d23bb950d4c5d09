"""Shared model layers: norms, rotary embeddings, SwiGLU MLP, embeddings.

Counterpart of ``repro.models.layers``. A layer is an ``nn.Module`` whose
parameters carry the reference package's names and layouts (a dense weight
is ``(in, out)``, as in the JAX parameter tree), plus a function that
applies it. Parameters are made on an explicit device in an explicit type,
drawn from a ``torch.Generator`` the caller seeded; with no generator they
are left uninitialised for `repro_torch.models.convert` to fill. The port
serves only, so no parameter requires a gradient.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def dt(name: str) -> torch.dtype:
    """The torch dtype of a config's type name (``"bfloat16"``...)."""
    return getattr(torch, name)


class Params(nn.Module):
    """An ``nn.Module`` whose parameters and submodules also read as
    ``p["name"]`` and answer ``"name" in p``, so that the layer functions
    read the same on a module as on a plain dict of tensors (the per-site
    LoRA-adjusted attention weights of the zamba stack are such a dict)."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _trunc_normal(gen: Optional[torch.Generator], shape: Sequence[int],
                  device) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if gen is not None:
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w


def dense_init(gen: Optional[torch.Generator], in_dim: int, out_dim: int,
               dtype: torch.dtype, device, scale: float = 1.0) -> nn.Parameter:
    """Truncated-normal fan-in init, ``(in_dim, out_dim)``; uninitialised
    when ``gen`` is None."""
    if gen is None:
        return param(torch.empty((in_dim, out_dim), dtype=dtype,
                                 device=device))
    w = _trunc_normal(gen, (in_dim, out_dim), device)
    return param((w * (scale / math.sqrt(in_dim))).to(dtype))


def embed_init(gen: Optional[torch.Generator], vocab: int, dim: int,
               dtype: torch.dtype, device) -> nn.Parameter:
    if gen is None:
        return param(torch.empty((vocab, dim), dtype=dtype, device=device))
    return param((_trunc_normal(gen, (vocab, dim), device) * 0.02).to(dtype))


def const(shape: Sequence[int], value: float, dtype: torch.dtype,
          device) -> nn.Parameter:
    return param(torch.full(tuple(shape), value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(Params):
    def __init__(self, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = const((dim,), 1.0, dtype, device)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: the square in the input type, its mean in float32, the
    elementwise product in the input type (as the reference does, which
    matters in bf16)."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def rmsnorm_nohead(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Per-head qk-norm (qwen3): normalize the trailing head_dim in fp32."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary embedding (fp32)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """RoPE in the split-half layout. x: (..., seq, heads, head_dim);
    positions: (..., seq)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(Params):
    def __init__(self, gen, d_model: int, d_ff: int, dtype: torch.dtype,
                 device):
        super().__init__()
        self.w_gate = dense_init(gen, d_model, d_ff, dtype, device)
        self.w_up = dense_init(gen, d_model, d_ff, dtype, device)
        self.w_down = dense_init(gen, d_ff, d_model, dtype, device)


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    hidden = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return hidden @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embedding(Params):
    def __init__(self, gen, vocab: int, d_model: int, dtype: torch.dtype,
                 device):
        super().__init__()
        self.table = embed_init(gen, vocab, d_model, dtype, device)


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]
