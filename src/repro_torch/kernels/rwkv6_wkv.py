"""Chunked RWKV6 WKV recurrence: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``repro.kernels.rwkv6_wkv`` (the Pallas TPU kernel) and
``repro.kernels.rwkv6_wkv_ref`` (its oracle, the step-by-step recurrence
``o_t = r_t (S + u k_t^T v_t)``, ``S = diag(w_t) S + k_t^T v_t`` from a zero
state). r/k/v (B,L,H,N) in one type, w (B,L,H,N) and u (H,N) float32 ->
out (B,L,H,N) in r's type and the final state s (B,H,N,N) in float32.

:func:`rwkv6_wkv` is the wrapper. On a CUDA tensor it launches the
hand-written kernel ``csrc/rwkv6_wkv.cu`` (built for sm_90a at first use,
see `repro_torch.kernels._build`) or raises; on a CPU tensor it runs
:func:`reference`. ``rwkv6_wkv.launches`` counts kernel launches.

Both take any L: the last chunk may be short (the TPU wrapper shrank its
chunk to a divisor of L). Both read the exclusive log-decay sum ``lprev[q]``
as ``lcum[q-1]`` itself, where the TPU kernel computes ``lcum - lw``. The
source note in ``csrc/rwkv6_wkv.cu`` says what bounds the kernel and what
its design does about it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

CHUNK = 32
MAX_CHUNK = 64
MAX_N = 64
_SYMBOLS = {torch.float32: "rwkv6_wkv_f32",
            torch.bfloat16: "rwkv6_wkv_bf16"}


def reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, chunk: int = CHUNK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the kernel's chunked log-space arithmetic in fp32,
    one chunk at a time (the last one may be short). Every exponent it takes
    is <= 0. Returns (out in r's type, s_final (B,H,N,N) float32)."""
    B, L, H, N = r.shape
    rf, kf, vf, uf = r.float(), k.float(), v.float(), u.float()
    lw_all = torch.log(torch.clamp(w.float(), min=1e-20))
    s = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    outs = []
    for c0 in range(0, L, chunk):
        rc, kc, vc = rf[:, c0:c0 + chunk], kf[:, c0:c0 + chunk], \
            vf[:, c0:c0 + chunk]
        lcum = torch.cumsum(lw_all[:, c0:c0 + chunk], dim=1)   # (B,Q,H,N)
        lprev = F.pad(lcum, (0, 0, 0, 0, 1, 0))[:, :-1]        # lcum[q-1]
        Q = rc.shape[1]
        before = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                       device=r.device), -1)
        # exp only where j < q, where the exponent is <= 0
        diff = (lprev[:, :, None] - lcum[:, None, :]).masked_fill(
            ~before[None, :, :, None, None], float("-inf"))   # (B,Q,Q,H,N)
        scores = torch.einsum("bqhi,bqjhi,bjhi->bqjh", rc, torch.exp(diff),
                              kc)
        o = torch.einsum("bqjh,bjhn->bqhn", scores, vc)
        bonus = torch.einsum("bqhi,hi,bqhi->bqh", rc, uf, kc)
        o = o + bonus[..., None] * vc
        o = o + torch.einsum("bqhi,bhin->bqhn", rc * torch.exp(lprev), s)
        to_end = torch.exp(lcum[:, -1:] - lcum)
        s = s * torch.exp(lcum[:, -1])[..., None] \
            + torch.einsum("bqhi,bqhn->bhin", kc * to_end, vc)
        outs.append(o)
    return torch.cat(outs, dim=1).to(r.dtype), s


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError(f"expected r/k/v/w (B,L,H,N) and u (H,N), got r "
                         f"{tuple(r.shape)}, u {tuple(u.shape)}")
    if not (k.shape == v.shape == w.shape == r.shape) \
            or u.shape != r.shape[2:]:
        raise ValueError(f"shapes do not match r {tuple(r.shape)}: k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}")
    if r.dtype not in _SYMBOLS or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"w and u must be float32, got {w.dtype}, {u.dtype}")
    devices = {t.device for t in (r, k, v, w, u)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, chunk: int = CHUNK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v (B,L,H,N) in one type (float32 or bfloat16), w (B,L,H,N) and u
    (H,N) float32, all on one device -> (out (B,L,H,N) in r's type, s_final
    (B,H,N,N) float32) on that device, from a zero state.

    A CUDA input launches the kernel on the current stream (contiguous
    tensors, N <= 64, chunk <= 64; anything else raises); a CPU input runs
    :func:`reference`."""
    _check(r, k, v, w, u)
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    if r.device.type == "cpu":
        return reference(r, k, v, w, u, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("rwkv6_wkv needs contiguous inputs")
    B, L, H, N = r.shape
    if N > MAX_N:
        raise ValueError(f"rwkv6_wkv takes N <= {MAX_N}, got {N}")
    out = torch.empty_like(r)
    s = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out, s.zero_()
    fn = _function(r.dtype)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), out.data_ptr(), s.data_ptr(), B, L, H, N,
                 chunk, stream)
    _build.check("rwkv6_wkv", err)
    rwkv6_wkv.launches += 1
    return out, s


rwkv6_wkv.launches = 0

_FUNCTIONS = {}


def _function(dtype: torch.dtype):
    if dtype not in _FUNCTIONS:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FUNCTIONS[dtype] = _build.bind(
            "rwkv6_wkv", _SYMBOLS[dtype],
            [p, p, p, p, p, p, p, i, i, i, i, i, p])
    return _FUNCTIONS[dtype]
