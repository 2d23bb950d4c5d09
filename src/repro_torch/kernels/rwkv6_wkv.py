"""Chunked RWKV6 WKV recurrence: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``repro.kernels.rwkv6_wkv`` (the Pallas TPU kernel) and
``repro.kernels.rwkv6_wkv_ref`` (its oracle, the step-by-step recurrence
``o_t = r_t (S + u k_t^T v_t)``, ``S = diag(w_t) S + k_t^T v_t`` from a zero
state). r/k/v (B,L,H,N) in one type, w (B,L,H,N) and u (H,N) float32 ->
out (B,L,H,N) in r's type and the final state s (B,H,N,N) in float32.

:func:`rwkv6_wkv` is the wrapper. On a CPU tensor it runs
:func:`reference`. On a CUDA tensor it launches one of the two kernels of
``csrc/rwkv6_wkv.cu`` (built for sm_90a at first use, see
`repro_torch.kernels._build`) or raises; the rule (:func:`on_tensor_cores`):

* bfloat16 r/k/v with N a multiple of 16 and at most 64, chunk <= 64 and
  k, v, w on 16-byte boundaries -> ``wkv6_tc``, on the tensor cores
  (``mma.sync``), in two passes: the state at each chunk's start into a
  scratch buffer of :func:`scratch_bytes` (every chunk's decays at once,
  then a walk over the chunks), then every chunk's output from it;
* everything else (float32; bfloat16 with another N) -> ``wkv6``, on the
  fp32 CUDA cores, one block per (head, batch row) walking the chunks.

No kernel falls back to the other or to :func:`reference`: a failed build
or launch raises. ``rwkv6_wkv.launches`` counts wrapper calls that
launched a kernel (one a call, however many launches the call makes),
``rwkv6_wkv.launches_tc`` those on the tensor-core kernel.

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
_SYMBOL_TC = "rwkv6_wkv_bf16_tc"


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

    A CUDA input launches a kernel on the current stream, the one
    :func:`on_tensor_cores` names (contiguous tensors, N <= 64, chunk <=
    64; anything else raises, as does an input that requires grad in grad
    mode: the kernel has no backward); a CPU input runs :func:`reference`."""
    _check(r, k, v, w, u)
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    if r.device.type == "cpu":
        return reference(r, k, v, w, u, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    _build.refuse_grad("rwkv6_wkv", r, k, v, w, u)
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("rwkv6_wkv needs contiguous inputs")
    B, L, H, N = r.shape
    if N > MAX_N:
        raise ValueError(f"rwkv6_wkv takes N <= {MAX_N}, got {N}")
    out = torch.empty_like(r)
    s = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out, s.zero_()
    tc = on_tensor_cores(r, k, v, w, chunk)
    ptrs = [r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(), s.data_ptr()]
    if tc:
        starts = torch.empty(scratch_bytes(B, L, H, N, chunk) // 4,
                             dtype=torch.float32, device=r.device)
        ptrs.append(starts.data_ptr())
    fn = _function(_SYMBOL_TC if tc else _SYMBOLS[r.dtype])
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(*ptrs, B, L, H, N, chunk, stream)
    _build.check("rwkv6_wkv", err)
    rwkv6_wkv.launches += 1
    rwkv6_wkv.launches_tc += tc
    return out, s


rwkv6_wkv.launches = 0
rwkv6_wkv.launches_tc = 0


def on_tensor_cores(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, chunk: int = CHUNK) -> bool:
    """The dispatch rule: bfloat16 r/k/v with N % 16 == 0 and N <= 64 (the
    state is carried in 16-column slices), chunk <= 64 and k, v, w on
    16-byte boundaries (their rows are copied in 16-byte pieces) go to the
    tensor-core kernel; the rest to the CUDA-core one."""
    N = r.shape[3]
    return (r.dtype == torch.bfloat16 and N % 16 == 0 and N <= MAX_N
            and 0 < chunk <= MAX_CHUNK
            and all(t.data_ptr() % 16 == 0 for t in (k, v, w)))


def scratch_bytes(B: int, L: int, H: int, N: int, chunk: int = CHUNK) -> int:
    """Bytes of the tensor-core kernel's scratch (laid out by ``struct
    Scratch`` in ``csrc/rwkv6_wkv.cu``), for each of the nc = ceil(L /
    chunk) chunks of every (batch row, head): the float32 (N, N) state at
    the chunk's start and (N,) decay, and k exp(lcum_last - lcum) as a bf16
    pair over the chunk padded to QP = 16, 32 or 64 steps.
    63,569,920 at rwkv6-3b's (1, 2048, 40, 64) and chunk 32; 55,623,680
    at L = 1781."""
    Q = min(chunk, L)
    qp = 16 if Q <= 16 else 32 if Q <= 32 else 64
    bhc = B * H * -(-L // Q)
    return 4 * bhc * N * (N + 1) + 4 * bhc * qp * N


_FUNCTIONS = {}


def _function(symbol: str):
    if symbol not in _FUNCTIONS:
        p, i = ctypes.c_void_p, ctypes.c_int
        n_ptr = 8 if symbol == _SYMBOL_TC else 7
        _FUNCTIONS[symbol] = _build.bind(
            "rwkv6_wkv", symbol, [p] * n_ptr + [i, i, i, i, i, p])
    return _FUNCTIONS[symbol]
