"""Forward GQA attention, causal and sliding window: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel) and
``repro.kernels.flash_attention_ref`` (its oracle). q (B,S,H,hd), k/v
(B,S,KV,hd) with H = KV*G -> (B,S,H,hd) in q's type; scores, softmax and
accumulation in fp32, masked entries at -1e30, the row sum clamped at
1e-30 (a row no key reaches gives 0).

:func:`flash_attention` is the wrapper. On a CPU tensor it runs
:func:`reference`. On a CUDA tensor it launches one of the two kernels of
``csrc/flash_attention.cu`` (built for sm_90a at first use, see
`repro_torch.kernels._build`) or raises; the rule (:func:`on_tensor_cores`):

* bfloat16 with hd % 8 == 0, hd <= 192 and q, k, v on 16-byte boundaries
  (TMA's row strides and addresses) -> ``flash_fwd_tc``, on ``wgmma`` with
  TMA loads, 128 query rows of one head a block;
* everything else (float32, whose 3e-5 bound the tensor cores cannot hold;
  bfloat16 with another hd or off those boundaries) -> ``flash_fwd``, on
  the fp32 CUDA cores, 64 rows of the grouped query matrix a block.

Both take hd up to 192, the widest head the paths give it (deepseek-v2's
MLA prefill: q and k 192 wide, v zero-padded to 192 by its caller). No
kernel falls back to the other or to :func:`reference`: a failed build or
launch, or hd > 192, raises. ``flash_attention.launches`` counts kernel
launches of both, ``flash_attention.launches_tc`` those of the tensor-core
kernel.

The launch is also a dispatcher op (``torch.library.custom_op``
``repro_torch::flash_attention``): its implementation is the launch (and
the place that counts it), its fake implementation gives the outputs'
shapes on fake tensors, and :func:`flops` is its registered FLOP formula,
so `repro_torch.launch.dryrun` traces the card's program with no build
and no launch. Only a traced call (``_build.traced``: fake tensors, or a
dispatch mode) goes through the op; any other launches directly.

The TPU kernel's ``block_q``/``block_k`` sized VMEM tiles and ``interpret``
chose Pallas' interpreter; the card's tiles are fixed by its shared memory,
and the CPU path is :func:`reference` itself. The source note in
``csrc/flash_attention.cu`` says what bounds the kernels and what their
designs do about it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 192
MAX_GROUP = 64                       # query heads per kv head: rows per tile
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_SYMBOL_TC = "flash_attention_bf16_tc"


def _mask(S: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, S) bool: query i may see key j."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(S, device=device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    return ok


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: dense grouped attention in fp32 with the kernel's
    arithmetic (q scaled first, masked probabilities exactly 0, the sum
    clamped at 1e-30), the result in q's type."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.float().reshape(B, S, KV, G, hd) * scale
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    ok = _mask(S, causal, window, q.device)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~ok, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkh->bkgsh", p, v.float()) / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,hd) and k/v (B,S,KV,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KV,hd), one type (float32 or bfloat16), on one
    device -> (B,S,H,hd) in q's type on that device.

    A CUDA input launches a kernel on the current stream, the one
    :func:`on_tensor_cores` names (contiguous tensors, hd <= 192 and, on
    the CUDA cores, at most 64 query heads per kv head; anything else
    raises, as does an input that requires grad in grad mode: the kernel
    has no backward). A traced call goes through the dispatcher op
    ``repro_torch::flash_attention`` instead: on fake tensors its fake
    implementation gives the output's shape and :func:`flops` its work,
    with no build and no launch. A CPU input runs :func:`reference`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return reference(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _build.refuse_grad("flash_attention", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    hd = q.shape[3]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes hd <= {MAX_HEAD_DIM}, got "
                         f"{hd}")
    run = _op if _build.traced(q, k, v) else _launch
    return run(q, k, v, bool(causal), int(window),
               float(hd ** -0.5 if scale is None else scale))


flash_attention.launches = 0
flash_attention.launches_tc = 0


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, scale: float) -> torch.Tensor:
    """One kernel launch on CUDA tensors (the op's implementation)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    tc = on_tensor_cores(q, k, v)
    if not tc and H // KV > MAX_GROUP:
        raise ValueError(f"flash_attention takes at most {MAX_GROUP} query "
                         f"heads per kv head on the CUDA cores, got "
                         f"{H // KV}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _function(_SYMBOL_TC if tc else _SYMBOLS[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, KV, hd, float(scale), int(bool(causal)),
                 int(window), stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.launches_tc += tc
    return out


_op = torch.library.custom_op(
    "repro_torch::flash_attention", _launch, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int window, "
           "float scale) -> Tensor")


@_op.register_fake
def _(q, k, v, causal, window, scale):
    return torch.empty_like(q)


def attention_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs the mask lets through at length S: causal
    S(S+1)/2, bidirectional S^2, a window keeping the keys j with i - window
    < j (and j <= i when causal)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    if causal:          # min(i + 1, window) keys a query
        return window * (window + 1) // 2 + (S - window) * window
    # keys j > i - window, up to S - 1: S - max(0, i - window + 1) a query
    tail = S - window + 1
    return S * S - (tail - 1) * tail // 2


def flops(B: int, S: int, H: int, hd: int, causal: bool = True,
          window: int = 0, dv: Optional[int] = None) -> int:
    """The kernel's work: q.k over hd and p.v over ``dv`` (hd unless said),
    2 operations a multiply-add, for each (query, key) pair the mask lets
    through (:func:`attention_pairs`) of each head. 30.08 GFLOP at
    zamba2-7b's prefill (1, 2048, 32, hd 112, causal)."""
    dv = hd if dv is None else dv
    return 2 * (hd + dv) * H * B * attention_pairs(S, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flop_formula(q_shape, k_shape, v_shape, causal, window, scale, *args,
                  **kwargs) -> int:
    B, S, H, hd = q_shape
    return flops(B, S, H, hd, causal, window)


def on_tensor_cores(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> bool:
    """The dispatch rule: bfloat16 with hd % 8 == 0 and hd <= 192 and q, k,
    v on 16-byte boundaries go to the tensor-core kernel; the rest to the
    CUDA-core one."""
    hd = q.shape[3]
    return (q.dtype == torch.bfloat16 and hd % 8 == 0
            and hd <= MAX_HEAD_DIM
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


_FUNCTIONS = {}


def _function(symbol: str):
    if symbol not in _FUNCTIONS:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FUNCTIONS[symbol] = _build.bind(
            "flash_attention", symbol,
            [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p])
    return _FUNCTIONS[symbol]
