"""Absorbed MLA decode attention over the latent caches: the CUDA kernel and
its plain PyTorch version.

No Pallas kernel of the reference package computes this: its MLA decode
(``repro.models.attention.mla_decode``) is plain ``jnp``. One query token a
slot attends over the positions its slot has cached: q_abs (B,H,R) (q_nope
absorbed through W_uk) and q_rope (B,H,E) against the latent cache ck
(B,cap,R) and the rope-key cache cr (B,cap,E), slot b's positions
0..min(pos[b], cap - 1) -> the latent context (B,H,R) in ck's type. Scores
and softmax in float32, the probabilities rounded to ck's type before the
product with ck, as :func:`reference` does.

:func:`mla_decode` is the wrapper. On a CPU tensor it runs
:func:`reference`. On a CUDA tensor it launches one of the two kernels of
``csrc/mla_decode.cu`` and, where a slot's positions were split into
parts, its combine, in one call (built for sm_90a at first use, see
`repro_torch.kernels._build`) or raises; the rule (:func:`on_tensor_cores`):

* bfloat16 at (R, E) = (512, 64) (DeepSeek-V2-Lite, Kimi-Linear) or
  (32, 16) (the smoke configs) with every input on a 16-byte boundary ->
  ``mla_decode_tc``, on ``mma.sync`` with a ``cp.async`` ring;
* everything else (float32; bfloat16 at other widths) ->
  ``mla_decode_cc``, on the fp32 CUDA cores.

Both read only the cached positions, once. The kernel's online softmax
rounds the unnormalised probabilities (relative to the running max) to the
caches' type before the product, where :func:`reference` rounds the
normalised ones: the source note says why. No kernel falls back to the other
or to :func:`reference`. ``mla_decode.launches`` counts calls of both,
``mla_decode.launches_tc`` those of the tensor-core kernel.

The launch is also the dispatcher op ``repro_torch::mla_decode``, with
:func:`flops` over the positions attended as its FLOP formula (the contract:
`repro_torch.kernels._build`).
"""
from __future__ import annotations

import math
from ctypes import c_float, c_int, c_void_p
from typing import Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

NEG_INF = -1e30
#: positions a part takes at least: CHUNK at up to 16 heads, CHUNK_WIDE
#: above. A part that is not its slot's only one writes an (H, R) float32
#: partial that the combine reads back, at most 5-7% of the bytes of the
#: cache it read at these sizes. The fastest of 384-1,536 on an H100 at both
#: serving cells' decode shapes (PERF.md, section 6): fewer, longer parts cost
#: the balance over the card's 132 SMs, more cost partials
CHUNK, CHUNK_WIDE = 1024, 1536
MAX_PARTS = 32                 # the combine weighs a slot's parts in a warp
_SYMBOLS = {torch.float32: "mla_decode_f32", torch.bfloat16: "mla_decode_bf16"}
_SYMBOL_TC = "mla_decode_bf16_tc"
_TC_WIDTHS = ((512, 64), (32, 16))


def reference(q_abs: torch.Tensor, q_rope: torch.Tensor, ck: torch.Tensor,
              cr: torch.Tensor, pos: torch.Tensor,
              scale: float) -> torch.Tensor:
    """The plain version: scores over the whole capacity in float32, the
    positions past ``pos`` masked, the probabilities rounded to ck's type
    before the product with ck."""
    cap = ck.shape[1]
    scores = (torch.einsum("bhr,btr->bht", q_abs.float(), ck.float())
              + torch.einsum("bhe,bte->bht", q_rope.float(),
                             cr.float())) * scale
    valid = torch.arange(cap, device=ck.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(ck.dtype)
    return torch.einsum("bht,btr->bhr", probs, ck)


def _check(q_abs, q_rope, ck, cr, pos) -> None:
    if q_abs.dim() != 3 or q_rope.dim() != 3 or ck.dim() != 3 \
            or cr.dim() != 3 or pos.dim() != 1:
        raise ValueError(f"expected q_abs (B,H,R), q_rope (B,H,E), ck "
                         f"(B,cap,R), cr (B,cap,E), pos (B,), got "
                         f"{tuple(q_abs.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(ck.shape)}, {tuple(cr.shape)}, "
                         f"{tuple(pos.shape)}")
    B, H, R = q_abs.shape
    if (q_rope.shape[:2] != (B, H) or ck.shape[0] != B or ck.shape[2] != R
            or cr.shape[:2] != ck.shape[:2]
            or cr.shape[2] != q_rope.shape[2] or pos.shape[0] != B):
        raise ValueError(f"shapes do not match: q_abs {tuple(q_abs.shape)}, "
                         f"q_rope {tuple(q_rope.shape)}, ck "
                         f"{tuple(ck.shape)}, cr {tuple(cr.shape)}, pos "
                         f"{tuple(pos.shape)}")
    if q_abs.dtype not in _SYMBOLS or any(
            t.dtype != q_abs.dtype for t in (q_rope, ck, cr)):
        raise TypeError(f"q_abs, q_rope, ck, cr must share float32 or "
                        f"bfloat16, got {q_abs.dtype}, {q_rope.dtype}, "
                        f"{ck.dtype}, {cr.dtype}")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"pos must be int32 or int64, got {pos.dtype}")
    devices = {t.device for t in (q_abs, q_rope, ck, cr, pos)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devices))}")


def mla_decode(q_abs: torch.Tensor, q_rope: torch.Tensor, ck: torch.Tensor,
               cr: torch.Tensor, pos: torch.Tensor,
               scale: float) -> torch.Tensor:
    """q_abs (B,H,R), q_rope (B,H,E), ck (B,cap,R), cr (B,cap,E) in one type
    (float32 or bfloat16) and pos (B,) >= 0, on one device -> the latent
    context (B,H,R) in ck's type on that device: slot b attends over its
    positions 0..min(pos[b], cap - 1).

    A CUDA input launches a kernel on the current stream, the one
    :func:`on_tensor_cores` names (contiguous caches; q_abs and q_rope are
    made contiguous; an input that requires grad in grad mode raises: the
    kernel has no backward). A traced call goes through the dispatcher op
    ``repro_torch::mla_decode`` instead: on fake tensors its fake
    implementation gives the output's shape and :func:`flops` its work, with
    no build and no launch. A CPU input runs :func:`reference`."""
    _check(q_abs, q_rope, ck, cr, pos)
    if not _build.on_card("mla_decode", ck, cr, pos):
        return reference(q_abs, q_rope, ck, cr, pos, scale)
    _build.refuse_grad("mla_decode", q_abs, q_rope, ck, cr)
    return _run(q_abs.contiguous(), q_rope.contiguous(), ck, cr,
                pos.to(torch.int32), float(scale))


_P, _I = c_void_p, c_int
_LIB = _build.Library(
    "mla_decode",
    {symbol: [_P] * 9 + [_I] * 7 + [c_float]
     for symbol in (*_SYMBOLS.values(), _SYMBOL_TC)}, mla_decode,
    tc=_SYMBOL_TC)


def parts(H: int, cap: int) -> Tuple[int, int]:
    """(most parts a slot's positions are split into, positions a part
    takes at least) at H heads and a capacity of ``cap``: 8 and 1,024 at
    DeepSeek-V2-Lite's 16 heads and 8,192 positions, 6 and 1,536 at
    Kimi-Linear's 32."""
    chunk = CHUNK if H <= 16 else CHUNK_WIDE
    return max(1, min(MAX_PARTS, math.ceil(cap / chunk))), chunk


def _launch(q_abs: torch.Tensor, q_rope: torch.Tensor, ck: torch.Tensor,
            cr: torch.Tensor, pos: torch.Tensor,
            scale: float) -> torch.Tensor:
    """One call into the library on CUDA tensors (the op's implementation):
    the kernel and, where a slot's positions are split, the combine."""
    B, H, R = q_abs.shape
    cap, E = cr.shape[1], cr.shape[2]
    out = torch.empty_like(q_abs)
    if out.numel() == 0:
        return out
    if cap == 0:
        raise ValueError("mla_decode needs a capacity of at least 1")
    n_parts, chunk = parts(H, cap)
    stats = torch.empty((2, B, H, n_parts), dtype=torch.float32,
                        device=ck.device)
    partial = torch.empty((B, H, n_parts, R) if n_parts > 1 else (0,),
                          dtype=torch.float32, device=ck.device)
    tc = on_tensor_cores(q_abs, q_rope, ck, cr)
    _LIB.launch(_SYMBOL_TC if tc else _SYMBOLS[ck.dtype], ck.device,
                q_abs.data_ptr(), q_rope.data_ptr(), ck.data_ptr(),
                cr.data_ptr(), pos.data_ptr(), out.data_ptr(),
                stats[0].data_ptr(), stats[1].data_ptr(), partial.data_ptr(),
                B, H, R, E, cap, n_parts, chunk, float(scale))
    return out


def _fake(q_abs, q_rope, ck, cr, pos, scale):
    return torch.empty_like(q_abs)


def attended(pos: torch.Tensor, cap: int) -> int:
    """Positions attended over the batch: min(pos + 1, cap) a slot."""
    return int((pos.long().clamp(min=-1, max=cap - 1) + 1).sum())


def flops(H: int, R: int, E: int, positions: int) -> int:
    """The work over ``positions`` attended (summed over the slots): scores
    over R + E and the latent sum over R, 2 operations a multiply-add, each
    head. 10.25 GFLOP at a step of ``dsv2-lite.decode``'s batch with a mean
    of 2,300 positions a slot (H 16, R 512, E 64, 294,400 positions)."""
    return 2 * H * (2 * R + E) * positions


def _flop_formula(q_abs, q_rope, ck, cr, pos, scale) -> int:
    """The positions attended where ``pos`` holds values; on a fake ``pos``
    (a traced program, no data) every slot's whole capacity, the most it
    could attend."""
    B, H, R = q_abs.shape
    cap, E = cr.shape[1], cr.shape[2]
    n = B * cap if isinstance(pos, FakeTensor) or pos.is_meta \
        else attended(pos, cap)
    return flops(H, R, E, n)


_run = _build.op("mla_decode",
                 "(Tensor q_abs, Tensor q_rope, Tensor ck, Tensor cr, "
                 "Tensor pos, float scale) -> Tensor", _launch, _fake,
                 _flop_formula, raw=True)


def on_tensor_cores(q_abs: torch.Tensor, q_rope: torch.Tensor,
                    ck: torch.Tensor, cr: torch.Tensor) -> bool:
    """The dispatch rule: bfloat16 at (R, E) = (512, 64) or (32, 16), the
    widths the kernel is built for, with q_abs, q_rope, ck, cr on 16-byte
    boundaries go to the tensor-core kernel; the rest to the CUDA-core one."""
    return (ck.dtype == torch.bfloat16
            and (ck.shape[2], cr.shape[2]) in _TC_WIDTHS
            and all(t.data_ptr() % 16 == 0 for t in (q_abs, q_rope, ck, cr)))
