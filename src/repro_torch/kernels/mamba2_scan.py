"""Chunked Mamba2 SSD scan: the CUDA kernel and its plain PyTorch version.

Counterpart of ``repro.kernels.mamba2_scan`` (the Pallas TPU kernel) and
``repro.kernels.mamba2_scan_ref`` (its oracle, the step-by-step recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t``). x
(B,L,H,P), dt (B,L,H), A (H,), B/C (B,L,G,N) with G | H -> y (B,L,H,P) in
x's type and the final state h (B,H,P,N) in float32.

:func:`mamba2_scan` is the wrapper. On a CPU tensor it runs
:func:`reference`. On a CUDA tensor it launches one of the two kernels of
``csrc/mamba2_scan.cu`` (built for sm_90a at first use, see
`repro_torch.kernels._build`) or raises; the rule (:func:`on_tensor_cores`):

* bfloat16 x/B/C with P and N multiples of 8 and x, B, C on 16-byte
  boundaries -> ``ssd_scan_tc``, on the tensor cores (``mma.sync``), one
  block per (head, 32 value channels, batch row);
* everything else (float32; bfloat16 with another P or N, or off those
  boundaries) -> ``ssd_scan``, on the fp32 CUDA cores, one block per
  (head, batch row).

No kernel falls back to the other or to :func:`reference`: a failed build
or launch raises. ``mamba2_scan.launches`` counts kernel launches of both,
``mamba2_scan.launches_tc`` those of the tensor-core kernel.

The launch is also a dispatcher op (``torch.library.custom_op``
``repro_torch::mamba2_scan``): its implementation is the launch (and the
place that counts it), its fake implementation gives the outputs' shapes
on fake tensors, and :func:`flops` is its registered FLOP formula, so
`repro_torch.launch.dryrun` traces the card's program with no build and
no launch. Only a traced call (``_build.traced``: fake tensors, or a
dispatch mode) goes through the op; any other launches directly.

Both take any L: the last chunk may be short (the TPU kernel asserted
``L % chunk == 0``). The source note in ``csrc/mamba2_scan.cu`` says what
bounds the kernels and what their designs do about it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

MAX_CHUNK = 128
MAX_P = 64
MAX_N = 64
_SYMBOLS = {torch.float32: "mamba2_scan_f32",
            torch.bfloat16: "mamba2_scan_bf16"}
_SYMBOL_TC = "mamba2_scan_bf16_tc"


def segment_sums(a: torch.Tensor) -> torch.Tensor:
    """a (B,Q,H) -> seg (B,Q,Q,H) with seg[:, q, k] = sum_{k<j<=q} a[:, j]
    (0 where k >= q): a running sum down each column k, as the kernels take
    it. The log-decay from step k to step q; its last row is the decay to
    the chunk's end. Never a difference of two prefix sums, which reach
    ~10^2 within a chunk where a float32 step is ~1e-5."""
    Q = a.shape[1]
    later = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device),
                       -1)[None, :, :, None]                  # j > k
    return torch.cumsum(a[:, :, None].expand(-1, -1, Q, -1)
                        .masked_fill(~later, 0.0), dim=1)


def reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = MAX_CHUNK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the kernel's chunked arithmetic in fp32, one chunk
    at a time (the last one may be short), the decays from
    :func:`segment_sums`. Returns (y in x's type, h_final (B,H,P,N)
    float32)."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = Bm.float().repeat_interleave(H // G, dim=2)          # (B,L,H,N)
    Ch = Cm.float().repeat_interleave(H // G, dim=2)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, L, chunk):
        xc, dtc = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        Bc, Cc = Bh[:, c0:c0 + chunk], Ch[:, c0:c0 + chunk]
        Q = xc.shape[1]
        a = dtc * Af                                          # (B,Q,H)
        cum = torch.cumsum(a, dim=1)
        seg = segment_sums(a)                                 # (B,Q,Q,H)
        keep = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                     device=x.device))[None, :, :, None]
        # exp only where k <= q: the masked sums would overflow
        M = (torch.einsum("bqhn,bkhn->bqkh", Cc, Bc)
             * torch.exp(seg.masked_fill(~keep, float("-inf"))) * dtc[:, None])
        y = torch.einsum("bqkh,bkhp->bqhp", M, xc)
        y = y + torch.einsum("bqhn,bhpn->bqhp", Cc, h) \
            * torch.exp(cum)[..., None]
        w = torch.exp(seg[:, -1]) * dtc                       # (B,Q,H)
        h = h * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("bqhn,bqh,bqhp->bhpn", Bc, w, xc)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"expected x (B,L,H,P), dt (B,L,H), A (H,), B/C "
                         f"(B,L,G,N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, L, H, P = x.shape
    G = Bm.shape[2]
    if dt.shape != (B, L, H) or A.shape != (H,) or Bm.shape[:2] != (B, L) \
            or H % G:
        raise ValueError(f"shapes do not match x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(Bm.shape)}")
    if x.dtype not in _SYMBOLS or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    devices = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = MAX_CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,H,P) and B/C (B,L,G,N) in one type (float32 or bfloat16), dt
    (B,L,H) and A (H,) float32, all on one device -> (y (B,L,H,P) in x's
    type, h_final (B,H,P,N) float32) on that device.

    A CUDA input launches a kernel on the current stream, the one
    :func:`on_tensor_cores` names (contiguous tensors, P <= 64, N <= 64,
    chunk <= 128; anything else raises, as does an input that requires
    grad in grad mode: the kernel has no backward). A traced call goes
    through the dispatcher op ``repro_torch::mamba2_scan`` instead: on fake
    tensors its fake implementation gives the outputs' shapes and
    :func:`flops` its work. A CPU input runs :func:`reference`."""
    _check(x, dt, A, Bm, Cm)
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    if x.device.type == "cpu":
        return reference(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _build.refuse_grad("mamba2_scan", x, dt, A, Bm, Cm)
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("mamba2_scan needs contiguous inputs")
    P, N = x.shape[3], Bm.shape[3]
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"mamba2_scan takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P {P}, N {N}")
    run = _op if _build.traced(x, dt, A, Bm, Cm) else _launch
    return run(x, dt, A, Bm, Cm, int(chunk))


mamba2_scan.launches = 0
mamba2_scan.launches_tc = 0


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on CUDA tensors (the op's implementation)."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h.zero_()
    tc = on_tensor_cores(x, Bm, Cm)
    fn = _function(_SYMBOL_TC if tc else _SYMBOLS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), h.data_ptr(), B, L, H, P, G, N,
                 chunk, stream)
    _build.check("mamba2_scan", err)
    mamba2_scan.launches += 1
    mamba2_scan.launches_tc += tc
    return y, h


_op = torch.library.custom_op(
    "repro_torch::mamba2_scan", _launch, mutates_args=(),
    schema="(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, "
           "int chunk) -> (Tensor, Tensor)")


@_op.register_fake
def _(x, dt, A, Bm, Cm, chunk):
    B, L, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((B, H, P, Bm.shape[3]), dtype=torch.float32))


def flops(B: int, L: int, H: int, P: int, N: int,
          chunk: int = MAX_CHUNK) -> int:
    """The kernel's products, 2 operations a multiply-add, for each chunk of
    qc steps and head: C.B^T (qc^2 N), M.x (qc^2 P), C.h^T and the state
    update (2 qc N P each). 11.27 GFLOP at zamba2-7b's prefill (1, 2048,
    112, 64, N 64, chunk 128)."""
    total = 0
    for c0 in range(0, L, chunk):
        qc = min(chunk, L - c0)
        total += B * H * (2 * qc * qc * N + 2 * qc * qc * P + 4 * qc * N * P)
    return total


@register_flop_formula(torch.ops.repro_torch.mamba2_scan)
def _flop_formula(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk,
                  *args, **kwargs) -> int:
    B, L, H, P = x_shape
    return flops(B, L, H, P, B_shape[3], chunk)


def on_tensor_cores(x: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor) -> bool:
    """The dispatch rule: bfloat16 with P % 8 == 0 and N % 8 == 0 (the
    kernel copies 16-byte pieces) and x, B, C on 16-byte boundaries go to
    the tensor-core kernel; the rest to the CUDA-core one."""
    return (x.dtype == torch.bfloat16 and x.shape[3] % 8 == 0
            and Bm.shape[3] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm)))


_FUNCTIONS = {}


def _function(symbol: str):
    if symbol not in _FUNCTIONS:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FUNCTIONS[symbol] = _build.bind(
            "mamba2_scan", symbol,
            [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p])
    return _FUNCTIONS[symbol]
