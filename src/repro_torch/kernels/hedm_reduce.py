"""NF-HEDM stage-1 reduction (paper §VI-A): the CUDA kernel and its plain
PyTorch version.

Counterpart of ``repro.kernels.hedm_reduce`` (the Pallas TPU kernel) and
``repro.kernels.hedm_reduce_ref`` (its oracle). Per frame: dark subtraction
``max(frame - dark, 0)``, 3x3 median, 3x3 Laplacian on the median, both
with edge-replicated borders, then ``mask = lap > thr & med > thr/2`` and
the per-frame count of mask pixels.

:func:`hedm_reduce` is the wrapper. On a CUDA tensor it launches the
hand-written kernel ``csrc/hedm_reduce.cu`` (built for sm_90a at first use,
see `repro_torch.kernels._build`) or raises; on a CPU tensor it runs
:func:`reference`. ``hedm_reduce.launches`` counts kernel launches.

The launch is also a dispatcher op (``torch.library.custom_op``
``repro_torch::hedm_reduce``): its implementation is the launch (and the
place that counts it), its fake implementation gives the outputs' shapes
on fake tensors, and :func:`flops` is its registered FLOP formula, so
`repro_torch.launch.dryrun` traces the card's program with no build and
no launch. Only a traced call (``_build.traced``: fake tensors, or a
dispatch mode) goes through the op; any other launches directly.

The TPU kernel's knobs are gone: ``tile_rows`` and ``vmem_budget_bytes``
sized row tiles to the TPU's VMEM, and a GPU thread's strip of 8 columns
walking a band of 128 rows is fixed by the card, not by the frame;
``interpret`` chose Pallas' interpreter off-TPU, and the CPU path here is
:func:`reference` itself.

The source note in ``csrc/hedm_reduce.cu`` says what bounds the kernel
(HBM bytes: ~4.6 ms at (736, 2048, 2048) float32 on an H100 SXM) and what
its design does about it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

_SYMBOLS = {torch.float32: "hedm_reduce_f32", torch.uint16: "hedm_reduce_u16"}
_MAX_FRAMES = 65535                   # gridDim.z


def _neighborhood(img: torch.Tensor) -> torch.Tensor:
    """(9, F, H, W) 3x3 neighbourhoods of (F, H, W) with edge replication,
    row-major over the window like the oracle's ``_neighborhood``."""
    F, H, W = img.shape
    padded = torch.nn.functional.pad(img[:, None], (1, 1, 1, 1),
                                     mode="replicate")[:, 0]
    return torch.stack([padded[:, di:di + H, dj:dj + W]
                        for di in range(3) for dj in range(3)])


def reference(frames: torch.Tensor, dark: torch.Tensor,
              threshold: float = 100.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (F,H,W) uint16/float32, dark (H,W) -> (mask (F,H,W) uint8,
    counts (F,) int32). The plain version: bit-exact with the oracle
    ``repro.kernels.hedm_reduce_ref.reference`` (same median selection, the
    Laplacian summed in the oracle's order, thresholds in float32)."""
    thr = torch.tensor(threshold, dtype=torch.float32, device=frames.device)
    img = torch.clamp_min(frames.to(torch.float32) - dark.to(torch.float32),
                          0.0)
    med = torch.median(_neighborhood(img), dim=0).values
    n = _neighborhood(med)
    lap = 8.0 * n[4] - (n[0] + n[1] + n[2] + n[3] + n[5] + n[6] + n[7]
                        + n[8])
    mask = (lap > thr) & (med > thr * 0.5)
    return mask.to(torch.uint8), mask.sum(dim=(1, 2), dtype=torch.int32)


def _check(frames: torch.Tensor, dark: torch.Tensor) -> None:
    if frames.dim() != 3 or dark.dim() != 2 or frames.shape[1:] != dark.shape:
        raise ValueError(f"expected frames (F,H,W) and dark (H,W), got "
                         f"{tuple(frames.shape)} and {tuple(dark.shape)}")
    if frames.dtype not in _SYMBOLS:
        raise TypeError(f"frames must be float32 or uint16, got "
                        f"{frames.dtype}")
    if dark.dtype != torch.float32:
        raise TypeError(f"dark must be float32, got {dark.dtype}")
    if frames.device != dark.device:
        raise ValueError(f"frames on {frames.device}, dark on {dark.device}")


def hedm_reduce(frames: torch.Tensor, dark: torch.Tensor,
                threshold: float = 100.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (F,H,W) uint16/float32 and dark (H,W) float32, both on one
    device -> (mask (F,H,W) uint8, counts (F,) int32) on that device.

    A CUDA input launches the kernel on the current stream (contiguous
    tensors only; anything else raises). A traced call goes through the
    dispatcher op ``repro_torch::hedm_reduce`` instead: on fake tensors its
    fake implementation gives the outputs' shapes and :func:`flops` its
    work. A CPU input runs :func:`reference`."""
    _check(frames, dark)
    if frames.device.type == "cpu":
        return reference(frames, dark, threshold)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not (frames.is_contiguous() and dark.is_contiguous()):
        raise ValueError("hedm_reduce needs contiguous frames and dark")
    if frames.shape[0] > _MAX_FRAMES:
        raise ValueError(f"at most {_MAX_FRAMES} frames per launch, got "
                         f"{frames.shape[0]}")
    run = _op if _build.traced(frames, dark) else _launch
    return run(frames, dark, float(threshold))


hedm_reduce.launches = 0


def _launch(frames: torch.Tensor, dark: torch.Tensor,
            threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on CUDA tensors (the op's implementation)."""
    F, H, W = frames.shape
    mask = torch.empty((F, H, W), dtype=torch.uint8, device=frames.device)
    counts = torch.zeros((F,), dtype=torch.int32, device=frames.device)
    if mask.numel() == 0:
        return mask, counts
    fn = _function(_SYMBOLS[frames.dtype])
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = fn(frames.data_ptr(), dark.data_ptr(), mask.data_ptr(),
                 counts.data_ptr(), F, H, W, float(threshold), stream)
    _build.check("hedm_reduce", err)
    hedm_reduce.launches += 1
    return mask, counts


_op = torch.library.custom_op(
    "repro_torch::hedm_reduce", _launch, mutates_args=(),
    schema="(Tensor frames, Tensor dark, float threshold) -> "
           "(Tensor, Tensor)")


@_op.register_fake
def _(frames, dark, threshold):
    return (torch.empty_like(frames, dtype=torch.uint8),
            frames.new_empty((frames.shape[0],), dtype=torch.int32))


#: fp32 operations a pixel: subtract, clamp, the median from sorted columns
#: at strips of 8 (12 column sorts of 6 and 10 medians of 12 min/max for 8
#: pixels: 24), Laplacian (7 adds, 1 mul, 1 sub), two compares, one and,
#: one count add
OPS_PER_PIXEL = 39


def flops(F: int, H: int, W: int) -> int:
    """The kernel's fp32 operations: :data:`OPS_PER_PIXEL` a pixel."""
    return OPS_PER_PIXEL * F * H * W


@register_flop_formula(torch.ops.repro_torch.hedm_reduce)
def _flop_formula(frames_shape, dark_shape, threshold, *args,
                  **kwargs) -> int:
    return flops(*frames_shape)


_FUNCTIONS = {}


def _function(name: str):
    """The bound C function ``name`` of ``csrc/hedm_reduce.cu``."""
    if name not in _FUNCTIONS:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FUNCTIONS[name] = _build.bind("hedm_reduce", name,
                                       [p, p, p, p, i, i, i, ctypes.c_float,
                                        p])
    return _FUNCTIONS[name]
