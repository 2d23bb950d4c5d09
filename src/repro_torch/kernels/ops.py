"""Public kernel ops, the counterpart of ``repro.kernels.ops``.

Each op runs its hand-written CUDA kernel on CUDA tensors and its plain
PyTorch version on CPU tensors; ``rwkv6_wkv`` joins when it is ported.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.hedm_reduce import hedm_reduce
from repro_torch.kernels.mamba2_scan import mamba2_scan

__all__ = ["flash_attention", "hedm_reduce", "mamba2_scan"]
