"""Public kernel ops, the counterpart of ``repro.kernels.ops``.

Each op runs its hand-written CUDA kernel on CUDA tensors and its plain
PyTorch version on CPU tensors. Every kernel of the reference has its
counterpart here.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.hedm_reduce import hedm_reduce
from repro_torch.kernels.mamba2_scan import mamba2_scan
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv

__all__ = ["flash_attention", "hedm_reduce", "mamba2_scan", "rwkv6_wkv"]
