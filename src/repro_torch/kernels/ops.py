"""Public kernel ops, the counterpart of ``repro.kernels.ops``.

Each op runs its hand-written CUDA kernel on CUDA tensors and its plain
PyTorch version on CPU tensors; the other kernels of the reference package
join as they are ported.
"""
from __future__ import annotations

from repro_torch.kernels.hedm_reduce import hedm_reduce

__all__ = ["hedm_reduce"]
