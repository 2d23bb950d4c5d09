"""Public kernel ops, the counterpart of ``repro.kernels.ops``.

Each op runs its hand-written CUDA kernel on CUDA tensors (a traced call
through a ``torch.library.custom_op`` with a fake implementation and a
FLOP formula) and its plain PyTorch version on CPU tensors. Every kernel of the
reference has its counterpart here; ``mla_decode`` is the port's own (the
reference's MLA decode is plain ``jnp``).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.hedm_reduce import hedm_reduce
from repro_torch.kernels.mamba2_scan import mamba2_scan
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv

__all__ = ["flash_attention", "hedm_reduce", "mamba2_scan", "mla_decode",
           "rwkv6_wkv"]
