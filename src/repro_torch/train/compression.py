"""Gradient compression for cross-pod (DCN) reduction: int8 quantization with
error feedback.

Counterpart of ``repro.train.compression``, over a ``torch.distributed``
``DeviceMesh`` (NCCL on the card, gloo on the CPU). Intra-pod reduction
rides the fast interconnect; the POD-axis all-reduce crosses the
data-center network. Quantizing that hop to int8 cuts its bytes 4x; error
feedback keeps the scheme convergent (the quantization residual is carried
into the next step's gradient).

Per-tensor symmetric int8 quantization -> all-gather of (int8 payload, f32
scale) over the axis's group -> local dequant-sum. The all-gather of int8
moves exactly the compressed bytes on the wire. The arithmetic is the
reference's to the operation: the scale is max|x| / 127 + 1e-12 in
float32, rounding is half to even (``torch.round`` as ``jnp.round``), and
the dequant-sum adds the participants' blocks in rank order, each one
rounded once (exact at two participants, as the reference's contraction).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    scale = x.abs().amax() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_residual(g: torch.Tensor, err: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback: quantize (g + carried error); return (q, scale,
    new_err)."""
    target = g.to(torch.float32) + err
    q, scale = quantize_int8(target)
    new_err = target - dequantize_int8(q, scale)
    return q, scale, new_err


def compressed_psum(x: torch.Tensor, mesh, axis: str = "pod") -> torch.Tensor:
    """int8-compressed all-reduce over `axis` (mean is NOT applied).

    Each rank quantizes its local block ``x``, all-gathers the int8 payloads
    and the float32 scales over the axis's group, and dequant-sums locally.
    """
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    q, scale = quantize_int8(x)
    qs = q.new_empty((n * q.numel(),))                  # (n, ...) int8 wire
    dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)
    qs = qs.view((n,) + tuple(q.shape))
    ss = scale.new_empty((n,))                           # (n,) f32
    dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
    out = ss[0] * qs[0].to(torch.float32)
    for i in range(1, n):
        out = out + ss[i] * qs[i].to(torch.float32)
    return out


def _tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a dict tree (and of the trees in ``rest``,
    which share its structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def compressed_grad_allreduce(grads: Any, errors: Any, mesh,
                              axis: str = "pod") -> Tuple[Any, Any]:
    """Error-feedback int8 all-reduce of a grad tree (dicts of tensors,
    the port's grads keyed by parameter name) over the pod axis. Returns
    (reduced grads [mean], new error state)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    outs = _tree_map(lambda g, e: _one(g, e, mesh, axis, n), grads, errors)
    red = _tree_map(lambda o: o[0], outs)
    new_err = _tree_map(lambda o: o[1], outs)
    return red, new_err


def _one(g: torch.Tensor, e: torch.Tensor, mesh, axis: str, n: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    tgt = g.to(torch.float32) + e
    q, scale = quantize_int8(tgt)
    new_e = tgt - dequantize_int8(q, scale)
    red = compressed_psum(dequantize_int8(q, scale), mesh, axis) / n
    return red, new_e


def init_error_state(grads_shape: Any) -> Any:
    """Float32 zeros shaped (and placed) like each leaf of ``grads_shape``."""
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads_shape)
