"""Build the port's model from the reference package's parameter tree.

``params_from_jax(cfg, tree)`` takes the reference's nested dict of
parameters as numpy arrays (``jax.tree.map(np.asarray, params)`` on the
caller's side; nothing here imports JAX) and returns a
`repro_torch.models.model.Model` holding the same values. The stacked
leading layer axis of ``groups``, ``loras``, ``tail``, ``prefix`` and
``layers`` is cut into the port's per-layer modules; a MoE block's experts
stay stacked (``moe.w_gate``, ``w_up``, ``w_down``), as the port keeps
them. Every array must land on a parameter of
the same shape and every parameter must be filled, or it raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a tree stacked along a leading layer axis."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _load(module: nn.Module, tree: Dict[str, Any], path: str,
          filled: set) -> None:
    for name, sub in tree.items():
        where = f"{path}.{name}" if path else name
        if not hasattr(module, name):
            raise KeyError(f"the port's model has no parameter {where}")
        target = getattr(module, name)
        if isinstance(target, nn.ModuleList):
            n = len(np.asarray(next(iter(_leaves(sub)))))
            if n != len(target):
                raise ValueError(f"{where}: {n} stacked layers, the port has "
                                 f"{len(target)}")
            for i, layer in enumerate(target):
                _load(layer, _layer(sub, i), f"{where}.{i}", filled)
        elif isinstance(target, nn.Module):
            _load(target, sub, where, filled)
        else:
            t = _tensor(sub)
            if tuple(t.shape) != tuple(target.shape):
                raise ValueError(f"{where}: shape {tuple(t.shape)}, the port "
                                 f"has {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(t)
            filled.add(where)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Model:
    """The port's model for ``cfg`` on ``device``, with the values of the
    reference's parameter ``tree`` (numpy arrays). ``dtype`` overrides the
    config's parameter type, as :class:`Model` does; parameters that the
    reference keeps in float32 whatever that type (Mamba2's ``dt_bias``,
    ``A_log`` and ``D``; RWKV6's ``w0`` and ``u``; the MoE ``router``) stay
    float32. Nested
    parameters (RWKV6's ``mixer.ln_x.scale``) land on the nested module."""
    model = Model(cfg, None, resolve_device(device), dtype)
    filled: set = set()
    _load(model, tree, "", filled)
    missing = sorted(n for n, _ in model.named_parameters()
                     if n not in filled)
    if missing:
        raise KeyError(f"parameters missing from the tree: {missing[:8]}"
                       + (" ..." if len(missing) > 8 else ""))
    return model
