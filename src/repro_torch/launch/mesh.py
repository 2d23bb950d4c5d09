"""Device meshes over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``. Functions, not module constants, so
that importing this module touches no process group. A mesh is a
``DeviceMesh`` over the ranks of the default process group, which the
caller initialises first (``torch.distributed.init_process_group`` with
its address, world size and rank: nothing here discovers a cluster).
Single-pod: (16, 16) = 256 ranks, axes ("data", "model"). Multi-pod: (2,
16, 16) = 512 ranks, axes ("pod", "data", "model"); the pod axis carries
only gradient reduction. The card's constants for a roofline come with
the dry run (ROADMAP §1 item 8), measured on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the first prod(shape) ranks
    of the default group, on ``"cuda"`` unless ``device_type`` asks for
    ``"cpu"`` (raises without a card, as every entry point does)."""
    dev = resolve_device(device_type or "cuda")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh on the card; raises unless the default group
    has exactly its 256 (512 with ``multi_pod``) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; the default process group "
            f"has {have} — initialise torch.distributed with world size "
            f"{n} first")
    return make_mesh(shape, axes)
