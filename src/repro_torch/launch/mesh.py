"""Device meshes over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``. Functions, not module constants, so
that importing this module touches no process group. A mesh is a
``DeviceMesh`` over the ranks of the default process group, which the
caller initialises first (``torch.distributed.init_process_group`` with
its address, world size and rank: nothing here discovers a cluster).
Single-pod: (16, 16) = 256 ranks, axes ("data", "model"). Multi-pod: (2,
16, 16) = 512 ranks, axes ("pod", "data", "model"); the pod axis carries
only gradient reduction.

The constants at the end are the roofline's per-card rates for
`repro_torch.launch.dryrun`: NVIDIA's data-sheet figures for the H100 SXM
(dense rates, 700 W), not measurements of the card. A pod of 256 ranks
spans 32 hosts of 8 cards, and only the traffic within a host rides
NVLink, so the on-pod term that divides the on-pod bytes by the NVLink
rate is a lower bound.
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


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The production mesh, on the card unless ``device_type`` asks for
    ``"cpu"``; raises unless the default group has exactly its 256 (512
    with ``multi_pod``) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; the default process group "
            f"has {have} — initialise torch.distributed with world size "
            f"{n} first")
    return make_mesh(shape, axes, device_type)


# H100 SXM data-sheet figures (per card; dense, 700 W), used by the roofline
# of the dry run. Not measured on the card.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12                # bytes/s, HBM3
HBM_PER_CHIP = 80e9             # bytes
NVLINK_BW = 450e9               # bytes/s each way, NVLink 4: on-pod bytes
NET_BW_PER_GPU = 50e9           # bytes/s, one 400 Gb/s NIC a card: cross-pod
