"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. With no
card present it raises instead of quietly running on the CPU: a result
from the CPU must be asked for (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` when
    it names CUDA and no CUDA device is available, and ``ValueError`` for
    any device type other than ``cpu`` and ``cuda``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         f"expected 'cuda' or 'cpu'")
    return dev
