"""Architecture registry: maps --arch ids to ModelConfigs + shape cells."""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, smoke_variant

ARCH_IDS = [
    "internvl2_2b",
    "zamba2_7b",
    "qwen2_72b",
    "h2o_danube3_4b",
    "internlm2_20b",
    "qwen3_32b",
    "hubert_xlarge",
    "qwen3_moe_30b_a3b",
    "deepseek_v2_lite_16b",
    "rwkv6_3b",
]

# served by the port only: the JAX package has no counterpart, so the suites
# that hold each of ARCH_IDS to it leave these out
SERVED_IDS = [
    "kimi_linear_48b_a3b",
]

# canonical external ids (with dashes) also accepted on the CLI
_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS + SERVED_IDS}
_ALIASES["h2o-danube-3-4b"] = "h2o_danube3_4b"  # assigned spelling


def canonical(arch: str) -> str:
    """Resolve dashed/underscored arch spellings to the canonical id."""
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCH_IDS + SERVED_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{ARCH_IDS + SERVED_IDS}")
    return arch


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))


def supported_shapes(cfg: ModelConfig) -> List[str]:
    """Which assigned shape cells are runnable for this arch.

    Skip rules (documented in DESIGN.md §Arch-applicability):
      - encoder-only (causal=False): no decode step -> skip decode_32k, long_500k
      - long_500k needs sub-quadratic context: run for ssm / hybrid /
        sliding-window archs only.
    """
    shapes = ["train_4k", "prefill_32k"]
    if cfg.causal:
        shapes.append("decode_32k")
        sub_quadratic = (
            cfg.block_kind in ("mamba2", "rwkv6")
            or cfg.block_pattern == "zamba_hybrid"
            or cfg.sliding_window > 0
        )
        if sub_quadratic:
            shapes.append("long_500k")
    return shapes


def all_cells() -> List[Tuple[str, str]]:
    """All runnable (arch, shape) cells."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in supported_shapes(cfg):
            cells.append((arch, s))
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    """(arch, shape, reason) for every documented skip."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        have = set(supported_shapes(cfg))
        for s in SHAPES:
            if s in have:
                continue
            if not cfg.causal:
                out.append((arch, s, "encoder-only: no decode step"))
            else:
                out.append((arch, s, "full attention: long_500k needs sub-quadratic context"))
    return out
