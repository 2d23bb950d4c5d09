"""Architecture / run configuration schema.

Every assigned architecture is expressed as a ``ModelConfig``. The config is a
plain frozen dataclass (hashable, usable as a jit static argument) and fully
describes the model: block pattern (dense / moe / mamba2 / rwkv6 / hybrid),
attention flavor (GQA / MLA / SWA / bidirectional), and modality frontend.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    num_experts: int = 0               # routed experts
    top_k: int = 0
    expert_d_ff: int = 0               # per-expert FFN hidden size
    num_shared_experts: int = 0        # always-on shared experts (deepseek style)
    shared_d_ff: int = 0               # hidden size of the shared expert(s), total
    capacity_factor: float = 1.25      # dispatch capacity (GSPMD-style dense dispatch)
    norm_topk_prob: bool = True        # renormalize top-k router weights
    router_dtype: str = "float32"      # router math dtype (stability)
    first_k_dense: int = 0             # first k layers use a dense FFN instead (deepseek)
    dense_d_ff: int = 0                # d_ff of those dense layers
    scoring: str = "softmax"           # softmax | sigmoid (with a selection-only bias)
    routed_scaling: float = 1.0        # routed experts' weights scaled by this
    held_experts: int = 0              # experts held here (0 => all), from held_from:
    held_from: int = 0                 # an expert-parallel rank's share at world size 1
    dropless: bool = False             # inference: capacity = the largest load (read on the host)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0               # 0 => full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope: bool = True                  # False => q_rope and k_rope not rotated (NoPE)


@dataclass(frozen=True)
class KDAConfig:
    """Kimi Delta Attention (arXiv:2510.26692): a gated delta rule with a
    decay per key channel, after a short causal conv on q, k and v."""
    num_heads: int = 32
    head_dim: int = 128                # K = V
    conv_size: int = 4                 # the decay's and the gate's low rank is head_dim
    chunk: int = 64                    # chunk length of the prefill's closed form


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1                  # groups for B/C projections
    chunk: int = 128                   # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" block configuration."""
    head_dim: int = 64
    decay_lora: int = 64               # low-rank data-dependent decay adapter
    mix_lora: int = 32                 # token-shift mixing adapter rank
    gate_lora: int = 64


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB ([vlm]/[audio]): precomputed embeddings in."""
    kind: str = "none"                 # none | vision_patches | audio_frames
    feature_dim: int = 0               # incoming precomputed embedding dim
    num_prefix_tokens: int = 0         # vision: image tokens prepended to text


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 => d_model // n_heads
    # --- attention flavor ---
    attention: str = "gqa"             # gqa | mla | none
    causal: bool = True                # False => encoder-only (bidirectional)
    sliding_window: int = 0            # 0 => full attention; >0 => SWA window
    qk_norm: bool = False              # qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False             # qwen2-style bias on q,k,v projections
    rope_theta: float = 1e6
    # --- block pattern ---
    block_pattern: str = "uniform"     # uniform | zamba_hybrid
    attn_every: int = 0                # zamba: shared attn block every k mamba blocks
    block_kind: str = "attn_mlp"       # attn_mlp | mamba2 | rwkv6
    layer_mixers: Tuple[str, ...] = () # per layer "kda" | "attn" (empty => all attn)
    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    kda: Optional[KDAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- notes ---
    source: str = ""                   # provenance tag from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE counts shared + top_k experts only."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                          # train | prefill | decode
    seq_len: int
    global_batch: int
    # training-only knobs
    num_microbatches: int = 1          # grad-accumulation microbatches
    remat: bool = True


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def with_overrides(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)


VOCAB_PAD_MULTIPLE = 256


def padded_vocab(vocab: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    """Megatron-style vocab padding: embedding/head tables are padded to a
    multiple of 256 so the vocab dim shards cleanly over tp; pad logits are
    masked to -inf in the loss/sampler."""
    return ((vocab + multiple - 1) // multiple) * multiple


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests.

    Small layers/width/experts/vocab as the instructions require; preserves the
    structural features (GQA ratio, MLA ranks scaled, MoE routing, hybrid
    pattern) so the smoke test exercises the same code paths.
    """
    n_heads = max(4, min(cfg.n_heads, 4))
    ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    n_kv = max(1, n_heads // ratio)
    kw = dict(
        n_layers=min(cfg.n_layers, 4) if cfg.block_pattern == "uniform" else 7,
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=256,
        vocab=512,
        head_dim=32,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.attn_every:
        kw["attn_every"] = 3
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            shared_d_ff=64 if cfg.moe.num_shared_experts else 0,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            dense_d_ff=128 if cfg.moe.first_k_dense else 0,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            kv_lora_rank=32, q_lora_rank=0,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            rope=cfg.mla.rope,
        )
    if cfg.layer_mixers:
        kw["layer_mixers"] = cfg.layer_mixers[:kw["n_layers"]]
    if cfg.kda is not None:
        kw["kda"] = dataclasses.replace(cfg.kda, num_heads=4, head_dim=32,
                                        chunk=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=32)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_dim=32, decay_lora=16, mix_lora=8, gate_lora=16)
    if cfg.frontend.kind != "none":
        kw["frontend"] = dataclasses.replace(
            cfg.frontend, feature_dim=64,
            num_prefix_tokens=min(cfg.frontend.num_prefix_tokens, 8) or 0,
        )
    return with_overrides(cfg, **kw)
