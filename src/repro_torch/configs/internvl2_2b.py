"""internvl2-2b [vlm] — InternViT frontend (STUB) + InternLM2-1.8B backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821; hf].
The vision tower is a modality frontend STUB: input_specs() provides
precomputed patch embeddings (InternViT-300M output dim 1024), projected by
the mlp1 connector and prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig, FrontendConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    attention="gqa",
    causal=True,
    rope_theta=1e6,
    frontend=FrontendConfig(kind="vision_patches", feature_dim=1024,
                            num_prefix_tokens=256),
    source="arXiv:2404.16821; hf",
)
