"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768
vocab=151936, 128 experts top-8, qk_norm [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                 # per-expert hidden size (assigned d_ff)
    vocab=151936,
    head_dim=128,
    attention="gqa",
    qk_norm=True,
    causal=True,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768,
                  norm_topk_prob=True, capacity_factor=1.25),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
