"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 [arXiv:2401.16818;
unverified]. SWA window 4096 (mistral-style); bounded KV makes long_500k
decode runnable.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    head_dim=120,
    attention="gqa",
    sliding_window=4096,
    causal=True,
    rope_theta=1e4,
    source="arXiv:2401.16818; unverified",
)
