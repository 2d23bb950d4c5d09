"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified]. Zamba2 applies a SHARED transformer block
(full-rank weights shared across call sites, per-site LoRA deltas) every
`attn_every` Mamba2 blocks; we reproduce that pattern (attn_every=6 ->
14 shared-attn call sites over 81 mamba layers).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,          # MHA in the shared block (kv=32)
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    attention="gqa",
    causal=True,
    block_pattern="zamba_hybrid",
    block_kind="mamba2",
    attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    source="arXiv:2411.15242; unverified",
)
