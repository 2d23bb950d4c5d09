"""rwkv6-3b [ssm] — "Finch": attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf].
Time-mix (WKV6 recurrence, 40 heads of 64) + channel-mix FFN. O(1)-state
decode makes long_500k runnable.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                # d_model / head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    head_dim=64,
    attention="none",
    causal=True,
    block_kind="rwkv6",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, gate_lora=64),
    source="arXiv:2404.05892; hf",
)
