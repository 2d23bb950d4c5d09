"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE.

27L d_model=2048 16H (kv via MLA latent) d_ff(expert)=1408 vocab=102400,
MoE 64 routed experts top-6 + 2 shared, MLA kv_lora=512
[arXiv:2405.04434; hf].

NOTE on the assignment line "2 shared+160 routed top-6": 160 routed is the
full DeepSeek-V2 config; V2-LITE has 64 routed experts (matching the
assignment's own "MoE 64e top-6"). We follow 64 routed + 2 shared, top-6.
First layer uses a dense FFN (d_ff 10944), per the published config.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,             # MLA: all heads share the latent KV
    d_ff=1408,                 # per-expert hidden size (assigned d_ff)
    vocab=102400,
    head_dim=192,              # qk_nope(128) + qk_rope(64)
    attention="mla",
    causal=True,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared_experts=2, shared_d_ff=2816,
                  norm_topk_prob=False, capacity_factor=1.25,
                  first_k_dense=1, dense_d_ff=10944),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434; hf",
)
