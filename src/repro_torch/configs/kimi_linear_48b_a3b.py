"""kimi-linear-48b-a3b [hybrid moe] — KDA linear attention beside NoPE MLA.

27L d_model=2304 vocab=163840 [arXiv:2510.26692; hf
moonshotai/Kimi-Linear-48B-A3B-Instruct config.json]. Layers 4, 8, 12,
16, 20, 24 and 27 (1-based) are MLA without positional encoding
(``mla_use_nope``): 32 heads, q/k 128 + 64, v 128, latent 512, full-rank
q. The other 20 are Kimi Delta Attention: 32 heads of 128, a short conv
of 4. The first layer's FFN is dense (9,216); the other 26 are MoE: 256
experts of 1,024, top 8 by a sigmoid router with a selection-only
correction bias, renormalised and scaled by 2.446, and one shared
expert; no token is dropped (``dropless``: the selection bias loads
some experts past the port's inference capacity factor).

Served only (``registry.SERVED_IDS``): the JAX package has no KDA, so the
parity suites that walk ``ARCH_IDS`` leave it out. The whole model (all
256 experts, 48 B parameters) is this config; a deployment that holds a
share of the experts on each card sets ``moe.held_experts`` and
``moe.held_from`` (the benchmark's cell holds 64).
"""
from repro_torch.configs.base import KDAConfig, MLAConfig, ModelConfig, MoEConfig

#: 1-based layers that are MLA, as the config's ``full_attn_layers``
MLA_LAYERS = (4, 8, 12, 16, 20, 24, 27)

CONFIG = ModelConfig(
    name="kimi-linear-48b-a3b",
    family="hybrid",
    n_layers=27,
    d_model=2304,
    n_heads=32,
    n_kv_heads=32,             # MLA: all heads share the latent KV
    d_ff=1024,                 # per-expert hidden size
    vocab=163840,
    head_dim=192,              # MLA's qk_nope(128) + qk_rope(64)
    attention="mla",
    causal=True,
    rope_theta=1e4,            # unused: every MLA layer is NoPE
    layer_mixers=tuple("attn" if i + 1 in MLA_LAYERS else "kda"
                       for i in range(27)),
    moe=MoEConfig(num_experts=256, top_k=8, expert_d_ff=1024,
                  num_shared_experts=1, shared_d_ff=1024,
                  norm_topk_prob=True, first_k_dense=1, dense_d_ff=9216,
                  scoring="sigmoid", routed_scaling=2.446, dropless=True),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128, rope=False),
    kda=KDAConfig(num_heads=32, head_dim=128, conv_size=4, chunk=64),
    norm_eps=1e-5,
    source="arXiv:2510.26692; hf",
)
