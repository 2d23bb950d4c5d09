"""The system under test for the Kimi-Linear cells: the port's
``ServeSession`` over its ``Model``, serving the weights that
``gen/kimi_linear.py`` drew, and the port's tracing that a ``--trace 1``
run records into. Beside ``program.py``, the only files of the benchmark
that import the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

# keys of a Kimi-Linear configuration that the port runs only at these
# values (one expert group: the grouped top-k is the plain top-k)
FIXED = {"hidden_act": "silu", "moe_layer_freq": 1, "num_expert_group": 1,
         "topk_group": 1, "q_lora_rank": None, "rope_scaling": None,
         "tie_word_embeddings": False, "num_nextn_predict_layers": 0,
         "moe_router_activation_func": "sigmoid", "moe_renormalize": True,
         "mla_use_nope": True}


def model_config(config: Dict):
    """The port's ``ModelConfig`` of a configuration file's keys. A key
    the port cannot run at the configured value raises."""
    from repro_torch.configs.base import (KDAConfig, MLAConfig, ModelConfig,
                                          MoEConfig)
    c = config
    for key, value in FIXED.items():
        if c.get(key) != value:
            raise ValueError(f"the port runs {key}={value!r} only, not "
                             f"{c.get(key)!r}")
    lin = c["linear_attn_config"]
    L, F = c["num_hidden_layers"], c["moe_intermediate_size"]
    return ModelConfig(
        name=c["name"], family="hybrid", n_layers=L,
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=F, vocab=c["vocab_size"],
        head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
        attention="mla", causal=True, rope_theta=float(c["rope_theta"]),
        layer_mixers=tuple("attn" if i + 1 in lin["full_attn_layers"]
                           else "kda" for i in range(L)),
        moe=MoEConfig(
            num_experts=c["num_experts_published"],
            top_k=c["num_experts_per_token"], expert_d_ff=F,
            num_shared_experts=c["num_shared_experts"],
            shared_d_ff=c["num_shared_experts"] * F,
            norm_topk_prob=c["moe_renormalize"],
            first_k_dense=c["first_k_dense_replace"],
            dense_d_ff=c["intermediate_size"], scoring="sigmoid",
            routed_scaling=float(c["routed_scaling_factor"]),
            held_experts=c["num_experts"],
            held_from=c["experts_held_from"], dropless=True),
        mla=MLAConfig(kv_lora_rank=c["kv_lora_rank"], q_lora_rank=0,
                      qk_nope_head_dim=c["qk_nope_head_dim"],
                      qk_rope_head_dim=c["qk_rope_head_dim"],
                      v_head_dim=c["v_head_dim"],
                      rope=not c["mla_use_nope"]),
        kda=KDAConfig(num_heads=lin["num_heads"], head_dim=lin["head_dim"],
                      conv_size=lin["short_conv_kernel_size"]),
        param_dtype=c["dtype"], compute_dtype=c["dtype"],
        norm_eps=float(c["rms_norm_eps"]), tie_embeddings=False)


# the generator's names that the port keeps in float32
FLOAT32 = ("router", "router_bias", "A_log", "dt_bias")


def serve_session(config: Dict, weights: Sequence[Dict], batch_slots: int,
                  capacity: int, device: torch.device):
    """The port's ``ServeSession`` of ``batch_slots`` slots and
    ``capacity`` positions serving Kimi-Linear (``config``, a
    configuration file's keys) with ``weights``: ``gen/kimi_linear.py``'s
    layers, then the ends, on the device, taken as they are (no copy)."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeSession
    cfg = model_config(config)
    n_dense = cfg.moe.first_k_dense
    state = {}
    for i, w in enumerate(weights[:-1]):
        pre = (f"stack.prefix.{i}." if i < n_dense
               else f"stack.layers.{i - n_dense}.")
        mixer = "kda." if cfg.layer_mixers[i] == "kda" else "attn."
        for name, t in w.items():
            if name == "attn_norm":
                state[pre + "norm1.scale"] = t
            elif name == "ffn_norm":
                state[pre + "norm2.scale"] = t
            elif name in ("w_gate", "w_up", "w_down"):
                state[pre + "mlp." + name] = t
            elif name.startswith(("e_", "s_")):
                where = "moe.w_" if name[0] == "e" else "moe.shared.w_"
                state[pre + where + name[2:]] = t
            elif name.startswith("router"):
                state[pre + "moe." + name] = t
            else:
                state[pre + mixer + name] = (t.view(-1) if name == "g_bias"
                                             else t)
    ends = weights[-1]
    state.update({"embed.table": ends["embed"], "head": ends["head"],
                  "final_norm.scale": ends["final_norm"]})
    dtype = getattr(torch, cfg.param_dtype)          # no copy where it is
    state = {k: v if k.rsplit(".", 1)[-1] in FLOAT32 else v.to(dtype)
             for k, v in state.items()}
    model = Model(cfg, None, torch.device("meta"))
    model.load_state_dict(state, strict=True, assign=True)
    return ServeSession(model, cfg, batch_slots=batch_slots,
                        capacity=capacity, device=device)


def first_kda_state(session, slot: int) -> torch.Tensor:
    """A copy of the state (H, K, V) float32 that the session's first KDA
    layer holds in batch slot ``slot``."""
    from repro_torch.models.kda import KDAState
    for kind in ("prefix", "layers"):
        for cache in session.caches.get(kind, []):
            if isinstance(cache, KDAState):
                return cache.s[slot].clone()
    raise ValueError("the session holds no KDA state")


def first_mla_latent(session, slot: int, positions: int) -> torch.Tensor:
    """A copy, float32, of what the session's first MLA layer caches in
    batch slot ``slot`` at its first ``positions`` positions: the latent
    c_kv and the rope key, ``[c_kv, k_rope]`` (positions, r + rope)."""
    from repro_torch.models.attention import KVCache
    for kind in ("prefix", "layers"):
        for cache in session.caches.get(kind, []):
            if isinstance(cache, KVCache):
                return torch.cat([cache.k[slot, :positions],
                                  cache.v[slot, :positions]], dim=-1).float()
    raise ValueError("the session holds no latent cache")


def tracer():
    """A recording tracer of the port (``repro_torch.core.telemetry``)."""
    from repro_torch.core import telemetry
    return telemetry.Tracer()


def recording(tr):
    """Make ``tr`` current: the session records its spans into it."""
    from repro_torch.core import telemetry
    return telemetry.recording(tr)
