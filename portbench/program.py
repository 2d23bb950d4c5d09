"""The system under test: the entries of ``repro_torch`` that the loops
drive. This is the only file of the benchmark that imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


# keys of a DeepSeek-V2 configuration that the port runs only at these values
FIXED = {"attention_bias": False, "hidden_act": "silu", "moe_layer_freq": 1,
         "n_group": 1, "q_lora_rank": None, "routed_scaling_factor": 1,
         "scoring_func": "softmax", "tie_word_embeddings": False,
         "topk_group": 1, "topk_method": "greedy", "rope_scaling": None}


class Program:
    """``repro_torch.hedm.pipeline``'s stage 1 and stage 2, and
    ``repro_torch.serve.engine.ServeSession``, on ``device``."""

    def __init__(self, device: torch.device):
        from repro_torch.hedm import pipeline
        self.pipeline = pipeline
        self.device = device

    def reduce_frames(self, frames: np.ndarray, dark: np.ndarray,
                      threshold: float,
                      timings: Optional[Dict[str, float]] = None) -> List:
        """Stage 1 of ``frames`` on the kernel: one ``ReducedFrame`` (its
        ``n_signal_pixels``, ``n_spots`` and ``peaks``) a frame, on the
        host."""
        return self.pipeline.reduce_frames(frames, dark, threshold=threshold,
                                           use_kernel=True,
                                           device=self.device,
                                           timings=timings)

    def fit_grid(self, y_obs: torch.Tensor, gvec: torch.Tensor,
                 theta0: torch.Tensor, iters: int) -> torch.Tensor:
        """Stage 2: (P, 3) fitted orientations, on the device."""
        return self.pipeline.fit_grid(y_obs, gvec, theta0, iters=iters,
                                      device=self.device)

    def serve_session(self, config: Dict, weights: Sequence[Dict],
                      batch_slots: int, capacity: int):
        """The port's ``ServeSession`` of ``batch_slots`` slots and
        ``capacity`` positions, serving the DeepSeek-V2 ``config`` (a
        configuration file's keys) with ``weights``: ``gen/lm.py``'s
        layers, then the ends, on the device, taken as they are (no copy).
        A key the port cannot run at the configured value raises, unless
        the configuration names it under ``departures``."""
        from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
        from repro_torch.models.model import Model
        from repro_torch.serve.engine import ServeSession
        c = config
        for key, value in FIXED.items():
            if c.get(key) != value and key not in c.get("departures", {}):
                raise ValueError(f"the port runs {key}={value!r} only, not "
                                 f"{c.get(key)!r}")
        cfg = ModelConfig(
            name=c["name"], family="moe", n_layers=c["num_hidden_layers"],
            d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"],
            d_ff=c["moe_intermediate_size"], vocab=c["vocab_size"],
            head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
            attention="mla", causal=True, rope_theta=float(c["rope_theta"]),
            moe=MoEConfig(
                num_experts=c["n_routed_experts"],
                top_k=c["num_experts_per_tok"],
                expert_d_ff=c["moe_intermediate_size"],
                num_shared_experts=c["n_shared_experts"],
                shared_d_ff=c["n_shared_experts"]
                * c["moe_intermediate_size"],
                norm_topk_prob=c["norm_topk_prob"],
                first_k_dense=c["first_k_dense_replace"],
                dense_d_ff=c["intermediate_size"]),
            mla=MLAConfig(kv_lora_rank=c["kv_lora_rank"], q_lora_rank=0,
                          qk_nope_head_dim=c["qk_nope_head_dim"],
                          qk_rope_head_dim=c["qk_rope_head_dim"],
                          v_head_dim=c["v_head_dim"]),
            param_dtype=c["dtype"], compute_dtype=c["dtype"],
            norm_eps=float(c["rms_norm_eps"]), tie_embeddings=False)
        n_dense = cfg.moe.first_k_dense
        state = {}
        for i, w in enumerate(weights[:-1]):
            pre = (f"stack.prefix.{i}." if i < n_dense
                   else f"stack.layers.{i - n_dense}.")
            state[pre + "norm1.scale"] = w["attn_norm"]
            state[pre + "norm2.scale"] = w["ffn_norm"]
            for n in ("wq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"):
                state[pre + "attn." + n] = w[n]
            if i < n_dense:
                for n in ("w_gate", "w_up", "w_down"):
                    state[pre + "mlp." + n] = w[n]
                continue
            state[pre + "moe.router"] = w["router"]
            for n in ("gate", "up", "down"):
                state[pre + f"moe.w_{n}"] = w["e_" + n]
                state[pre + f"moe.shared.w_{n}"] = w["s_" + n]
        ends = weights[-1]
        state.update({"embed.table": ends["embed"], "head": ends["head"],
                      "final_norm.scale": ends["final_norm"]})
        dtype = getattr(torch, cfg.param_dtype)      # no copy where it is
        state = {k: v if k.endswith("router") else v.to(dtype)
                 for k, v in state.items()}
        model = Model(cfg, None, torch.device("meta"))
        model.load_state_dict(state, strict=True, assign=True)
        return ServeSession(model, cfg, batch_slots=batch_slots,
                            capacity=capacity, device=self.device)


def serve_request(request_id: int, prompt: np.ndarray, max_new_tokens: int):
    """A request for ``Program.serve_session``'s session."""
    from repro_torch.serve.engine import Request
    return Request(request_id=request_id, prompt=prompt,
                   max_new_tokens=max_new_tokens)
