"""Kimi-Linear-48B-A3B's weights, drawn from the seed as ``gen/lm.py``
draws DeepSeek-V2's, and its requests (``gen/lm.py``'s, reused).

Each layer, and the model's ends, is drawn by a generator of its own,
seeded from ``(seed, index)`` (``gen/lm.py``'s ``_seed``): one flat bf16
buffer of normal numbers that every matrix of the layer is a view of, each
scaled in place by ``1 / sqrt`` of its second-to-last dimension (and
``f_b`` by ``F_B_GAIN`` more), then one float32 call for what the program
keeps in float32. RMSNorm scales are 1. So the program's set-up draws
every layer once and the reference draws one layer again, to the same
bits on the same device, when it needs it.

Names, ``(in, out)`` for a matrix. Every layer: ``attn_norm``,
``ffn_norm``. A KDA layer: ``wq``, ``wk``, ``wv``; ``conv_q``,
``conv_k``, ``conv_v`` (taps, channels); ``f_a``, ``f_b``; ``w_beta``;
``g_a``, ``g_b``, ``g_bias`` (1, H*K); ``wo``; ``o_norm`` (K,); float32
``A_log`` (H,) and ``dt_bias`` (H*K,). An MLA layer: ``wq``, ``w_dkv``
(the latent, then the shared 64-wide key column), ``kv_norm``, ``w_uk``,
``w_uv``, ``wo``. The dense first layer: ``w_gate``, ``w_up``,
``w_down``. An expert layer: float32 ``router`` (D, 256) and
``router_bias`` (256,), the held experts ``e_gate``, ``e_up`` (E held, D,
F) and ``e_down``, the shared expert ``s_gate``, ``s_up``, ``s_down``.
The ends: ``embed`` (V, D), ``head`` (D, V), ``final_norm``.

Drawn so that the decay carries hundreds of tokens: A = exp(A_log)
uniform over [1, 16]; dt = softplus(dt_bias) log-uniform over
[1e-3, 1e-1]; ``f_b`` small (``F_B_GAIN``), so softplus(f + dt_bias)
stays near dt and most channels decay by exp(g) in (0.9, 1) a token.
``router_bias`` is normal with deviation ``BIAS_STD``, which changes the
top 8 of about three tokens in five.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.gen.lm import _seed, requests, strata, warmup_prompt  # noqa: F401

BF16 = torch.bfloat16
F_B_GAIN = 0.1
BIAS_STD = 0.01


def dims(config) -> Dict[str, int]:
    c = config
    lin = c["linear_attn_config"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    return {"D": c["hidden_size"], "H": c["num_attention_heads"],
            "nope": nope, "rope": rope, "qk": nope + rope,
            "v": c["v_head_dim"], "r": c["kv_lora_rank"],
            "E": c["num_experts_published"], "El": c["num_experts"],
            "e0": c["experts_held_from"], "K": c["num_experts_per_token"],
            "F": c["moe_intermediate_size"],
            "S": c["num_shared_experts"] * c["moe_intermediate_size"],
            "I": c["intermediate_size"], "V": c["vocab_size"],
            "L": c["num_hidden_layers"], "dense": c["first_k_dense_replace"],
            "KH": lin["num_heads"], "KD": lin["head_dim"],
            "conv": lin["short_conv_kernel_size"], "lora": lin["head_dim"],
            "scale": c["routed_scaling_factor"]}


def is_mla(config, index: int) -> bool:
    """Layer ``index`` (0-based) is MLA, else KDA."""
    return index + 1 in config["linear_attn_config"]["full_attn_layers"]


def layer_shapes(config, index: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """The bf16 matrices of layer ``index`` (``num_hidden_layers`` for the
    model's ends), in the order they are drawn."""
    d = dims(config)
    D = d["D"]
    if index == d["L"]:
        return [("embed", (d["V"], D)), ("head", (D, d["V"]))]
    if is_mla(config, index):
        H = d["H"]
        out = [("wq", (D, H * d["qk"])), ("w_dkv", (D, d["r"] + d["rope"])),
               ("w_uk", (d["r"], H * d["nope"])),
               ("w_uv", (d["r"], H * d["v"])), ("wo", (H * d["v"], D))]
    else:
        HK = d["KH"] * d["KD"]
        out = [("wq", (D, HK)), ("wk", (D, HK)), ("wv", (D, HK)),
               ("conv_q", (d["conv"], HK)), ("conv_k", (d["conv"], HK)),
               ("conv_v", (d["conv"], HK)), ("f_a", (D, d["lora"])),
               ("f_b", (d["lora"], HK)), ("w_beta", (D, d["KH"])),
               ("g_a", (D, d["lora"])), ("g_b", (d["lora"], HK)),
               ("g_bias", (1, HK)), ("wo", (HK, D))]
    if index < d["dense"]:
        return out + [("w_gate", (D, d["I"])), ("w_up", (D, d["I"])),
                      ("w_down", (d["I"], D))]
    El, F, S = d["El"], d["F"], d["S"]
    return out + [("e_gate", (El, D, F)), ("e_up", (El, D, F)),
                  ("e_down", (El, F, D)), ("s_gate", (D, S)),
                  ("s_up", (D, S)), ("s_down", (S, D))]


def layer(config, seed: int, index: int,
          device: torch.device) -> Dict[str, torch.Tensor]:
    """Layer ``index``'s weights (``num_hidden_layers``: the ends)."""
    d = dims(config)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, index))
    shapes = layer_shapes(config, index)
    flat = torch.randn(sum(math.prod(s) for _, s in shapes), dtype=BF16,
                       generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        if name != "embed":
            w.mul_(shape[-2] ** -0.5 * (F_B_GAIN if name == "f_b" else 1.0))
        out[name] = w
    ones = torch.ones(d["D"], dtype=BF16, device=device)
    if index == d["L"]:
        out["final_norm"] = ones
        return out
    out["attn_norm"], out["ffn_norm"] = ones, ones.clone()
    if is_mla(config, index):
        out["kv_norm"] = torch.ones(d["r"], dtype=BF16, device=device)
    else:
        HK = d["KH"] * d["KD"]
        out["o_norm"] = torch.ones(d["KD"], dtype=BF16, device=device)
        u = torch.rand(d["KH"] + HK, generator=gen, device=device)
        out["A_log"] = torch.log(1.0 + 15.0 * u[:d["KH"]])
        dt = torch.exp(math.log(1e-3) + u[d["KH"]:] * math.log(100.0))
        out["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    if index >= d["dense"]:
        r = torch.randn(d["D"] * d["E"] + d["E"], generator=gen,
                        device=device)
        out["router"] = r[:d["D"] * d["E"]].view(d["D"], d["E"]) \
            * d["D"] ** -0.5
        out["router_bias"] = r[d["D"] * d["E"]:] * BIAS_STD
    return out


def model(config, seed: int, device: torch.device
          ) -> List[Dict[str, torch.Tensor]]:
    """Every layer's weights, then the ends'."""
    return [layer(config, seed, i, device)
            for i in range(config["num_hidden_layers"] + 1)]
