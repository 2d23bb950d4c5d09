"""Model FLOPs of a DeepSeek-V2 token, counted from the published
architecture as ``reference/lm.py`` computes it, never from what the
program runs (padded expert slots, the whole cache's capacity, upcasts).

A token costs two FLOPs a weight it multiplies: in every layer the
attention's projections (``wq``, ``w_dkv``, ``w_uk``, ``w_uv``, ``wo``);
the dense layers' SwiGLU; in every expert layer the router, its top
``num_experts_per_tok`` experts and the shared experts; and the head. The
embedding is a lookup. A token that attends over ``n`` positions (itself
and those before it) adds, in every layer and head, the scores
(``nope + rope`` wide) and the weighted sum of values (``v`` wide) over
them. Norms, softmaxes and RoPE are left out.
"""
from __future__ import annotations

from portbench.gen.lm import dims


def weight_macs(config) -> int:
    """Multiply-adds of a token's matrix products, attention scores
    aside."""
    d = dims(config)
    D, H = d["D"], d["H"]
    attn = (D * H * d["qk"] + D * (d["r"] + d["rope"])
            + d["r"] * H * (d["nope"] + d["v"]) + H * d["v"] * D)
    dense = 3 * D * d["I"]
    moe = D * d["E"] + d["K"] * 3 * D * d["F"] + 3 * D * d["S"]
    return (d["L"] * attn + d["dense"] * dense + (d["L"] - d["dense"]) * moe
            + D * d["V"])


def attended_macs(config) -> int:
    """Multiply-adds a token adds for each position it attends over."""
    d = dims(config)
    return d["L"] * d["H"] * (d["qk"] + d["v"])


def flops(config, tokens: int, attended: int) -> int:
    """FLOPs of ``tokens`` tokens that attend over ``attended`` positions
    in all."""
    return 2 * (tokens * weight_macs(config)
                + attended * attended_macs(config))
