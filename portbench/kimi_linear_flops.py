"""Model FLOPs of a Kimi-Linear token, counted from the published
architecture as ``reference/kimi_linear.py`` computes it, never from what
the program runs (the experts' padded slots, the latent cache's whole
capacity, upcasts).

A token costs two FLOPs a weight it multiplies: in every KDA layer its
projections (q, k, v, the decay's and the gate's low-rank pairs, β, the
output) and the conv taps; in every MLA layer its projections (``wq``,
``w_dkv``, ``w_uk``, ``w_uv``, ``wo``); the dense layer's SwiGLU; in every
expert layer the router over all experts, the held share of its top k
(``num_experts_per_token`` x held / published experts) and the shared
expert; and the head. The embedding is a lookup. In every KDA layer a
token adds three products with the state a head (Sᵀk, the rank-1 update,
Sᵀq: 3 K V multiply-adds); a token that attends over ``n`` positions adds,
in every MLA layer and head, the scores (``nope + rope`` wide) and the
weighted sum of values (``v`` wide) over them. Norms, softmaxes, gates
and decays are left out.
"""
from __future__ import annotations

from portbench.gen.kimi_linear import dims, is_mla


def _layers(config):
    """(KDA layers, MLA layers)."""
    n_mla = sum(is_mla(config, i) for i in range(config["num_hidden_layers"]))
    return config["num_hidden_layers"] - n_mla, n_mla


def kda_weights(config) -> int:
    """Weights of one KDA layer's mixer."""
    d = dims(config)
    D, HK, lo = d["D"], d["KH"] * d["KD"], d["lora"]
    return (3 * D * HK + 3 * d["conv"] * HK + 2 * (D * lo + lo * HK)
            + D * d["KH"] + HK * D)


def weight_macs(config) -> int:
    """Multiply-adds of a token's matrix products, attention scores and
    the KDA state aside."""
    d = dims(config)
    D, H = d["D"], d["H"]
    n_kda, n_mla = _layers(config)
    mla = (D * H * d["qk"] + D * (d["r"] + d["rope"])
           + d["r"] * H * (d["nope"] + d["v"]) + H * d["v"] * D)
    dense = 3 * D * d["I"]
    moe = (D * d["E"] + d["K"] * d["El"] * 3 * D * d["F"] // d["E"]
           + 3 * D * d["S"])
    return (n_kda * kda_weights(config) + n_mla * mla + d["dense"] * dense
            + (d["L"] - d["dense"]) * moe + D * d["V"])


def state_macs(config) -> int:
    """Multiply-adds a token adds with the KDA state, over every KDA
    layer."""
    d = dims(config)
    return _layers(config)[0] * 3 * d["KH"] * d["KD"] * d["KD"]


def attended_macs(config) -> int:
    """Multiply-adds a token adds for each position it attends over."""
    d = dims(config)
    return _layers(config)[1] * d["H"] * (d["qk"] + d["v"])


def flops(config, tokens: int, attended: int) -> int:
    """FLOPs of ``tokens`` tokens that attend over ``attended`` positions
    in all."""
    return 2 * (tokens * (weight_macs(config) + state_macs(config))
                + attended * attended_macs(config))

