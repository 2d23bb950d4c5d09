"""A language model's weights and its requests, drawn from the seed.

Weights. Each of the configuration's layers, and the model's ends
(embedding, head, final norm), is drawn by a generator of its own, seeded
from ``(seed, index)``, in one large call: one flat bf16 buffer of normal
numbers that every matrix of the layer is a view of, each scaled in place
by ``1 / sqrt(fan-in)``; the router, which the program keeps in float32,
is one float32 call more; RMSNorm scales are 1. So the program's set-up
draws every layer once, and the reference draws one layer again, to the
same bits on the same device, when it needs it.

Names are those of the architecture, ``(in, out)`` for a matrix:
``attn_norm``, ``wq``, ``w_dkv`` (the joint down-projection: latent, then
the shared rope key), ``kv_norm``, ``w_uk``, ``w_uv``, ``wo``,
``ffn_norm``; a dense layer ``w_gate``, ``w_up``, ``w_down``; an expert
layer ``router``, ``e_gate``, ``e_up`` (E, in, out), ``e_down`` and the
shared experts as one MLP ``s_gate``, ``s_up``, ``s_down``. The ends:
``embed`` (V, D), ``head`` (D, V), ``final_norm``.

Requests. ``requests`` gives every seed the same multiset of prompt and
answer lengths, log-uniform by strata over the mix's ranges, in an order
drawn from the seed; prompt ids are uniform over the vocabulary.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

BF16 = torch.bfloat16


def _seed(seed: int, index: int) -> int:
    return (seed * 0x9E3779B1 + 7919 * index + 1) % 2 ** 63


def dims(config) -> Dict[str, int]:
    c = config
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    return {"D": c["hidden_size"], "H": c["num_attention_heads"],
            "nope": nope, "rope": rope, "qk": nope + rope,
            "v": c["v_head_dim"], "r": c["kv_lora_rank"],
            "E": c["n_routed_experts"], "K": c["num_experts_per_tok"],
            "F": c["moe_intermediate_size"],
            "S": c["n_shared_experts"] * c["moe_intermediate_size"],
            "I": c["intermediate_size"], "V": c["vocab_size"],
            "L": c["num_hidden_layers"], "dense": c["first_k_dense_replace"]}


def layer_shapes(config, index: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """The bf16 matrices of layer ``index`` (``num_hidden_layers`` for the
    model's ends), in the order they are drawn; each scaled by its
    second-to-last dimension's ``1 / sqrt``."""
    d = dims(config)
    D, H = d["D"], d["H"]
    if index == d["L"]:
        return [("embed", (d["V"], D)), ("head", (D, d["V"]))]
    out = [("wq", (D, H * d["qk"])), ("w_dkv", (D, d["r"] + d["rope"])),
           ("w_uk", (d["r"], H * d["nope"])), ("w_uv", (d["r"], H * d["v"])),
           ("wo", (H * d["v"], D))]
    if index < d["dense"]:
        return out + [("w_gate", (D, d["I"])), ("w_up", (D, d["I"])),
                      ("w_down", (d["I"], D))]
    E, F, S = d["E"], d["F"], d["S"]
    return out + [("e_gate", (E, D, F)), ("e_up", (E, D, F)),
                  ("e_down", (E, F, D)), ("s_gate", (D, S)),
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
            w.mul_(shape[-2] ** -0.5)
        out[name] = w
    ones = torch.ones(d["D"], dtype=BF16, device=device)
    if index == d["L"]:
        out["final_norm"] = ones
        return out
    out["attn_norm"], out["ffn_norm"] = ones, ones.clone()
    out["kv_norm"] = torch.ones(d["r"], dtype=BF16, device=device)
    if index >= d["dense"]:
        out["router"] = torch.randn((d["D"], d["E"]), generator=gen,
                                    device=device) * d["D"] ** -0.5
    return out


def model(config, seed: int, device: torch.device
          ) -> List[Dict[str, torch.Tensor]]:
    """Every layer's weights, then the ends'."""
    return [layer(config, seed, i, device)
            for i in range(config["num_hidden_layers"] + 1)]


def strata(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` lengths log-uniform over [lo, hi] by strata: the midpoints of
    ``n`` equal steps of ``log``, rounded."""
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
                   ).astype(np.int64)


def requests(config, mix, seed: int):
    """``(clients, first)``: each client's requests as ``(prompt int32,
    answer tokens)``, and the fractions of its answer that each client's
    first request still has to serve when the window opens (drawn once,
    the same multiset for every seed)."""
    rng = np.random.default_rng(seed % 2 ** 64)
    n_clients, per = int(mix["clients"]), int(mix["requests_per_client"])
    n = n_clients * per
    prompts = rng.permutation(strata(n, *mix["prompt_tokens"]))
    answers = rng.permutation(strata(n, *mix["answer_tokens"]))
    vocab = config["vocab_size"]
    reqs = [(rng.integers(0, vocab, int(p), dtype=np.int32), int(a))
            for p, a in zip(prompts, answers)]
    clients = [reqs[c * per:(c + 1) * per] for c in range(n_clients)]
    first = (rng.permutation(n_clients) + 1.0) / n_clients
    return clients, first


def warmup_prompt(config, mix, seed: int) -> np.ndarray:
    """A prompt of the mix's longest length, so that set-up meets the
    largest prefill before the window."""
    rng = np.random.default_rng((seed % 2 ** 64, 1))
    return rng.integers(0, config["vocab_size"], mix["prompt_tokens"][1],
                        dtype=np.int32)
