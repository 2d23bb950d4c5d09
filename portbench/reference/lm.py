"""DeepSeek-V2's forward pass in plain float32 PyTorch: no kernel, no
cache, no batching; TF32 off.

Per layer (arXiv:2405.04434 §2.1, the Lite model: q not low-rank):

1. ``h = rmsnorm(x)``; ``q = h wq`` per head, split into ``q_nope`` and
   ``q_rope``; ``[c, k_rope] = h w_dkv``, ``c = rmsnorm(c)`` (the latent);
   RoPE on ``q_rope`` and on ``k_rope``, which every head shares;
2. ``k_nope = c w_uk``, ``v = c w_uv`` per head; causal softmax of
   ``(q_nope k_nope + q_rope k_rope) / sqrt(nope + rope)``; the heads'
   outputs through ``wo``, added to ``x``;
3. ``h = rmsnorm(x)``; the first ``first_k_dense_replace`` layers a SwiGLU
   MLP, the others the experts: softmax over the router's logits, the
   top ``num_experts_per_tok`` experts weighted by their probabilities
   (``norm_topk_prob`` false, ``routed_scaling_factor`` 1), each a
   SwiGLU MLP, plus the shared experts' MLP; added to ``x``;

then ``rmsnorm`` and the head. RoPE is the split-half rotation at
``rope_theta`` without YaRN, as the program runs it (the configuration's
``departures``). Weights come from ``gen/lm.py``, drawn again one layer at
a time on the device and upcast, so the whole model is never held here.

``served_gaps`` runs the sequences teacher-forced (prompt, then the
served tokens) and returns, at each served position, how far the served
token's logit lies below the reference's largest. With ``control`` a
second stream runs beside it on the same weights rounded to float8 e4m3
(one scale a tensor), and the gap read is that of the token the control
puts first: the reference one precision down in the program's place.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.gen import lm as gen_lm

Q_BLOCK = 1024          # query rows a softmax at once
HEAD_BLOCK = 1024       # positions a head product at once
FP8_MAX = 448.0         # float8 e4m3's largest value


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE of x (S, ..., d) at positions 0..S-1."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
    ang = (ang[:, None] * inv).reshape((x.shape[0],) + (1,) * (x.dim() - 2)
                                       + (d // 2,))
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def attention(h: torch.Tensor, w: Dict[str, torch.Tensor], d: Dict,
              theta: float, eps: float) -> torch.Tensor:
    """Causal MLA over one sequence h (S, D)."""
    S, H = h.shape[0], d["H"]
    q = (h @ w["wq"]).view(S, H, d["qk"])
    q_nope, q_rope = q.split([d["nope"], d["rope"]], dim=-1)
    q_rope = rope(q_rope, theta)
    c, k_rope = (h @ w["w_dkv"]).split([d["r"], d["rope"]], dim=-1)
    c = rmsnorm(c, w["kv_norm"], eps)
    k_rope = rope(k_rope, theta)
    k_nope = (c @ w["w_uk"]).view(S, H, d["nope"])
    v = (c @ w["w_uv"]).view(S, H, d["v"])
    scale = d["qk"] ** -0.5
    out = torch.empty((S, H, d["v"]), device=h.device)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        s = (torch.einsum("qhe,khe->hqk", q_nope[q0:q1], k_nope[:q1])
             + torch.einsum("qhe,ke->hqk", q_rope[q0:q1], k_rope[:q1]))
        causal = (torch.arange(q1, device=h.device)[None, :]
                  > torch.arange(q0, q1, device=h.device)[:, None])
        p = torch.softmax((s * scale).masked_fill(causal, float("-inf")),
                          dim=-1)
        out[q0:q1] = torch.einsum("hqk,khe->qhe", p, v[:q1])
    return out.reshape(S, H * d["v"]) @ w["wo"]


def experts(h: torch.Tensor, w: Dict[str, torch.Tensor],
            d: Dict) -> torch.Tensor:
    """The routed experts (top-k of the softmax, unnormalised) and the
    shared ones, over rows h (N, D)."""
    probs = torch.softmax(h @ w["router"], dim=-1)
    top_p, top_e = torch.topk(probs, d["K"], dim=-1)
    out = swiglu(h, w["s_gate"], w["s_up"], w["s_down"])
    for e in torch.unique(top_e).tolist():
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        y = swiglu(h[rows], w["e_gate"][e], w["e_up"][e], w["e_down"][e])
        out.index_add_(0, rows, y * top_p[rows, slot][:, None])
    return out


def fp8_rounded(w: torch.Tensor) -> torch.Tensor:
    """w through float8 e4m3 and back, one scale for the tensor (its
    largest magnitude maps to e4m3's largest value)."""
    if w.dim() < 2:
        return w
    scale = w.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _weights(config, seed: int, index: int, device, control: bool):
    raw = gen_lm.layer(config, seed, index, device)
    ref = {k: v.float() for k, v in raw.items()}
    del raw
    return ref, ({k: fp8_rounded(v) for k, v in ref.items()}
                 if control else None)


def _block(x: torch.Tensor, bounds: Sequence[Tuple[int, int]],
           w: Dict[str, torch.Tensor], d: Dict, dense: bool, theta: float,
           eps: float) -> torch.Tensor:
    """One layer over the sequences that lie at ``bounds`` in x (N, D)."""
    h = rmsnorm(x, w["attn_norm"], eps)
    x = x + torch.cat([attention(h[a:b], w, d, theta, eps)
                       for a, b in bounds])
    h = rmsnorm(x, w["ffn_norm"], eps)
    if dense:
        return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
    return x + experts(h, w, d)


@contextlib.contextmanager
def _fp32():
    """Float32 products without TF32, and no graph."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def served_gaps(config, seed: int,
                seqs: Sequence[Tuple[np.ndarray, Sequence[int]]],
                device: torch.device, control: bool = False
                ) -> List[np.ndarray]:
    """For each ``(prompt, served)``: the reference's largest logit less
    the logit of the served token (with ``control``, of the control's
    first token) at each served position, float64."""
    with _fp32():
        return _served_gaps(config, seed, seqs, device, control,
                            gen_lm.dims(config),
                            float(config["rms_norm_eps"]),
                            float(config["rope_theta"]))


def _final(config, seed, ids: Sequence[np.ndarray], device, control: bool,
           d, eps, theta):
    """The final-normed hidden states (N, D) of the sequences ``ids`` laid
    end to end, their bounds, and the head (with ``control``, the same of
    the float8 stream too)."""
    bounds, at = [], 0
    for toks in ids:
        bounds.append((at, at + len(toks)))
        at += len(toks)
    tokens = torch.from_numpy(np.concatenate(ids).astype(np.int64)).to(device)
    ends, _ = _weights(config, seed, d["L"], device, False)
    x = ends["embed"][tokens]
    xc = fp8_rounded(ends["embed"])[tokens] if control else None
    del ends
    for i in range(d["L"]):
        w, wc = _weights(config, seed, i, device, control)
        dense = i < d["dense"]
        x = _block(x, bounds, w, d, dense, theta, eps)
        if control:
            xc = _block(xc, bounds, wc, d, dense, theta, eps)
        del w, wc
    ends, ends_c = _weights(config, seed, d["L"], device, control)
    x = rmsnorm(x, ends["final_norm"], eps)
    if control:
        xc = (rmsnorm(xc, ends_c["final_norm"], eps), ends_c["head"])
    return x, xc, bounds, ends["head"]


def logits(config, seed: int, tokens: np.ndarray,
           device: torch.device) -> torch.Tensor:
    """The reference's logits (S, V) at every position of one sequence."""
    d = gen_lm.dims(config)
    with _fp32():
        x, _, _, head = _final(config, seed, [tokens], device, False, d,
                               float(config["rms_norm_eps"]),
                               float(config["rope_theta"]))
        return x @ head


def _served_gaps(config, seed, seqs, device, control, d, eps, theta):
    # the last served token is an output, never an input
    ids = [np.concatenate([np.asarray(prompt, np.int64),
                           np.asarray(served[:-1], np.int64)])
           for prompt, served in seqs]
    x, xc, bounds, head = _final(config, seed, ids, device, control, d, eps,
                                 theta)
    out = []
    for (prompt, served), (a, b) in zip(seqs, bounds):
        first = a + len(prompt) - 1              # predicts served[0]
        want = torch.as_tensor(np.asarray(served, np.int64), device=device)
        gaps = []
        for p0 in range(first, b, HEAD_BLOCK):
            p1 = min(b, p0 + HEAD_BLOCK)
            lg = x[p0:p1] @ head
            if control:
                tok = (xc[0][p0:p1] @ xc[1]).argmax(-1)
            else:
                tok = want[p0 - first:p1 - first]
            picked = lg.gather(-1, tok[:, None])[:, 0]
            gaps.append((lg.amax(-1) - picked).double().cpu())
        out.append(torch.cat(gaps).numpy())
    return out
