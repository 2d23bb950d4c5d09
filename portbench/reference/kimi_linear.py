"""Kimi-Linear-48B-A3B's forward pass in plain float32 PyTorch: no kernel,
no cache, no batching; TF32 off (``reference/lm.py``'s ``_fp32``).

Per layer (arXiv:2510.26692; layers numbered 1-27 as the config's
``linear_attn_config``): ``h = rmsnorm(x)``, the mixer, the residual;
``h = rmsnorm(x)``, the FFN, the residual; then ``rmsnorm`` and the head.

- KDA (the 20 layers of ``kda_layers``), per head (K = V = 128):
  ``q, k, v = SiLU(causal depthwise conv4(h W))``; ``q̂, k̂`` divided by
  their norms; ``g = -exp(A_log) softplus(h W_fa W_fb + dt_bias)`` (K,);
  ``β = sigmoid(h W_b)``; the state S (K x V) ``S <- Diag(e^g) S`` then
  ``S <- S + β k̂ (v - Sᵀk̂)ᵀ``; ``o = Sᵀq̂ / sqrt(K)``; ``y = rmsnorm(o)
  * o_norm * sigmoid(h W_ga W_gb + b_g)``; the heads through W_o. The
  sequence is computed in closed form a chunk of ``CHUNK`` tokens at a
  time (:func:`kda_chunks`), which the tests hold to the token-by-token
  recurrence (:func:`kda_recurrent`).
- MLA (the 7 of ``full_attn_layers``), NoPE (``mla_use_nope``): as
  ``reference/lm.py``'s DeepSeek-V2 attention with q_rope and k_rope not
  rotated: ``[c, k_rope] = h w_dkv``, ``c = rmsnorm(c)``; causal softmax
  of ``(q_nope k_nope + q_rope k_rope) / sqrt(192)``.
- FFN: layer 1 a SwiGLU of 9,216; the others ``s = sigmoid(h W_r)`` over
  all 256 experts, the top 8 of ``s + router_bias``, weights
  ``2.446 s_i / Σ_top8 s_j``, and the output the held experts' part (the
  configuration's ``num_experts`` from ``experts_held_from``) plus the
  shared expert.

Weights come from ``gen/kimi_linear.py``, drawn again one layer at a time
on the device and upcast. ``served_gaps`` is ``reference/lm.py``'s, for
this model: at each served position the reference's largest logit less
the served token's; with ``control`` the gap of the token that the same
forward on weights rounded to float8 e4m3 puts first. ``kda_states`` and
``mla_latents`` are what the first KDA layer and the first MLA layer keep
of a sequence (its state, its latent cache), to set beside the
program's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.gen import kimi_linear as gen_kl
from portbench.reference.lm import (HEAD_BLOCK, Q_BLOCK, _fp32, fp8_rounded,
                                    rmsnorm, swiglu)

CHUNK = 64
L2_EPS = 1e-6            # the paper's code's l2norm: x * rsqrt(|x|^2 + eps)


def kda_recurrent(q, k, v, g, beta, s=None):
    """The delta rule token by token: q, k (T,H,K) (q scaled, both
    normalised), v (T,H,V), g (T,H,K), beta (T,H); s (H,K,V) or zeros.
    Returns (o (T,H,V), the last state)."""
    T, H, K = k.shape
    if s is None:
        s = torch.zeros((H, K, v.shape[-1]), dtype=k.dtype, device=k.device)
    out = []
    for t in range(T):
        s = torch.exp(g[t])[..., None] * s
        u = v[t] - torch.einsum("hkv,hk->hv", s, k[t])
        s = s + beta[t][:, None, None] * k[t][..., None] * u[:, None, :]
        out.append(torch.einsum("hkv,hk->hv", s, q[t]))
    return torch.stack(out), s


def kda_chunks(q, k, v, g, beta, s=None, chunk: int = CHUNK):
    """:func:`kda_recurrent` in closed form a chunk at a time. In a chunk
    with state S before it and Γ the running sum of g inside it, the
    corrected values solve (I + A diag(β)) u = v - (e^Γ ⊙ k) S, A_ij =
    Σ_c k_ic k_jc e^(Γ_ic - Γ_jc) for j < i; the outputs are (e^Γ ⊙ q) S +
    B diag(β) u, B the same sum over q_i and k_j for j <= i; the state
    after it e^(Γ_last) ⊙ S + (e^(Γ_last - Γ) ⊙ k)ᵀ diag(β) u. Every
    exponent is a difference of Γ over i >= j, never above 0."""
    T, H, K = k.shape
    V = v.shape[-1]
    if s is None:
        s = torch.zeros((H, K, V), dtype=k.dtype, device=k.device)
    out = torch.empty((T, H, V), dtype=k.dtype, device=k.device)
    for c0 in range(0, T, chunk):
        sl = slice(c0, min(T, c0 + chunk))
        qc, kc, vc, gc = (t[sl].transpose(0, 1) for t in (q, k, v, g))
        bc = beta[sl].transpose(0, 1)                    # (H,n)
        n = kc.shape[1]
        G = gc.cumsum(1)                                 # (H,n,K)
        lower = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                      device=k.device))
        rel = (G[:, :, None, :] - G[:, None, :, :]).masked_fill(
            ~lower[None, :, :, None], float("-inf"))
        decay = torch.exp(rel)                           # (H,i,j,K)
        a = torch.einsum("hik,hjk,hijk->hij", kc, kc, decay).tril(-1)
        b = torch.einsum("hik,hjk,hijk->hij", qc, kc, decay)
        eye = torch.eye(n, dtype=k.dtype, device=k.device)
        rhs = vc - (kc * torch.exp(G)) @ s
        u = torch.linalg.solve_triangular(eye + a * bc[:, None, :], rhs,
                                          upper=False, unitriangular=True)
        bu = bc[..., None] * u
        out[sl] = ((qc * torch.exp(G)) @ s + b @ bu).transpose(0, 1)
        last = G[:, -1:, :]
        s = torch.exp(last).transpose(1, 2) * s \
            + (kc * torch.exp(last - G)).transpose(1, 2) @ bu
    return out, s


def _conv_silu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise conv of x (T,C) with taps w (Kc,C):
    out_t = Σ_i w_i x_(t-Kc+1+i), zeros before the first token."""
    Kc, T = w.shape[0], x.shape[0]
    xp = F.pad(x, (0, 0, Kc - 1, 0))
    return F.silu(sum(w[i] * xp[i:i + T] for i in range(Kc)))


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def _kda_state(h: torch.Tensor, w: Dict[str, torch.Tensor], d: Dict
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The delta rule of one KDA mixer over one sequence h (T, D): its
    outputs o (T, H, V) before the norm and gate, and its last state."""
    T, H, K = h.shape[0], d["KH"], d["KD"]
    q = _l2norm(_conv_silu(h @ w["wq"], w["conv_q"]).view(T, H, K)) \
        * K ** -0.5
    k = _l2norm(_conv_silu(h @ w["wk"], w["conv_k"]).view(T, H, K))
    v = _conv_silu(h @ w["wv"], w["conv_v"]).view(T, H, K)
    g = -torch.exp(w["A_log"])[:, None] * F.softplus(
        (h @ w["f_a"] @ w["f_b"]).view(T, H, K) + w["dt_bias"].view(H, K))
    beta = torch.sigmoid(h @ w["w_beta"])
    return kda_chunks(q, k, v, g, beta)


def kda(h: torch.Tensor, w: Dict[str, torch.Tensor], d: Dict,
        eps: float) -> torch.Tensor:
    """One KDA mixer over one sequence h (T, D)."""
    T, H, K = h.shape[0], d["KH"], d["KD"]
    o, _ = _kda_state(h, w, d)
    gate = torch.sigmoid(h @ w["g_a"] @ w["g_b"] + w["g_bias"]).view(T, H, K)
    y = rmsnorm(o, w["o_norm"], eps) * gate
    return y.reshape(T, H * K) @ w["wo"]


def _latent(h: torch.Tensor, w: Dict[str, torch.Tensor], d: Dict,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLA's latent c (normed) and its shared rope key, not rotated, of
    h (S, D)."""
    c, k_rope = (h @ w["w_dkv"]).split([d["r"], d["rope"]], dim=-1)
    return rmsnorm(c, w["kv_norm"], eps), k_rope


def mla(h: torch.Tensor, w: Dict[str, torch.Tensor], d: Dict,
        eps: float) -> torch.Tensor:
    """Causal NoPE MLA over one sequence h (S, D)."""
    S, H = h.shape[0], d["H"]
    q = (h @ w["wq"]).view(S, H, d["qk"])
    q_nope, q_rope = q.split([d["nope"], d["rope"]], dim=-1)
    c, k_rope = _latent(h, w, d, eps)
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
    """The held experts' part of the routed output and the shared
    expert, over rows h (N, D)."""
    s = torch.sigmoid(h @ w["router"])
    top_e = torch.topk(s + w["router_bias"], d["K"], dim=-1).indices
    top_w = s.gather(-1, top_e)
    top_w = d["scale"] * top_w / top_w.sum(-1, keepdim=True)
    out = swiglu(h, w["s_gate"], w["s_up"], w["s_down"])
    for e in range(d["El"]):
        rows, slot = torch.nonzero(top_e == d["e0"] + e, as_tuple=True)
        if len(rows):
            y = swiglu(h[rows], w["e_gate"][e], w["e_up"][e], w["e_down"][e])
            out.index_add_(0, rows, y * top_w[rows, slot][:, None])
    return out


def _weights(config, seed: int, index: int, device, control: bool):
    raw = gen_kl.layer(config, seed, index, device)
    ref = {k: v.float() for k, v in raw.items()}
    del raw
    return ref, ({k: fp8_rounded(v) for k, v in ref.items()}
                 if control else None)


def _block(x, bounds, w, d, config, index: int, eps: float):
    """Layer ``index`` over the sequences at ``bounds`` in x (N, D)."""
    h = rmsnorm(x, w["attn_norm"], eps)
    mixer = mla if gen_kl.is_mla(config, index) else kda
    x = x + torch.cat([mixer(h[a:b], w, d, eps) for a, b in bounds])
    h = rmsnorm(x, w["ffn_norm"], eps)
    if index < d["dense"]:
        return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
    return x + experts(h, w, d)


def _final(config, seed, ids: Sequence[np.ndarray], device, control: bool):
    """The final-normed hidden states (N, D) of the sequences ``ids`` laid
    end to end, their bounds, and the head (with ``control``, the same of
    the float8 stream too)."""
    d = gen_kl.dims(config)
    eps = float(config["rms_norm_eps"])
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
        x = _block(x, bounds, w, d, config, i, eps)
        if control:
            xc = _block(xc, bounds, wc, d, config, i, eps)
        del w, wc
    ends, ends_c = _weights(config, seed, d["L"], device, control)
    x = rmsnorm(x, ends["final_norm"], eps)
    if control:
        xc = (rmsnorm(xc, ends_c["final_norm"], eps), ends_c["head"])
    return x, xc, bounds, ends["head"]


def logits(config, seed: int, tokens: np.ndarray,
           device: torch.device) -> torch.Tensor:
    """The reference's logits (S, V) at every position of one sequence."""
    with _fp32():
        x, _, _, head = _final(config, seed, [tokens], device, False)
        return x @ head


def served_gaps(config, seed: int,
                seqs: Sequence[Tuple[np.ndarray, Sequence[int]]],
                device: torch.device, control: bool = False
                ) -> List[np.ndarray]:
    """For each ``(prompt, served)``: the reference's largest logit less
    the logit of the served token (with ``control``, of the control's
    first token) at each served position, float64."""
    with _fp32():
        # the last served token is an output, never an input
        ids = [np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(served[:-1], np.int64)])
               for prompt, served in seqs]
        x, xc, bounds, head = _final(config, seed, ids, device, control)
        out = []
        for (prompt, served), (a, b) in zip(seqs, bounds):
            first = a + len(prompt) - 1              # predicts served[0]
            want = torch.as_tensor(np.asarray(served, np.int64),
                                   device=device)
            gaps = []
            for p0 in range(first, b, HEAD_BLOCK):
                p1 = min(b, p0 + HEAD_BLOCK)
                lg = x[p0:p1] @ head
                tok = ((xc[0][p0:p1] @ xc[1]).argmax(-1) if control
                       else want[p0 - first:p1 - first])
                picked = lg.gather(-1, tok[:, None])[:, 0]
                gaps.append((lg.amax(-1) - picked).double().cpu())
            out.append(torch.cat(gaps).numpy())
        return out


def kda_states(config, seed: int, ids: Sequence[np.ndarray],
               device: torch.device, control: bool = False
               ) -> List[torch.Tensor]:
    """The state (H, K, V) that the first layer, a KDA layer, holds after
    each token sequence of ``ids`` (with ``control``, that of the forward
    on weights rounded to float8 e4m3)."""
    d = gen_kl.dims(config)
    if gen_kl.is_mla(config, 0):
        raise ValueError("the first layer is not a KDA layer")
    eps = float(config["rms_norm_eps"])
    with _fp32():
        ends, _ = _weights(config, seed, d["L"], device, False)
        embed = fp8_rounded(ends["embed"]) if control else ends["embed"]
        del ends
        w, wc = _weights(config, seed, 0, device, control)
        w = wc if control else w
        out = []
        for toks in ids:
            t = torch.as_tensor(np.asarray(toks, np.int64), device=device)
            out.append(_kda_state(rmsnorm(embed[t], w["attn_norm"], eps),
                                  w, d)[1])
        return out


def mla_latents(config, seed: int, ids: Sequence[np.ndarray],
                device: torch.device, control: bool = False
                ) -> List[torch.Tensor]:
    """What the first MLA layer caches of each token sequence of ``ids``:
    its latent c and rope key, ``[c, k_rope]`` (S, r + rope), after the
    layers before it (with ``control``, those of the forward on weights
    rounded to float8 e4m3)."""
    d = gen_kl.dims(config)
    eps = float(config["rms_norm_eps"])
    first = next(i for i in range(d["L"]) if gen_kl.is_mla(config, i))
    with _fp32():
        ends, _ = _weights(config, seed, d["L"], device, False)
        embed = fp8_rounded(ends["embed"]) if control else ends["embed"]
        del ends
        out = []
        for toks in ids:
            t = torch.as_tensor(np.asarray(toks, np.int64), device=device)
            x, bounds = embed[t], [(0, len(toks))]
            for i in range(first + 1):
                w, wc = _weights(config, seed, i, device, control)
                w = wc if control else w
                if i < first:
                    x = _block(x, bounds, w, d, config, i, eps)
            out.append(torch.cat(_latent(rmsnorm(x, w["attn_norm"], eps), w,
                                         d, eps), dim=-1))
        return out
