"""Kimi-Linear on the port's serving path, on the CPU in float32 at a tiny
size of the same architecture (width 64; 4 KDA layers and 1 NoPE MLA
layer; a dense first FFN, then 16 experts of which this layer holds 4,
top 4 by a sigmoid router with a correction bias, and a shared expert;
vocabulary 512), against this file's own copy of the layer equations
(arXiv:2510.26692; the model card's ``modeling_kimi.py``).

Held here: KDA's chunked prefill against the token-by-token recurrence
(across chunk boundaries, at lengths that are no multiple of the chunk,
with decays down to -16 a token); prefill then decode, and the
``ServeSession``'s served tokens, against the full forward; the expert
shares adding up to the uncut layer; the router's bias selecting only;
NoPE MLA; a reused slot starting from its own request's KDA state; the
serving spans and counters; the served-only registry entry.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import registry
from repro_torch.configs.base import (KDAConfig, MLAConfig, ModelConfig,
                                      MoEConfig)
from repro_torch.core import telemetry
from repro_torch.models import attention as attn_mod
from repro_torch.models import kda as kda_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import Model
from repro_torch.serve import engine

CPU = torch.device("cpu")
EPS = 1e-5

TINY = ModelConfig(
    name="kimi-linear-tiny", family="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=32, vocab=512, head_dim=24,
    attention="mla", rope_theta=1e4,
    layer_mixers=("kda", "kda", "attn", "kda", "kda"),
    moe=MoEConfig(num_experts=16, top_k=4, expert_d_ff=32,
                  num_shared_experts=1, shared_d_ff=32, norm_topk_prob=True,
                  first_k_dense=1, dense_d_ff=96, scoring="sigmoid",
                  routed_scaling=2.446, held_experts=4, held_from=4,
                  dropless=True),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, rope=False),
    kda=KDAConfig(num_heads=4, head_dim=16, conv_size=4, chunk=8),
    param_dtype="float32", compute_dtype="float32", norm_eps=EPS)


def _model(cfg=TINY, seed=0):
    """The port's model on seeded weights, with the parts its initialiser
    leaves constant (the router's bias, the gate's bias) drawn too."""
    gen = torch.Generator().manual_seed(seed)
    model = Model(cfg, gen, CPU)
    for name, p in model.named_parameters():
        if name.endswith(("router_bias", "g_bias")):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return model


# ---------------------------------------------------------------------------
# the layer equations, this file's own copy
# ---------------------------------------------------------------------------

def _rms(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w


def _swiglu(x, p):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def recurrence(q, k, v, g, beta, s=None):
    """S <- Diag(e^g) S; S <- S + β k (v - Sᵀk)ᵀ; o = Sᵀq, token by token
    in float64. q, k (T,H,K), v (T,H,V), g (T,H,K), beta (T,H)."""
    q, k, v, g, beta = (t.double() for t in (q, k, v, g, beta))
    T, H, K = k.shape
    s = torch.zeros(H, K, v.shape[-1], dtype=torch.float64) if s is None \
        else s.double()
    out = []
    for t in range(T):
        s = torch.exp(g[t])[..., None] * s
        u = v[t] - torch.einsum("hkv,hk->hv", s, k[t])
        s = s + beta[t][:, None, None] * torch.einsum("hk,hv->hkv", k[t], u)
        out.append(torch.einsum("hkv,hk->hv", s, q[t]))
    return torch.stack(out), s


def kda_ref(p, cfg, h):
    """One sequence h (T,D) through the KDA mixer."""
    T = h.shape[0]
    H, K = cfg.kda.num_heads, cfg.kda.head_dim

    def conv(x, w):
        xp = F.pad(x, (0, 0, w.shape[0] - 1, 0))
        return F.silu(sum(w[i] * xp[i:i + T] for i in range(w.shape[0])))

    def unit(x):
        return x / torch.sqrt(x.square().sum(-1, keepdim=True) + 1e-6)
    q = unit(conv(h @ p["wq"], p["conv_q"]).view(T, H, K)) / K ** 0.5
    k = unit(conv(h @ p["wk"], p["conv_k"]).view(T, H, K))
    v = conv(h @ p["wv"], p["conv_v"]).view(T, H, K)
    g = -torch.exp(p["A_log"])[:, None] * F.softplus(
        (h @ p["f_a"] @ p["f_b"]).view(T, H, K) + p["dt_bias"].view(H, K))
    beta = torch.sigmoid(h @ p["w_beta"])
    o = recurrence(q, k, v, g, beta)[0].float()
    gate = torch.sigmoid(h @ p["g_a"] @ p["g_b"] + p["g_bias"]).view(T, H, K)
    return (_rms(o, p["o_norm"]) * gate).reshape(T, H * K) @ p["wo"]


def mla_ref(p, cfg, h, rope=False):
    """One sequence h (S,D) through causal MLA; NoPE unless ``rope``."""
    m, S, H = cfg.mla, h.shape[0], cfg.n_heads
    q = (h @ p["wq"]).view(S, H, -1)
    qn, qr = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    c, kr = (h @ p["w_dkv"]).split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    if rope:
        pos = torch.arange(S)
        qr = attn_mod.apply_rope(qr[None], pos[None], cfg.rope_theta)[0]
        kr = attn_mod.apply_rope(kr[None, :, None], pos[None],
                                 cfg.rope_theta)[0, :, 0]
    c = _rms(c, p["kv_norm"])
    kn = (c @ p["w_uk"]).view(S, H, -1)
    v = (c @ p["w_uv"]).view(S, H, -1)
    s = (torch.einsum("qhe,khe->hqk", qn, kn)
         + torch.einsum("qhe,ke->hqk", qr, kr)) / (qn.shape[-1]
                                                   + qr.shape[-1]) ** 0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -torch.inf)
    return torch.einsum("hqk,khe->qhe", torch.softmax(s, -1),
                        v).reshape(S, -1) @ p["wo"]


def moe_ref(p, cfg, h, held=None):
    """The sigmoid-routed experts: the top k of s + bias weighted by
    scaling * s / Σ s over the top k; the experts ``held`` (all by
    default) and the shared expert."""
    m = cfg.moe
    s = torch.sigmoid(h @ p["router"])
    top = torch.topk(s + p["router_bias"], m.top_k, -1).indices
    w = s.gather(-1, top)
    w = m.routed_scaling * w / w.sum(-1, keepdim=True)
    e0, El = held or (0, m.num_experts)
    out = _swiglu(h, p["shared"])
    for e in range(e0, e0 + El):
        rows, slot = torch.nonzero(top == e, as_tuple=True)
        ew = {n: p[n][e - e0] for n in ("w_gate", "w_up", "w_down")}
        out = out.index_add(0, rows, _swiglu(h[rows], ew)
                            * w[rows, slot][:, None])
    return out


def forward_ref(model, cfg, tokens):
    """Logits (S,V) of the whole model over one sequence."""
    x = model.embed.table[torch.as_tensor(tokens)]
    blocks = list(model.stack.prefix) + list(model.stack.layers)
    e0, El = moe_mod.held(cfg.moe)
    for b in blocks:
        h = _rms(x, b.norm1.scale)
        x = x + (kda_ref(b.kda, cfg, h) if "kda" in b
                 else mla_ref(b.attn, cfg, h))
        h = _rms(x, b.norm2.scale)
        x = x + (moe_ref(b.moe, cfg, h, (e0, El)) if "moe" in b
                 else _swiglu(h, b.mlp))
    return _rms(x, model.final_norm.scale) @ model.head[:, :cfg.vocab]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,chunk,g_min", [
    (8, 8, -1.0), (37, 8, -1.0), (5, 16, -3.0), (64, 16, -16.0),
    (100, 32, -16.0)])
def test_kda_chunked_matches_the_recurrence(T, chunk, g_min):
    """Across chunk boundaries, at lengths no multiple of the chunk, and
    with decays down to -16 a token (exp(-Γ) over a chunk would overflow
    float32: the chunk form keeps every decay relative)."""
    gen = torch.Generator().manual_seed(T)
    B, H, K, V = 2, 3, 8, 8

    def rnd(*s):
        return torch.randn(s, generator=gen)
    q, v, s0 = rnd(B, T, H, K), rnd(B, T, H, V), rnd(B, H, K, V)
    k = F.normalize(rnd(B, T, H, K), dim=-1)
    g = torch.rand((B, T, H, K), generator=gen) * g_min
    beta = torch.rand((B, T, H), generator=gen)
    o, s = kda_mod.kda_chunked(q, k, v, g, beta, s0, chunk)
    assert torch.isfinite(o).all()
    for b in range(B):
        o_ref, s_ref = recurrence(q[b], k[b], v[b], g[b], beta[b], s0[b])
        assert torch.allclose(o[b].double(), o_ref, atol=2e-5)
        assert torch.allclose(s[b].double(), s_ref, atol=2e-5)


@pytest.mark.parametrize("T", [7, 8, 21])
def test_kda_prefill_then_decode_matches_the_recurrence(T):
    """The mixer's prefill over T tokens and then its decode over 6 more,
    against the equations over all T + 6."""
    model = _model()
    p = model.stack.prefix[0].kda
    h = torch.randn((1, T + 6, TINY.d_model),
                    generator=torch.Generator().manual_seed(T))
    want = kda_ref(p, TINY, h[0])
    out, st = kda_mod.kda_prefill(p, TINY, h[:, :T])
    got = [out[0]]
    for t in range(T, T + 6):
        o, st = kda_mod.kda_decode(p, TINY, h[:, t:t + 1], st)
        got.append(o[0])
    assert torch.allclose(torch.cat(got), want, atol=1e-5)


def _decode_logits(model, cfg, prompt, follow, capacity=64):
    logits, caches = engine.prefill_step(
        model, cfg, {"tokens": torch.as_tensor(prompt[None])}, capacity)
    got = [logits[0]]
    for t in follow:
        logits, caches = engine.decode_step(
            model, cfg, torch.as_tensor([[int(t)]]), caches)
        got.append(logits[0])
    return torch.stack(got)[:, :cfg.vocab]


def test_prefill_then_decode_matches_the_full_forward():
    model = _model()
    rng = np.random.default_rng(1)
    prompt, follow = rng.integers(0, 512, 19), rng.integers(0, 512, 12)
    got = _decode_logits(model, TINY, prompt, follow)
    want = forward_ref(model, TINY, np.concatenate([prompt, follow]))
    want = want[len(prompt) - 1:]
    assert torch.allclose(got, want, atol=1e-4 * want.abs().max())


def test_session_serves_the_references_argmax():
    """Two slots, three requests of different lengths: every served token
    is the argmax of the full forward over the prompt and the tokens
    served before it (the third request reuses a slot)."""
    model = _model()
    sess = engine.ServeSession(model, TINY, 2, 64, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [engine.Request(i, rng.integers(0, 512, 9 + 6 * i,
                                           dtype=np.int32), 8)
            for i in range(3)]
    for r in reqs:
        sess.submit(r)
    sess.run_to_completion()
    for r in reqs:
        seq = np.concatenate([r.prompt, r.generated[:-1]])
        want = forward_ref(model, TINY, seq)[len(r.prompt) - 1:]
        assert r.generated == want.argmax(-1).tolist()


def test_a_reused_slot_starts_from_its_own_state():
    """One slot serves A, then B: B's tokens and its slot's KDA state after
    admission are those of B served in a fresh session (the splice
    overwrites the whole state and the conv tails)."""
    model = _model()
    rng = np.random.default_rng(3)
    a = rng.integers(0, 512, 23, dtype=np.int32)
    b = rng.integers(0, 512, 11, dtype=np.int32)

    def served(prompts):
        sess = engine.ServeSession(model, TINY, 1, 64, device="cpu")
        out = []
        for i, p in enumerate(prompts):
            req = engine.Request(i, p, 6)
            sess.submit(req)
            sess.step()                       # admits and decodes once
            state = [c for c in sess.caches["layers"]
                     if isinstance(c, kda_mod.KDAState)][0]
            admitted = [t.clone() for t in state]
            sess.run_to_completion()
            out.append((req.generated, admitted))
        return out[-1]
    toks_reused, st_reused = served([a, b])
    toks_fresh, st_fresh = served([b])
    assert toks_reused == toks_fresh
    assert all(torch.equal(x, y) for x, y in zip(st_reused, st_fresh))


def test_expert_shares_add_up_to_the_uncut_layer():
    """Four layers each holding 4 of the 16 experts: their outputs, less
    the shared expert that each computes alike counted once, add up to the
    layer that holds all 16, and each share is the equations' share."""
    whole = dataclasses.replace(TINY.moe, held_experts=0, held_from=0)
    cfg = dataclasses.replace(TINY, moe=whole)
    uncut = _model(cfg).stack.layers[0].moe
    x = torch.randn((2, 5, TINY.d_model),
                    generator=torch.Generator().manual_seed(4))
    want = moe_mod.moe_ffn(uncut, cfg, x, inference=True)[0]
    assert torch.allclose(want[0], moe_ref(uncut, cfg, x[0]), atol=1e-5)
    shared = moe_mod.mlp(uncut.shared, x)
    total = -3 * shared
    for e0 in (0, 4, 8, 12):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(
            whole, held_experts=4, held_from=e0))
        p = {"router": uncut.router, "router_bias": uncut.router_bias,
             "shared": uncut.shared,
             **{n: getattr(uncut, n)[e0:e0 + 4]
                for n in ("w_gate", "w_up", "w_down")}}
        part = moe_mod.moe_ffn(p, share, x, inference=True)[0]
        held_ref = moe_ref({**p, "router": uncut.router}, share, x[1],
                           (e0, 4))
        assert torch.allclose(part[1], held_ref, atol=1e-5)
        total = total + part
    assert torch.allclose(total, want, atol=1e-5)


def test_the_router_bias_selects_and_does_not_weigh():
    moe = TINY.moe
    gen = torch.Generator().manual_seed(5)
    w_r = torch.randn((TINY.d_model, 16), generator=gen) * 0.2
    x = torch.randn((1, 6, TINY.d_model), generator=gen)
    s = torch.sigmoid(x @ w_r)
    pick = torch.zeros(16)
    pick[[1, 5, 9, 13]] = 10.0                # selects these four
    dense, ids, _ = moe_mod.route(w_r, x, moe, pick)
    assert (ids.sort(-1).values == torch.tensor([1, 5, 9, 13])).all()
    sel = s[..., [1, 5, 9, 13]]
    assert torch.allclose(dense[..., [1, 5, 9, 13]],
                          2.446 * sel / sel.sum(-1, keepdim=True),
                          atol=1e-6)
    # a bias too small to change the selection changes no weight
    top = torch.topk(s, 4, -1)
    gap = (top.values[..., -1] - torch.topk(s, 5, -1).values[..., -1]).min()
    nudge = (torch.rand(16, generator=gen) - 0.5) * 0.8 * gap
    a = moe_mod.route(w_r, x, moe, torch.zeros(16))[0]
    b = moe_mod.route(w_r, x, moe, nudge)[0]
    assert torch.equal(a, b)
    # and a bias that moves the selection moves the output
    assert not torch.equal(a, dense)


def test_nope_mla_matches_the_equations():
    """Prefill and decode of a NoPE MLA layer against the equations, which
    rotation would change."""
    p = _model().stack.layers[1].attn
    h = torch.randn((1, 14, TINY.d_model),
                    generator=torch.Generator().manual_seed(6))
    want = mla_ref(p, TINY, h[0])
    assert not torch.allclose(want, mla_ref(p, TINY, h[0], rope=True),
                              atol=1e-3)
    out, cache = attn_mod.attention_prefill(p, TINY, h[:, :9],
                                            torch.arange(9)[None], 32)
    got = [out[0]]
    for t in range(9, 14):
        o, cache = attn_mod.decode_attention(p, TINY, h[:, t:t + 1], cache)
        got.append(o[0])
    assert torch.allclose(torch.cat(got), want, atol=1e-5)


def test_serving_spans_and_counters():
    """A recorded session: a ``serve.step`` a step, a ``serve.prefill`` a
    request, a ``serve.decode`` a decode step with two spans a layer
    (``kda``/``mla`` then ``mlp``/``moe``), and counters that count what
    was served; nothing is recorded without a recording."""
    model = _model()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 12, 7)]
    sess = engine.ServeSession(model, TINY, 2, 64, device="cpu")
    for i, p in enumerate(prompts):
        sess.submit(engine.Request(i, p, 4))
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        sess.run_to_completion()
    names = [s.name for s in tr.spans]
    steps = names.count("serve.decode")
    assert names.count("serve.step") == steps and steps > 0
    assert names.count("serve.prefill") == 3
    assert names.count("serve.decode.kda") == 4 * steps
    assert names.count("serve.decode.mla") == steps
    assert names.count("serve.decode.moe") == 4 * steps
    assert names.count("serve.decode.mlp") == steps
    decode = [s for s in tr.spans if s.name == "serve.decode"]
    assert all(tr.spans[s.parent].name == "serve.decode"
               for s in tr.spans if s.name.startswith("serve.decode."))
    c = tr.metrics.snapshot()["counters"]
    assert c["serve.tokens"] == 12 and c["serve.prefill_tokens"] == 24
    active = sum(s.attrs["active"] for s in decode)
    kda_params = sum(p.numel() * 4 for n, p in model.named_parameters()
                     if ".kda." in n)
    assert c["serve.kda_state_bytes"] == steps * (
        2 * 4 * 2 * kda_mod.state_bytes(TINY) + kda_params)
    assert active == 12 - 3
    # the token fed at position p attends p + 1 positions, in one MLA layer
    assert c["serve.latent_positions"] == sum(
        len(p) + k for p in prompts for k in range(1, 4))
    recorded = len(tr.spans)
    quiet = engine.ServeSession(model, TINY, 2, 64, device="cpu")
    quiet.submit(engine.Request(9, prompts[0], 3))
    quiet.run_to_completion()
    assert len(tr.spans) == recorded and quiet.finished


def test_served_only_config_resolves_outside_the_parity_ids():
    cfg = registry.get_config("kimi-linear-48b-a3b")
    assert "kimi_linear_48b_a3b" not in registry.ARCH_IDS
    assert "kimi_linear_48b_a3b" in registry.SERVED_IDS
    assert cfg.layer_mixers.count("kda") == 20
    assert [i + 1 for i, m in enumerate(cfg.layer_mixers)
            if m == "attn"] == [4, 8, 12, 16, 20, 24, 27]
    assert not cfg.mla.rope and cfg.moe.scoring == "sigmoid"
    assert (cfg.d_model, cfg.vocab, cfg.moe.num_experts) == (2304, 163840,
                                                             256)
    with pytest.raises(ValueError):
        engine.ServeSession(_model(), TINY, 1, 16, device="cpu", ctx=object())


def test_dropless_moe_keeps_every_token():
    """A router that sends every token of a long prompt to the same held
    experts loads them far past the inference capacity factor (4 times
    the mean): ``dropless`` still computes every token, as the equations
    do, where the capacity factor alone drops most of them."""
    cfg = dataclasses.replace(TINY, moe=dataclasses.replace(
        TINY.moe, num_experts=64))               # capacity 16 of 64 tokens
    p = _model().stack.layers[0].moe
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((1, 64, TINY.d_model), generator=gen)
    bias = torch.full((64,), -5.0)
    bias[4:8] = 5.0                              # the held experts, always
    router = torch.randn((TINY.d_model, 64), generator=gen) * 0.1
    q = {"router": router, "router_bias": bias, "shared": p.shared,
         "w_gate": p.w_gate, "w_up": p.w_up, "w_down": p.w_down}
    want = moe_ref(q, cfg, x[0], (4, 4))
    got = moe_mod.moe_ffn(q, cfg, x, inference=True)[0][0]
    assert torch.allclose(got, want, atol=1e-5)
    capped = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=False))
    dropped = moe_mod.moe_ffn(q, capped, x, inference=True)[0][0]
    assert not torch.allclose(dropped, want, atol=1e-3)
