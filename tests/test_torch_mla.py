"""The port's MLA attention against the reference's, float32 on the CPU.

Two configs: the deepseek-v2-lite-16b smoke config (4 heads, nope 32, rope
16, v 32, latent 32) and the same at deepseek's published MLA widths (16
heads, nope 128, rope 64, v 128, latent 512: q and k 192 wide, v
zero-padded from 128 to 192 on the way through the flash-attention op). The
reference's ``init_model`` makes the weights, ``params_from_jax`` hands them
to the port, and the first block's attention of each is compared on the
same numpy-seeded inputs. Errors are relative: max |diff| over max
|reference|. The whole smoke model (forward, prefill caches, decode, and
prefill + decode against forward) and the full-size parameter count are
held in tests/test_torch_models.py, its session in tests/test_torch_serve.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import registry
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import ServeSession, prefill_step

ARCH = "deepseek_v2_lite_16b"
#: deepseek-v2-lite's published MLA widths on the smoke model's d_model
WIDTHS = dict(n_heads=16, n_kv_heads=16, head_dim=192)
WIDTHS_MLA = dict(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128)


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-30))


def _configs(kind):
    jcfg = jax_registry.get_smoke_config(ARCH)
    cfg = registry.get_smoke_config(ARCH)
    if kind == "widths":
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(
            jcfg.mla, **WIDTHS_MLA), **WIDTHS)
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, **WIDTHS_MLA), **WIDTHS)
    return jcfg, cfg


@pytest.fixture(scope="module", params=["smoke", "widths"])
def mla(request):
    """The first block's attention on both sides (the dense prefix)."""
    jcfg, cfg = _configs(request.param)
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    jattn = jax.tree.map(lambda a: a[0], jparams["stack"]["prefix"]["attn"])
    return {"jcfg": jcfg, "cfg": cfg, "jattn": jattn,
            "attn": params.stack.prefix[0].attn}


def _x(cfg, B, S, seed):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return x, pos


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_mla_q_and_latent_match_reference(mla):
    x, pos = _x(mla["cfg"], 2, 12, seed=1)
    ref = (JA._mla_q(mla["jattn"], mla["jcfg"], jnp.asarray(x), pos)
           + JA._mla_latent(mla["jattn"], mla["jcfg"], jnp.asarray(x), pos))
    tx, tpos = _t(x, pos)
    out = (TA._mla_q(mla["attn"], mla["cfg"], tx, tpos)
           + TA._mla_latent(mla["attn"], mla["cfg"], tx, tpos))
    assert [o.shape for o in out] == [r.shape for r in ref]
    for name, o, r in zip(("q_nope", "q_rope", "c_kv", "k_rope"), out, ref):
        assert rel(o.numpy(), r) < 1e-6, name


@pytest.mark.parametrize("S", [16, 64])
def test_mla_attention_matches_reference(mla, S):
    x, pos = _x(mla["cfg"], 2, S, seed=S)
    ref = JA.mla_attention(mla["jattn"], mla["jcfg"], jnp.asarray(x), pos)
    out = TA.mla_attention(mla["attn"], mla["cfg"], *_t(x, pos))
    assert out.shape == ref.shape
    assert rel(out.numpy(), ref) < 1e-5


def test_mla_flash_pads_v_and_cuts_it_back(mla):
    """The op sees q, k and a zero-padded v at one head dim; the result is
    the reference's two-part scores over the unpadded v."""
    cfg = mla["cfg"]
    m = cfg.mla
    rng = np.random.default_rng(4)
    B, S, H = 1, 40, cfg.n_heads
    qn, kn = (rng.standard_normal((B, S, H, m.qk_nope_head_dim))
              .astype(np.float32) for _ in range(2))
    qr = rng.standard_normal((B, S, H, m.qk_rope_head_dim)).astype(np.float32)
    kr = rng.standard_normal((B, S, m.qk_rope_head_dim)).astype(np.float32)
    v = rng.standard_normal((B, S, H, m.v_head_dim)).astype(np.float32)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ref = JA.blocked_mla_core(*map(jnp.asarray, (qn, qr, kn, kr, v)), scale,
                              q_chunk=S)
    out = TA.mla_flash(*_t(qn, qr, kn, kr, v), scale)
    assert out.shape == v.shape
    assert rel(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("S,q_chunk", [(32, 8), (30, 8)])
def test_blocked_mla_core_matches_reference(mla, S, q_chunk):
    """S = 30 with chunks of 8 takes the largest divisor, 6, on both."""
    cfg = mla["cfg"]
    m = cfg.mla
    rng = np.random.default_rng(S)
    B, H = 2, cfg.n_heads
    qn, kn = (rng.standard_normal((B, S, H, m.qk_nope_head_dim))
              .astype(np.float32) for _ in range(2))
    qr = rng.standard_normal((B, S, H, m.qk_rope_head_dim)).astype(np.float32)
    kr = rng.standard_normal((B, S, m.qk_rope_head_dim)).astype(np.float32)
    v = rng.standard_normal((B, S, H, m.v_head_dim)).astype(np.float32)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ref = JA.blocked_mla_core(*map(jnp.asarray, (qn, qr, kn, kr, v)), scale,
                              q_chunk=q_chunk)
    out = TA.blocked_mla_core(*_t(qn, qr, kn, kr, v), scale, q_chunk=q_chunk)
    assert rel(out.numpy(), ref) < 1e-6


def test_long_prompt_takes_the_blocked_core_on_the_cpu(mla, monkeypatch):
    """From ``BLOCKED_THRESHOLD`` tokens on (lowered to 32 on both sides)
    the port takes its blocked core on the CPU, where the reference takes
    its own, and the two agree."""
    monkeypatch.setattr(JA, "BLOCKED_THRESHOLD", 32)
    monkeypatch.setattr(TA, "BLOCKED_THRESHOLD", 32)
    calls = []
    real = TA.blocked_mla_core
    monkeypatch.setattr(TA, "blocked_mla_core",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, pos = _x(mla["cfg"], 1, 48, seed=5)
    ref = JA.mla_attention(mla["jattn"], mla["jcfg"], jnp.asarray(x), pos)
    out = TA.mla_attention(mla["attn"], mla["cfg"], *_t(x, pos))
    assert calls == [1]
    assert rel(out.numpy(), ref) < 1e-5


def test_attention_prefill_matches_reference(mla):
    x, pos = _x(mla["cfg"], 2, 20, seed=6)
    ref_out, ref_cache = JA.attention_prefill(mla["jattn"], mla["jcfg"],
                                              jnp.asarray(x), pos,
                                              capacity=28)
    out, cache = TA.attention_prefill(mla["attn"], mla["cfg"], *_t(x, pos),
                                      capacity=28)
    assert rel(out.numpy(), ref_out) < 1e-5
    assert [c.shape for c in cache] == [r.shape for r in ref_cache]
    assert np.array_equal(cache.length.numpy(), np.asarray(ref_cache.length))
    # the latents as the latent test holds them (float32 products in another
    # order), the slots past the prompt exactly 0
    assert rel(cache.k.numpy(), ref_cache.k) < 1e-6
    assert rel(cache.v.numpy(), ref_cache.v) < 1e-6
    assert not cache.k[:, 20:].any() and not cache.v[:, 20:].any()


def test_prefill_longer_than_the_capacity_raises(mla):
    x, pos = _x(mla["cfg"], 1, 12, seed=7)
    with pytest.raises(ValueError, match="capacity"):
        TA.attention_prefill(mla["attn"], mla["cfg"], *_t(x, pos),
                             capacity=8)


def test_mla_decode_matches_reference(mla):
    """Four steps of three slots at different depths over caches of 8
    latents: slot 2 reaches the capacity after one step and then writes
    nothing (the reference's scatter drops it), while it keeps attending
    over the full cache. The caches within 1e-6 relative after each step,
    as the latents are held."""
    cfg, jcfg = mla["cfg"], mla["jcfg"]
    m = cfg.mla
    rng = np.random.default_rng(8)
    B, cap = 3, 8
    ck = rng.standard_normal((B, cap, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, cap, m.qk_rope_head_dim)).astype(np.float32)
    length = np.array([1, 4, 7], np.int32)
    jcache = JA.KVCache(jnp.asarray(ck), jnp.asarray(kr), jnp.asarray(length))
    cache = TA.KVCache(*_t(ck, kr, length))
    for step in range(4):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        ref, jcache = JA.mla_decode(mla["jattn"], jcfg, jnp.asarray(x),
                                    jcache)
        out, cache = TA.mla_decode(mla["attn"], cfg, torch.from_numpy(x),
                                   cache)
        assert rel(out.numpy(), ref) < 1e-5, step
        assert np.array_equal(cache.length.numpy(), np.asarray(jcache.length))
        assert rel(cache.k.numpy(), jcache.k) < 1e-6, step
        assert rel(cache.v.numpy(), jcache.v) < 1e-6, step
    assert cache.length.tolist() == [5, 8, 11]
    # the slot past the capacity kept the latents it started with
    np.testing.assert_array_equal(cache.k[2, :7].numpy(), ck[2, :7])


def test_session_splices_the_latent_caches():
    """A request prefilled alone lands in slot 1 of a 2-slot session: both
    latent caches and the length equal its own prefill's in that slot, and
    slot 0 stays empty."""
    cfg = registry.get_smoke_config(ARCH)
    params = TM.init_model(torch.Generator().manual_seed(0), cfg)
    sess = ServeSession(params, cfg, batch_slots=2, capacity=24,
                        device="cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, 10)))
    _, caches = prefill_step(params, cfg, {"tokens": toks}, capacity=24)
    sess._splice(1, caches, token=3)
    for kind, layers in caches.items():
        for got, want in zip(sess.caches[kind], layers):
            assert got.k.shape == (2, 24, cfg.mla.kv_lora_rank)
            assert got.v.shape == (2, 24, cfg.mla.qk_rope_head_dim)
            for g, w in zip(got, want):
                assert torch.equal(g[1], w[0])
                assert not g[0].any()
    assert sess.tokens[1, 0] == 3
