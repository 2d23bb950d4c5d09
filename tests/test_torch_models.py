"""The port's LM path against the reference package on the smoke configs.

For zamba2-7b (Mamba2 + shared attention), h2o-danube3-4b (GQA with a
sliding window), qwen3-32b (GQA with qk-norm), rwkv6-3b (WKV6
time-mix + channel-mix), qwen3-moe-30b-a3b (MoE FFN) and
deepseek-v2-lite-16b (MLA, MoE after a dense first layer), the reference's
``init_model`` makes the weights, ``params_from_jax`` hands them to the port
as numpy, and the same numpy tokens go through both: forward hidden states
and logits, prefill logits and caches, and one decode step must agree
within 1e-4 relative (float32 on both; max |diff| over max |reference|).
The port's own prefill + decode must equal its forward within 5e-3, the
bound of tests/test_serve.py. Forward runs with ``inference=True``, the MoE
capacity of prefill and decode, as tests/test_serve.py runs it. The kernels run as their plain versions here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import model as JM
from repro.serve.engine import prefill_step as jax_prefill
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, padded_vocab
from repro_torch.models import attention as port_attention
from repro_torch.models import layers as port_layers
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import prefill_step

ARCHS = ["zamba2_7b", "h2o_danube3_4b", "qwen3_32b", "rwkv6_3b",
         "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"]
B, S = 2, 20                 # S: a short chunk of the smoke SSM chunk (32)


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jax_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1)) \
        .astype(np.int32)
    hidden, _ = jax.jit(lambda p, t: JM.forward(p, jcfg, {"tokens": t},
                                                inference=True))(
        jparams, jnp.asarray(toks[:, :S]))
    logits, caches = jax.jit(lambda p, t: jax_prefill(
        p, jcfg, {"tokens": t}, capacity=S + 8))(jparams,
                                                  jnp.asarray(toks[:, :S]))
    dec, _ = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))(
        jparams, jnp.asarray(toks[:, S:]), caches)
    return {"arch": arch, "cfg": cfg, "params": params, "tokens": toks,
            "hidden": np.asarray(hidden), "logits": np.asarray(logits),
            "caches": jax.tree.map(np.asarray, caches),
            "decode": np.asarray(dec),
            "table": np.asarray(JM.head_table(jparams, jcfg))}


def _tokens(pair, end=S):
    return {"tokens": torch.from_numpy(pair["tokens"][:, :end]).long()}


def test_forward_matches_reference(pair):
    cfg, params = pair["cfg"], pair["params"]
    hidden, _ = TM.forward(params, cfg, _tokens(pair), inference=True)
    assert rel(hidden.numpy(), pair["hidden"]) < 1e-4
    ref = pair["hidden"] @ pair["table"].T
    out = TM.logits(params, cfg, hidden).numpy()
    assert rel(out[..., :cfg.vocab], ref[..., :cfg.vocab]) < 1e-4
    assert (out[..., cfg.vocab:] == -1e30).all()


def _stacked(layers):
    """The port's per-layer caches stacked like the reference's."""
    return [torch.stack([getattr(c, f) for c in layers]).numpy()
            for f in layers[0]._fields]


def test_prefill_matches_reference(pair):
    cfg = pair["cfg"]
    logits, caches = prefill_step(pair["params"], cfg, _tokens(pair),
                                  capacity=S + 8)
    assert rel(logits[:, :cfg.vocab].numpy(),
               pair["logits"][:, :cfg.vocab]) < 1e-4
    assert sorted(caches) == sorted(pair["caches"])
    for kind, layers in caches.items():
        for port_leaf, ref_leaf in zip(_stacked(layers), pair["caches"][kind]):
            assert port_leaf.shape == ref_leaf.shape, kind
            if ref_leaf.dtype.kind == "i":
                assert np.array_equal(port_leaf, ref_leaf), kind
            else:
                assert rel(port_leaf, ref_leaf) < 1e-4, kind


def test_decode_step_matches_reference(pair):
    cfg, params = pair["cfg"], pair["params"]
    _, caches = prefill_step(params, cfg, _tokens(pair), capacity=S + 8)
    dec, new = TM.decode_step(
        params, cfg, torch.from_numpy(pair["tokens"][:, S:]).long(), caches)
    assert rel(dec[:, :cfg.vocab].numpy(),
               pair["decode"][:, :cfg.vocab]) < 1e-4
    for layers in new.values():
        assert all(int(c.length.min()) == S + 1 for c in layers)


def test_prefill_decode_equals_forward(pair):
    """The property of tests/test_serve.py on the port alone."""
    cfg, params = pair["cfg"], pair["params"]
    hidden, _ = TM.forward(params, cfg, _tokens(pair, S + 1), inference=True)
    ref = TM.logits(params, cfg, hidden[:, -1])
    _, caches = prefill_step(params, cfg, _tokens(pair), capacity=S + 8)
    dec, _ = TM.decode_step(
        params, cfg, torch.from_numpy(pair["tokens"][:, S:]).long(), caches)
    assert rel(dec[:, :cfg.vocab].numpy(), ref[:, :cfg.vocab].numpy()) < 5e-3


def test_rwkv_decode_chain_matches_forward_and_reference():
    """Five decode steps from an empty state equal forward over the five
    tokens (tests/test_serve.py:88-108, 5e-3 relative) and the reference's
    own chain on the same converted weights (1e-4 relative)."""
    jcfg = jax_registry.get_smoke_config("rwkv6_3b")
    cfg = registry.get_smoke_config("rwkv6_3b")
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 5)) \
        .astype(np.int32)
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    jcaches = JM.init_decode_state(jcfg, 2, 16)
    caches = TM.init_decode_state(cfg, 2, 16, "cpu")
    for t in range(5):
        jlogits, jcaches = jstep(jparams, jnp.asarray(toks[:, t:t + 1]),
                                 jcaches)
        logits, caches = TM.decode_step(
            params, cfg, torch.from_numpy(toks[:, t:t + 1]).long(), caches)
        assert rel(logits.numpy(), np.asarray(jlogits)) < 1e-4, t
    hidden, _ = TM.forward(params, cfg, {"tokens": torch.from_numpy(toks).long()})
    ref = TM.logits(params, cfg, hidden[:, -1])
    assert rel(logits.numpy(), ref.numpy()) < 5e-3
    assert all(int(c.length.min()) == 5 for c in caches["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_has_the_reference_layout(arch):
    """Seeded random init makes every parameter the converter fills, with
    the reference's shape and type."""
    cfg = registry.get_smoke_config(arch)
    made = TM.init_model(torch.Generator().manual_seed(0), cfg)
    again = TM.init_model(torch.Generator().manual_seed(0), cfg)
    jparams = JM.init_model(jax.random.PRNGKey(0),
                            jax_registry.get_smoke_config(arch))
    converted = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in made.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype)
                      for n, p in converted.named_parameters()}
    for (n, p), (_, q) in zip(made.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.isfinite(p).all(), n


@pytest.mark.parametrize("arch", jax_registry.ARCH_IDS)
def test_param_count_matches_reference(arch):
    assert registry.get_config(arch).param_count() == \
        jax_registry.get_config(arch).param_count()
    assert registry.get_config(arch).active_param_count() == \
        jax_registry.get_config(arch).active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_model_on_meta_device(arch):
    """The full configs build (on the meta device: no memory) with about
    the analytic parameter count; zamba2-7b is ~6.8 B, rwkv6-3b within 1%
    of its analytic 3,098,542,080; qwen3-moe-30b-a3b is its analytic
    30,531,911,680 plus the norms and the padded vocab rows, which the
    analytic count leaves out."""
    cfg = registry.get_config(arch)
    n = sum(p.numel() for p in TM.Model(cfg, None, "meta").parameters())
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.01
    if arch == "zamba2_7b":
        assert 6.7e9 < n < 6.9e9
    if arch == "rwkv6_3b":
        assert cfg.param_count() == 3_098_542_080
    if arch == "qwen3_moe_30b_a3b":
        assert cfg.param_count() == 30_531_911_680
        d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
        pad = padded_vocab(cfg.vocab) - cfg.vocab
        assert n == (cfg.param_count() + L * (2 * d + 2 * hd) + d
                     + 2 * pad * d)
    if arch == "deepseek_v2_lite_16b":
        assert cfg.param_count() == 15_706_357_760
        d, L = cfg.d_model, cfg.n_layers
        pad = padded_vocab(cfg.vocab) - cfg.vocab
        assert n == (cfg.param_count() + L * (2 * d + cfg.mla.kv_lora_rank)
                     + d + 2 * pad * d)


@pytest.mark.parametrize("arch,needle", [
    ("internvl2_2b", "frontend"), ("hubert_xlarge", "frontend")])
def test_unported_parts_raise(arch, needle, tmp_path):
    """The frontends are ported: the model builds with its ``frontend``.
    Training over a mesh is ported too, so nothing of these archs raises
    any more: on a (1, 1, 1) ("pod", "data", "model") gloo mesh the pod
    branch (``compress_dcn``) takes a step whose loss and grad norm equal
    the one-process step's from the same weights and batch, and its
    ``dcn_error`` is float32, one per parameter (tests/test_torch_sharded.py
    holds the branch on 4 ranks)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.train import optimizer, train_step
    from torch_parity import one_rank_mesh, train_batch
    cfg = registry.get_smoke_config(arch)
    model = TM.init_model(torch.Generator().manual_seed(0), cfg)
    assert needle in dict(model.named_children())
    opt = optimizer.OptConfig(total_steps=10, warmup_steps=2)
    shape = ShapeConfig("s", "train", 8, 2, 1, True)
    batch = {k: torch.from_numpy(v)
             for k, v in train_batch(cfg, 2, 8, seed=1).items()}
    params, state = train_step.init_train_state(
        torch.Generator().manual_seed(0), cfg, opt)
    _, _, want = train_step.make_train_step(cfg, shape, opt)(params, state,
                                                             batch)
    with one_rank_mesh(tmp_path, (1, 1, 1), ("pod", "data", "model")) as mesh:
        ctx = make_ctx(mesh)
        params, state = train_step.init_train_state(
            torch.Generator().manual_seed(0), cfg, opt, compress_dcn=True,
            ctx=ctx)
        assert set(state["dcn_error"]) == {n for n, _ in
                                          params.named_parameters()}
        assert all(e.dtype == torch.float32
                   for e in state["dcn_error"].values())
        _, state, got = train_step.make_train_step(
            cfg, shape, opt, ctx=ctx, compress_dcn=True)(params, state, batch)
        errs = [e.to_local() for e in state["dcn_error"].values()]
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]),
                                                    rel=1e-3)
    assert any(e.any() for e in errs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jax_layers.rmsnorm({"scale": jnp.asarray(scale, dtype)}, jx)
    out = port_layers.rmsnorm({"scale": torch.from_numpy(scale).to(tx.dtype)},
                              tx)
    # bf16: equal, the elementwise math rounds in the input type as the
    # reference's does; f32: within an ulp of the two rsqrt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=0,
                               rtol=1e-6 if dtype == "float32" else 0)
    ref = jax_layers.apply_rope(jx, jnp.asarray(pos), 1e4)
    out = port_layers.apply_rope(tx, torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("causal,window,offset", [
    (True, 0, 0), (True, 5, 0), (False, 4, 0), (True, 3, 7)])
def test_attention_bias_matches_reference(causal, window, offset):
    ref = jax_attention.attention_bias(6, 13, causal=causal, window=window,
                                       q_offset=offset)
    out = port_attention.attention_bias(6, 13, causal=causal, window=window,
                                        q_offset=offset)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
