"""The port's MoE against the reference's, on the qwen3-moe smoke config.

The reference's ``init_model`` makes the weights, ``params_from_jax`` hands
them to the port, and the same numpy-seeded inputs go through both
(float32; the port on the CPU). ``expert_capacity`` must be equal, ``route``
within 1e-6 (combine weights and aux loss; ids equal) and ``moe_ffn``
within 1e-5 relative (max |diff| over max |reference|), with and without
dropped tokens. A variant of the smoke config with a shared expert and a
dense first layer (``first_k_dense``) covers ``shared`` and the ``prefix``
stack: its forward, prefill and decode within 1e-4 relative, the bound of
tests/test_torch_models.py, and its serving session token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serve import engine as jax_engine
from repro.serve.engine import prefill_step as jax_prefill
from repro_torch.configs import registry
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine
from repro_torch.serve.engine import prefill_step

ARCH = "qwen3_moe_30b_a3b"
#: a shared expert and one dense first layer on the smoke config
SHARED = dict(num_shared_experts=1, shared_d_ff=64, first_k_dense=1,
              dense_d_ff=128)
B, S = 2, 24


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-30))


def configs(shared=False):
    """(reference config, port config) of the qwen3-moe smoke model."""
    out = []
    for reg in (jax_registry, registry):
        cfg = reg.get_smoke_config(ARCH)
        if shared:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **SHARED))
        out.append(cfg)
    return tuple(out)


def converted(jcfg, cfg, edit=None):
    """(reference params, port model) from one seed; ``edit`` changes the
    numpy tree before both are made from it."""
    tree = jax.tree.map(np.array, JM.init_model(jax.random.PRNGKey(0),
                                                jcfg))
    if edit is not None:
        edit(tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(cfg, tree, device="cpu"))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 31, 64, 445, 1024, 1781,
                               4096])
def test_expert_capacity_matches_reference(n):
    assert TMoE.INFERENCE_CAPACITY_FACTOR == JMoE.INFERENCE_CAPACITY_FACTOR
    for arch in (ARCH, "deepseek_v2_lite_16b"):
        for get in ("get_config", "get_smoke_config"):
            jm = getattr(jax_registry, get)(arch).moe
            tm = getattr(registry, get)(arch).moe
            for f in (None, 1.0, JMoE.INFERENCE_CAPACITY_FACTOR):
                assert TMoE.expert_capacity(n, tm, f) == \
                    JMoE.expert_capacity(n, jm, f), (arch, get, f)


@pytest.mark.parametrize("b,s,d,e,k,norm", [
    (2, 16, 32, 8, 2, True), (1, 33, 64, 16, 4, False),
    (3, 5, 48, 128, 8, True)])
def test_route_matches_reference(b, s, d, e, k, norm):
    moe = dataclasses.replace(registry.get_smoke_config(ARCH).moe,
                              num_experts=e, top_k=k, norm_topk_prob=norm)
    jmoe = dataclasses.replace(jax_registry.get_smoke_config(ARCH).moe,
                               num_experts=e, top_k=k, norm_topk_prob=norm)
    rng = np.random.default_rng(b * s + e)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    dense, ids, aux = TMoE.route(torch.from_numpy(w), torch.from_numpy(x),
                                 moe)
    jdense, jids, jaux = JMoE.route(jnp.asarray(w), jnp.asarray(x), jmoe)
    assert dense.dtype == torch.float32 and dense.shape == (b, s, e)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert int((dense > 0).sum()) == b * s * k


def _skew(tree):
    """Expert 0's router column lifted so that nearly every token (whose
    inputs have a positive mean, see the test) picks it."""
    router = tree["stack"]["layers"]["moe"]["router"]
    router[:, :, 0] += 3.0 / np.sqrt(router.shape[1])


@pytest.mark.parametrize("inference", [True, False])
@pytest.mark.parametrize("case", ["random", "skewed", "shared"])
def test_moe_ffn_matches_reference(case, inference):
    """The first MoE layer's FFN on converted weights: out within 1e-5
    relative, aux within 1e-6. "skewed" routes every token to expert 0,
    past its training capacity: the dropped tokens must match."""
    jcfg, cfg = configs(shared=case == "shared")
    jparams, model = converted(jcfg, cfg,
                               _skew if case == "skewed" else None)
    jmoe = jax.tree.map(lambda a: a[0], jparams["stack"]["layers"]["moe"])
    moe = model.stack.layers[0].moe
    assert ("shared" in moe) == (case == "shared")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if case == "skewed":
        x += 1.0
        dense, _, _ = TMoE.route(moe.router, torch.from_numpy(x), cfg.moe)
        routed = int((dense[..., 0] > 0).sum(dim=1).max())
        cap = TMoE.expert_capacity(S, cfg.moe, None if not inference
                                   else TMoE.INFERENCE_CAPACITY_FACTOR)
        assert routed == S and (routed > cap) == (not inference)
    out, aux = TMoE.moe_ffn(moe, cfg, torch.from_numpy(x),
                            inference=inference)
    jout, jaux = jax.jit(lambda p, v: JMoE.moe_ffn(
        p, jcfg, v, inference=inference))(jmoe, jnp.asarray(x))
    assert out.shape == x.shape and out.dtype == torch.float32
    assert rel(out.numpy(), np.asarray(jout)) < 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_moe_ffn_on_a_mesh_raises():
    _, cfg = configs()
    model = TM.Model(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 8"):
        TMoE.moe_ffn(model.stack.layers[0].moe, cfg,
                     torch.zeros(1, 4, cfg.d_model), ctx=object())


def test_router_stays_float32():
    """The router is float32 in a bf16 model, made or converted; the
    experts take the model's type and the reference's stacked layouts."""
    jcfg, cfg = configs(shared=True)
    made = TM.Model(cfg, torch.Generator().manual_seed(0), "cpu",
                    torch.bfloat16)
    tree = jax.tree.map(np.asarray, JM.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    conv = params_from_jax(cfg, tree, device="cpu", dtype=torch.bfloat16)
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    for model in (made, conv):
        moe = model.stack.layers[0].moe
        assert moe.router.dtype == torch.float32
        assert moe.router.shape == (D, E)
        assert (moe.w_gate.shape, moe.w_up.shape, moe.w_down.shape) == \
            ((E, D, F), (E, D, F), (E, F, D))
        assert moe.w_gate.dtype == moe.shared.w_gate.dtype == torch.bfloat16
        assert len(model.stack.prefix) == 1 and len(model.stack.layers) == 3
        assert model.stack.prefix[0].mlp.w_gate.shape == (D, 128)
    np.testing.assert_array_equal(
        conv.stack.layers[1].moe.router.numpy(),
        tree["stack"]["layers"]["moe"]["router"][1])


@pytest.fixture(scope="module")
def shared_pair():
    """The shared-expert, dense-prefix variant through both packages."""
    jcfg, cfg = configs(shared=True)
    jparams, params = converted(jcfg, cfg)
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
    return {"cfg": cfg, "jcfg": jcfg, "jparams": jparams, "params": params,
            "tokens": toks, "hidden": np.asarray(hidden),
            "logits": np.asarray(logits),
            "caches": jax.tree.map(np.asarray, caches),
            "decode": np.asarray(dec)}


@pytest.mark.parametrize("step", ["forward", "prefill", "decode"])
def test_shared_prefix_model_matches_reference(shared_pair, step):
    cfg, params = shared_pair["cfg"], shared_pair["params"]
    toks = torch.from_numpy(shared_pair["tokens"]).long()
    v = cfg.vocab
    if step == "forward":
        hidden, _ = TM.forward(params, cfg, {"tokens": toks[:, :S]},
                            inference=True)
        assert rel(hidden.numpy(), shared_pair["hidden"]) < 1e-4
        return
    logits, caches = prefill_step(params, cfg, {"tokens": toks[:, :S]},
                                  capacity=S + 8)
    if step == "prefill":
        assert rel(logits[:, :v].numpy(), shared_pair["logits"][:, :v]) < 1e-4
        assert sorted(caches) == sorted(shared_pair["caches"]) == \
            ["layers", "prefix"]
        for kind, layers in caches.items():
            ref = shared_pair["caches"][kind]
            for f, name in enumerate(layers[0]._fields):
                mine = torch.stack([getattr(c, name) for c in layers]).numpy()
                assert mine.shape == ref[f].shape, (kind, name)
                assert rel(mine, ref[f]) < 1e-4, (kind, name)
        return
    dec, new = TM.decode_step(params, cfg, toks[:, S:], caches)
    assert rel(dec[:, :v].numpy(), shared_pair["decode"][:, :v]) < 1e-4
    assert all(int(c.length.min()) == S + 1
               for layers in new.values() for c in layers)
    # the port's prefill + decode equals its own forward (5e-3, the bound
    # of tests/test_serve.py)
    hidden, _ = TM.forward(params, cfg, {"tokens": toks}, inference=True)
    ref = TM.logits(params, cfg, hidden[:, -1])
    assert rel(dec[:, :v].numpy(), ref[:, :v].numpy()) < 5e-3


def test_shared_prefix_session_matches_reference(shared_pair):
    """Four requests on two slots through both sessions: greedy token ids
    identical."""
    cfg = shared_pair["cfg"]

    def serve(module, sess):
        rng = np.random.default_rng(3)
        for i, n in enumerate((11, 5, 17, 8)):
            sess.submit(module.Request(
                request_id=i, prompt=rng.integers(0, cfg.vocab, n,
                                                  dtype=np.int32),
                max_new_tokens=5))
        return {r.request_id: r.generated
                for r in sess.run_to_completion(max_steps=200)}

    ref = serve(jax_engine, jax_engine.ServeSession(
        shared_pair["jparams"], shared_pair["jcfg"], batch_slots=2,
        capacity=32))
    sess = engine.ServeSession(shared_pair["params"], cfg, batch_slots=2,
                               capacity=32, device="cpu")
    assert serve(engine, sess) == ref
    assert sorted(ref) == [0, 1, 2, 3]
    assert sess.nonfinite_logits == 0
