"""The port's training path against the reference package on the CPU.

The reference's ``init_model`` makes the weights and ``params_from_jax``
hands them to the port; the same numpy-seeded batches go through both, in
float32. Compared as max |diff| over max |reference|:

* ``chunked_cross_entropy`` within 1e-6 (ignored labels, a padded vocab, a
  sequence that is no multiple of the chunk);
* ``loss_fn`` within 1e-5 and every grad leaf within 1e-4 of
  ``jax.value_and_grad`` for the seven smoke configs (the port with and
  without remat); a leaf exactly zero in JAX (hubert's token table, the
  padded vocab rows) is exactly zero in the port, whose grad there is
  ``None``;
* ``lr_schedule``, ``clip_by_global_norm`` and ``adamw_update``, and three
  ``make_train_step`` steps (parameters, master weights and moments within
  1e-4);
* microbatched grads against one batch with the reference's tolerance
  (tests/test_train.py), and a loss that falls on a repeated batch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import ShapeConfig as JShape
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT
from torch_parity import assert_trees_close, train_batch

ARCHS = ["qwen3_32b", "internvl2_2b", "hubert_xlarge", "qwen3_moe_30b_a3b",
         "deepseek_v2_lite_16b", "zamba2_7b", "rwkv6_3b"]
B, S = 2, 24


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-30))


@functools.lru_cache(maxsize=None)
def _reference(arch, seed):
    """The reference's smoke config and its params from ``seed`` (init
    jitted: eagerly it takes seconds a config)."""
    jcfg = jax_registry.get_smoke_config(arch)
    return jcfg, jax.jit(JM.init_model, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)


def pair(arch, seed=0):
    """(reference config, reference params, port config, a new port model
    with the same values, requiring grad)."""
    jcfg, jparams = _reference(arch, seed)
    cfg = registry.get_smoke_config(arch)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu").requires_grad_(True)
    return jcfg, jparams, cfg, params


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def grads_or_zeros(params):
    """{name: grad}, a missing grad as zeros (what JAX gives)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_,vocab,chunk", [(32, 512, 16), (37, 500, 16),
                                            (20, 512, 512)],
                         ids=["chunks", "padded-vocab-ragged", "one-chunk"])
def test_chunked_cross_entropy_matches_reference(S_, vocab, chunk):
    rng = np.random.default_rng(S_)
    x = rng.standard_normal((2, S_, 64)).astype(np.float32)
    table = (rng.standard_normal((512, 64)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, S_)).astype(np.int32)
    labels[:, ::5] = -100
    ref, (gx, gt) = jax.value_and_grad(
        lambda a, b: JM.chunked_cross_entropy(a, b, jnp.asarray(labels),
                                              vocab, chunk), (0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx, tt = (torch.from_numpy(a).requires_grad_(True) for a in (x, table))
    out = TM.chunked_cross_entropy(tx, tt, torch.from_numpy(labels), vocab,
                                   chunk)
    out.backward()
    assert abs(float(out.detach()) - float(ref)) <= 1e-6 * abs(float(ref))
    assert rel(tx.grad, gx) < 1e-5 and rel(tt.grad, gt) < 1e-5
    if vocab < 512:
        assert not tt.grad[vocab:].any()


# ---------------------------------------------------------------------------
# loss and grads, seven smoke configs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def reference_grads(request):
    arch = request.param
    jcfg, jparams, cfg, _ = pair(arch)
    batch = train_batch(cfg, B, S, seed=1)
    # remat changes no value, and the reference compiles faster without
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, remat=False), has_aux=True))(
        jparams, jax_batch(batch))
    return {"arch": arch, "batch": batch, "loss": float(loss),
            "aux": float(metrics["aux"]),
            "grads": jax.tree.map(np.asarray, grads)}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_loss_and_grads_match_reference(reference_grads, remat):
    ref = reference_grads
    _, _, cfg, params = pair(ref["arch"])
    loss, metrics = TM.loss_fn(params, cfg, torch_batch(ref["batch"]),
                               remat=remat)
    loss.backward()
    assert abs(float(loss.detach()) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(float(metrics["aux"].detach()) - ref["aux"]) <= 1e-5 * max(
        1.0, abs(ref["aux"]))
    assert_trees_close(params_to_jax(grads_or_zeros(params)), ref["grads"],
                       1e-4)


# ---------------------------------------------------------------------------
# blocked attention (the training path from BLOCKED_THRESHOLD tokens on)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "S_,H,KV,causal,window,q_chunk",
    [(32, 4, 2, True, 0, 8), (32, 4, 2, False, 0, 8), (30, 4, 1, True, 0, 8),
     (32, 4, 2, True, 16, 16), (200, 4, 2, True, 24, 40)],
    ids=["gqa-causal", "gqa-bidirectional", "ragged-chunk", "window-no-slab",
         "window-slab-clipped"])
def test_blocked_grouped_sdpa_matches_reference(S_, H, KV, causal, window,
                                                q_chunk):
    """S = 30 with chunks of 8 takes the largest divisor, 6, on both; a
    window of 24 with chunks of 40 over 200 positions takes the 128-wide key
    slab, its start clipped at 0 for the first two blocks. Values within
    1e-6 and the grads of q, k and v within 1e-4."""
    import repro.models.attention as JA
    import repro_torch.models.attention as TA
    rng = np.random.default_rng(S_ + window)
    q = rng.standard_normal((2, S_, H, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S_, KV, 16)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((2, S_, H, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, scale=0.25, q_chunk=q_chunk)

    def ref_fn(*a):
        out = JA.blocked_grouped_sdpa(*a, **kw)
        return jnp.sum(out * w), out
    (_, ref), ref_grads = jax.value_and_grad(ref_fn, (0, 1, 2),
                                             has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = TA.blocked_grouped_sdpa(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    assert rel(out.detach(), ref) < 1e-6
    for t, g in zip((tq, tk, tv), ref_grads):
        assert rel(t.grad, g) < 1e-4


@pytest.mark.parametrize("arch", ["qwen3_32b", "hubert_xlarge",
                                  "h2o_danube3_4b"])
def test_long_sequence_loss_takes_blocked_attention(arch, monkeypatch):
    """From ``BLOCKED_THRESHOLD`` tokens on (lowered to 32 on both sides)
    ``loss_fn`` attends through ``blocked_grouped_sdpa`` in both packages:
    causal GQA, hubert's bidirectional encoder and danube's sliding window.
    The loss within 1e-5 and every grad leaf within 1e-4."""
    import repro.models.attention as JA
    import repro_torch.models.attention as TA
    monkeypatch.setattr(JA, "BLOCKED_THRESHOLD", 32)
    monkeypatch.setattr(TA, "BLOCKED_THRESHOLD", 32)
    calls = []
    real = TA.blocked_grouped_sdpa
    monkeypatch.setattr(TA, "blocked_grouped_sdpa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jcfg, jparams, cfg, params = pair(arch)
    batch = train_batch(cfg, B, 40, seed=3)
    (ref, _), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jax_batch(batch), remat=False),
        has_aux=True)(jparams)
    loss, _ = TM.loss_fn(params, cfg, torch_batch(batch))
    assert len(calls) == cfg.n_layers      # remat calls it again in backward
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    assert_trees_close(params_to_jax(grads_or_zeros(params)),
                       jax.tree.map(np.asarray, grads), 1e-4)


def test_unreached_parameters_have_no_grad():
    """hubert's token table never enters its loss: PyTorch leaves its grad
    ``None`` where JAX gives zeros (the optimizer takes it as zeros)."""
    _, _, cfg, params = pair("hubert_xlarge")
    loss, _ = TM.loss_fn(params, cfg,
                         torch_batch(train_batch(cfg, B, S, seed=1)))
    loss.backward()
    assert params.embed.table.grad is None
    assert params.frontend.proj.grad is not None


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_jax_inverts_params_from_jax(arch):
    tree = jax.tree.map(np.asarray, _reference(arch, 0)[1])
    model = params_from_jax(registry.get_smoke_config(arch), tree,
                            device="cpu")
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    opt = TO.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    jopt = JO.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        ref = float(JO.lr_schedule(jopt, jnp.asarray(step)))
        assert abs(float(TO.lr_schedule(opt, step)) - ref) <= 1e-7 * ref
    # the reference's shape test (tests/test_train.py)
    opt = TO.OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                       min_lr_ratio=0.1)
    assert float(TO.lr_schedule(opt, 0)) < 0.11
    assert abs(float(TO.lr_schedule(opt, 10)) - 1.0) < 1e-6
    assert float(TO.lr_schedule(opt, 100)) <= 0.11


def _random_grads(params, scale, seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy((rng.standard_normal(tuple(p.shape))
                                 * scale).astype(np.float32))
            for n, p in params.named_parameters()}


@pytest.mark.parametrize("scale", [1e-4, 1.0], ids=["under", "clipped"])
def test_clip_by_global_norm_matches_reference(scale):
    _, _, _, params = pair("qwen3_32b")
    grads = _random_grads(params, scale, seed=4)
    ref_tree = params_to_jax(grads)
    ref, ref_norm = JO.clip_by_global_norm(
        jax.tree.map(jnp.asarray, ref_tree), 1.0)
    out, norm = TO.clip_by_global_norm(grads, 1.0)
    assert abs(float(norm) - float(ref_norm)) <= 1e-6 * float(ref_norm)
    assert_trees_close(params_to_jax(out), jax.tree.map(np.asarray, ref),
                       1e-6)


def test_adamw_update_matches_reference():
    """Three updates from the same grads, one grad missing (``None`` in
    the port, zeros in the reference): parameters, master weights, moments,
    step and lr."""
    _, jparams, _, params = pair("qwen3_32b")
    opt = TO.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = JO.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    state, jstate = TO.init_opt_state(params), JO.init_opt_state(jparams)
    jupdate = jax.jit(JO.adamw_update, static_argnums=3)
    for i in range(3):
        grads = _random_grads(params, 0.1, seed=10 + i)
        grads["final_norm.scale"] = None
        jgrads = params_to_jax({n: torch.zeros_like(p) if grads[n] is None
                                else grads[n]
                                for n, p in params.named_parameters()})
        jparams, jstate, jm = jupdate(
            jparams, jax.tree.map(jnp.asarray, jgrads), jstate, jopt)
        params, state, m = TO.adamw_update(params, grads, state, opt)
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-7
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert_trees_close(params_to_jax(params),
                       jax.tree.map(np.asarray, jparams), 1e-6)
    for k in ("master", "m", "v"):
        assert_trees_close(params_to_jax(state[k]),
                           jax.tree.map(np.asarray, jstate[k]), 1e-6)


def test_optimizer_state_dtypes():
    params, state = TT.init_train_state(torch.Generator().manual_seed(0),
                                        registry.get_smoke_config(
                                            "rwkv6_3b"), TO.OptConfig())
    assert all(p.requires_grad for p in params.parameters())
    assert state["step"].dtype == torch.int32
    for k in ("master", "m", "v"):
        assert all(t.dtype == torch.float32 for t in state[k].values())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

#: (arch, microbatches) of the train-step comparison: all seven smoke archs
STEP_CASES = [("qwen3_32b", 2), ("hubert_xlarge", 1), ("internvl2_2b", 2),
              ("qwen3_moe_30b_a3b", 2), ("deepseek_v2_lite_16b", 1),
              ("zamba2_7b", 2), ("rwkv6_3b", 1)]
#: the archs whose three chained steps hold every leaf element-wise
ELEMENTWISE = {"qwen3_32b", "hubert_xlarge", "qwen3_moe_30b_a3b"}


def _port_state(cfg, jparams, jstate):
    """A port model (requiring grad) and AdamW state holding the
    reference's values."""
    def named(tree):
        return {n: p.detach().float() for n, p in params_from_jax(
            cfg, jax.tree.map(np.asarray, tree),
            device="cpu").named_parameters()}
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu").requires_grad_(True)
    state = {"step": torch.tensor(int(jstate["step"]), dtype=torch.int32)}
    state.update({k: named(jstate[k]) for k in ("master", "m", "v")})
    return params, state


@pytest.mark.parametrize("arch,n_mb", STEP_CASES)
def test_train_steps_match_reference(arch, n_mb):
    """Three steps of ``make_train_step`` (remat on) on the same batches.

    Each step, once more from the reference's state before it: loss, grad
    norm and lr within 1e-5, and AdamW's m and v element-wise within 1e-4
    (they are linear in the step's grads). The port's own three chained
    steps from the same weights: each loss within 1e-5, then the
    parameters and master weights within 1e-4, element-wise for the
    ``ELEMENTWISE`` archs (with m and v too) and normwise (||diff|| /
    ||ref||) for the others. hubert's token table gets no grad (``None``):
    its moments stay 0 and weight decay still moves its master weights.

    Why normwise there: Adam moves an element whose grad is near its eps
    (1e-8) by lr g / (|g| + eps), so a float32 rounding of such a grad
    moves the parameter by up to a tenth of lr, and the next step's grads
    with it. Both float32 packages drift from a float64 run this way: after
    one step zamba2's LoRA ``b_q`` (zero before it) is 1.26e-4 normwise
    from float64 in the reference and 1.12e-4 in the port; after three
    chained steps rwkv6's grad norm is 62.2303 in the reference, 62.2022 in
    the port and 62.1965 in float64."""
    jcfg, jparams, cfg, params = pair(arch)
    opt = TO.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jopt = JO.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    shape = ShapeConfig("s", "train", 16, 4, num_microbatches=n_mb)
    jshape = JShape("s", "train", 16, 4, num_microbatches=n_mb)
    jstep = jax.jit(JT.make_train_step(jcfg, jshape, jopt))
    step = TT.make_train_step(cfg, shape, opt)
    state, jstate = TO.init_opt_state(params), JO.init_opt_state(jparams)
    for i in range(3):
        batch = train_batch(cfg, 4, 16, seed=20 + i)
        synced = _port_state(cfg, jparams, jstate)
        jparams, jstate, jm = jstep(jparams, jstate, jax_batch(batch))
        _, sstate, sm = step(*synced, torch_batch(batch))
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(sm[k]) - float(jm[k])) <= 1e-5 * abs(
                float(jm[k])), (i, k)
        for k in ("m", "v"):
            assert_trees_close(params_to_jax(sstate[k]),
                               jax.tree.map(np.asarray, jstate[k]), 1e-4)
        params, state, m = step(params, state, torch_batch(batch))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"])), i
    exact = arch in ELEMENTWISE
    assert_trees_close(params_to_jax(params),
                       jax.tree.map(np.asarray, jparams), 1e-4,
                       normwise=not exact)
    for k in ("master", "m", "v") if exact else ("master",):
        assert_trees_close(params_to_jax(state[k]),
                           jax.tree.map(np.asarray, jstate[k]), 1e-4,
                           normwise=not exact)


def test_train_steps_float32_against_float64():
    """Two steps of qwen3-32b's smoke config in float32 against the same
    steps in float64 (weights, activations, optimizer state; the grads
    handed over in float32) from the same weights: every parameter within
    1e-4 normwise (||diff|| / ||float64||), and AdamW's m and v element-wise
    within 1e-4 (max |diff| over max |float64|): the bounds the card is held
    to against the CPU. The parameters element-wise differ by more (2.52e-4
    of the largest in layer 0's ``wq``): Adam moves an element whose grad is
    near its eps (1e-8) by lr g / (|g| + eps), which a rounding of g moves
    by a tenth of lr."""
    import copy
    import dataclasses
    cfg = registry.get_smoke_config("qwen3_32b")
    cfg64 = dataclasses.replace(cfg, param_dtype="float64",
                                compute_dtype="float64")
    opt = TO.OptConfig(total_steps=10, warmup_steps=2, peak_lr=1e-3)
    shape = ShapeConfig("s", "train", 32, 4, num_microbatches=2)
    m32, s32 = TT.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   opt)
    m64 = copy.deepcopy(m32).double()
    s64 = TO.init_opt_state(m64)
    for k in ("master", "m", "v"):
        s64[k] = {n: t.double() for n, t in s64[k].items()}
    runs = [(TT.make_train_step(cfg, shape, opt), m32, s32),
            (TT.make_train_step(cfg64, shape, opt), m64, s64)]
    for i in range(2):
        toks = torch.from_numpy(np.random.default_rng(10 + i).integers(
            0, cfg.vocab, (4, 32)))
        for step, model, state in runs:
            step(model, state, {"tokens": toks, "labels": toks})
    for (n, p), (_, q) in zip(m32.named_parameters(), m64.named_parameters()):
        q = q.detach()
        assert float((p.detach().double() - q).norm() / q.norm()) < 1e-4, n
        for k in ("m", "v"):
            a, b = s32[k][n].double(), s64[k][n]
            assert float((a - b).abs().max() / b.abs().max()) < 1e-4, (k, n)


def test_microbatch_grads_match_full_batch():
    """internlm2's smoke config: two microbatches against one batch, with
    the reference's tolerance (tests/test_train.py)."""
    _, _, cfg, params = pair("internlm2_20b")
    batch = torch_batch(train_batch(cfg, 4, 32, seed=5))
    g1, l1, _ = TT.grads_and_loss(params, cfg, batch,
                                  ShapeConfig("a", "train", 32, 4, 1, True))
    g2, l2, m2 = TT.grads_and_loss(params, cfg, batch,
                                   ShapeConfig("a", "train", 32, 4, 2, True))
    assert abs(float(l1) - float(l2)) < 1e-3
    assert float(m2["aux"]) == 0.0 and float(m2["ce"]) == float(l2)
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), atol=3e-3,
                                   rtol=3e-2, err_msg=n)


def test_loss_decreases_on_repeated_batch():
    cfg = registry.get_smoke_config("qwen3_32b")
    opt = TO.OptConfig(total_steps=50, warmup_steps=5, peak_lr=3e-3)
    params, state = TT.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, opt)
    step = TT.make_train_step(cfg, ShapeConfig("s", "train", 32, 4,
                                               num_microbatches=2), opt)
    batch = {"tokens": torch.ones((4, 32), dtype=torch.int32),
             "labels": torch.ones((4, 32), dtype=torch.int32)}
    losses = []
    for _ in range(6):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8


def test_pod_branch_and_mesh_raise():
    cfg = registry.get_smoke_config("qwen3_32b")
    shape = ShapeConfig("s", "train", 16, 2)
    with pytest.raises(NotImplementedError, match="item 8"):
        TT.make_train_step(cfg, shape, TO.OptConfig(), compress_dcn=True)
    with pytest.raises(NotImplementedError, match="item 8"):
        TT.make_train_step(cfg, shape, TO.OptConfig(), ctx=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        TT.init_train_state(torch.Generator(), cfg, TO.OptConfig(),
                            compress_dcn=True)


def test_trainer_raises_for_frontend_archs_as_the_reference_does():
    """The launcher's batches carry tokens only, as the reference's do: a
    vision config misses its image embeddings in both packages."""
    from repro_torch.launch import train as launch_train
    jcfg, jparams, _, _ = pair("internvl2_2b")
    toks = jnp.zeros((2, 8), jnp.int32)
    with pytest.raises(KeyError, match="image_embeds"):
        JM.loss_fn(jparams, jcfg, {"tokens": toks, "labels": toks})
    with pytest.raises(KeyError, match="image_embeds"):
        launch_train.main(arch="internvl2-2b", smoke=True, steps=1, batch=2,
                          seq=8, device="cpu")


def test_served_model_builds_no_graph():
    """Serving keeps ``requires_grad`` off; prefill and decode run under
    ``no_grad`` even for a trainable model."""
    from repro_torch.serve.engine import prefill_step
    cfg = registry.get_smoke_config("qwen3_32b")
    model = TM.init_model(torch.Generator().manual_seed(0), cfg)
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    toks = torch.zeros((1, 6), dtype=torch.long)
    logits, caches = prefill_step(model, cfg, {"tokens": toks}, capacity=8)
    dec, _ = TM.decode_step(model, cfg, toks[:, :1], caches)
    assert logits.grad_fn is None and dec.grad_fn is None
    assert all(t.grad_fn is None for c in caches["layers"] for t in c)
