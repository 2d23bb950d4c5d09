"""The port's modality frontends against the reference package on the CPU.

internvl2-2b (``vision_patches``: image embeddings through rmsnorm, fc1,
tanh-gelu and fc2, prepended to the text) and hubert-xlarge
(``audio_frames``: features through proj and rmsnorm, then a bidirectional
encoder) at their smoke sizes. The reference's ``init_model`` makes the
weights, ``params_from_jax`` hands them to the port, and the same
numpy-seeded inputs go through both in float32. ``apply_frontend`` and the
forward's hidden states and logits agree within 1e-4 (max |diff| over max
|reference|), the forward on the kernels' plain versions and on the
training path's plain mixers alike; internvl2's prefill logits within 1e-4
of the reference's, and its prefill + decode within 5e-3 of its forward,
the bound of tests/test_serve.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.serve.engine import prefill_step as jax_prefill
from repro_torch.configs import registry
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import prefill_step
from torch_parity import train_batch

ARCHS = ["internvl2_2b", "hubert_xlarge"]
B, S = 2, 20


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-30))


def inputs(cfg, seed=1):
    """The model inputs of a training batch (its labels dropped)."""
    return {k: v for k, v in train_batch(cfg, B, S, seed).items()
            if k != "labels"}


@functools.lru_cache(maxsize=None)
def converted(arch):
    """The reference's smoke config and params (seed 0), and the port's."""
    jcfg = jax_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jparams = jax.jit(JM.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return {"jcfg": jcfg, "jparams": jparams, "cfg": cfg, "params": params}


@pytest.fixture(params=ARCHS)
def model(request):
    return converted(request.param)


def test_apply_frontend_matches_reference(model):
    cfg = model["cfg"]
    batch = inputs(cfg)
    ref = JM.apply_frontend(model["jparams"], model["jcfg"],
                            {k: jnp.asarray(v) for k, v in batch.items()})
    out = TM.apply_frontend(model["params"], cfg,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out.shape == ref.shape
    assert rel(out.numpy(), ref) < 1e-4


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "plain-mixers"])
def test_forward_logits_match_reference(model, use_kernels):
    cfg, params = model["cfg"], model["params"]
    batch = inputs(cfg)
    hidden, _ = jax.jit(lambda p, b: JM.forward(p, model["jcfg"], b))(
        model["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    table = np.asarray(JM.head_table(model["jparams"], model["jcfg"]))
    out, aux = TM.forward(params, cfg,
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          use_kernels=use_kernels)
    assert rel(out.numpy(), hidden) < 1e-4 and float(aux) == 0.0
    ref = np.asarray(hidden) @ table.T
    logits = TM.logits(params, cfg, out).numpy()
    assert rel(logits[..., :cfg.vocab], ref[..., :cfg.vocab]) < 1e-4
    assert (logits[..., cfg.vocab:] == -1e30).all()


def test_internvl2_prefill_decode_equals_forward():
    """tests/test_serve.py's check on the port, and the port's prefill
    logits against the reference's."""
    m = converted("internvl2_2b")
    jcfg, jparams, cfg, params = (m[k] for k in ("jcfg", "jparams", "cfg",
                                                 "params"))
    P = cfg.frontend.num_prefix_tokens
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, 16 + 1 - P)).astype(np.int32)
    img = rng.standard_normal((B, P, cfg.frontend.feature_dim)) \
        .astype(np.float32)
    t, im = torch.from_numpy(toks).long(), torch.from_numpy(img)
    x, _ = TM.forward(params, cfg, {"tokens": t, "image_embeds": im},
                      inference=True)
    ref = TM.logits(params, cfg, x[:, -1])
    pre, caches = prefill_step(params, cfg, {"tokens": t[:, :-1],
                                             "image_embeds": im},
                               capacity=16 + 8)
    dec, _ = TM.decode_step(params, cfg, t[:, -1:], caches)
    v = cfg.vocab
    assert rel(dec[:, :v].numpy(), ref[:, :v].numpy()) < 5e-3
    jpre, _ = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :-1]),
                                          "image_embeds": jnp.asarray(img)},
                          capacity=16 + 8)
    assert rel(pre[:, :v].numpy(), np.asarray(jpre)[:, :v]) < 1e-4


def test_hubert_attends_both_ways():
    """The encoder is bidirectional: the last frame moves the first
    position's hidden state (a causal stack would not)."""
    m = converted("hubert_xlarge")
    cfg, params = m["cfg"], m["params"]
    feats = torch.from_numpy(inputs(cfg)["features"])
    moved = feats.clone()
    moved[:, -1] += 1.0
    a, _ = TM.forward(params, cfg, {"features": feats})
    b, _ = TM.forward(params, cfg, {"features": moved})
    assert not torch.allclose(a[:, 0], b[:, 0])
