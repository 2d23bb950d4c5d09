"""The port's continuous-batching session against the reference's.

The same converted weights and the same numpy prompts go through the
reference's ``ServeSession`` and the port's (on the CPU, the kernels as
their plain versions). Four requests of different prompt lengths on two
slots: slots are freed and reused, so every cache is spliced into a slot
that held another request. Greedy token ids must be identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.serve import engine as jax_engine
from repro_torch.configs import registry
from repro_torch.launch import serve as launch
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine

PROMPTS = (11, 5, 17, 8)


def _requests(module, vocab, max_new):
    rng = np.random.default_rng(3)
    return [module.Request(request_id=i,
                           prompt=rng.integers(0, vocab, n, dtype=np.int32),
                           max_new_tokens=max_new)
            for i, n in enumerate(PROMPTS)]


def _serve(sess, reqs):
    for r in reqs:
        sess.submit(r)
    done = sess.run_to_completion(max_steps=200)
    return {r.request_id: r.generated for r in done}


@pytest.mark.parametrize("arch", ["zamba2_7b", "h2o_danube3_4b", "rwkv6_3b",
                                  "qwen3_moe_30b_a3b",
                                  "deepseek_v2_lite_16b"])
def test_session_matches_reference_session(arch):
    jcfg = jax_registry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    ref = _serve(jax_engine.ServeSession(jparams, jcfg, batch_slots=2,
                                         capacity=32),
                 _requests(jax_engine, cfg.vocab, 5))
    sess = engine.ServeSession(params, cfg, batch_slots=2, capacity=32,
                               device="cpu")
    out = _serve(sess, _requests(engine, cfg.vocab, 5))
    assert out == ref
    assert sorted(out) == list(range(len(PROMPTS)))
    assert all(len(g) == 5 for g in out.values())
    assert [n for _, n, _ in sess.timings["prefill"]] == list(PROMPTS)
    assert sess.nonfinite_logits == 0


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b",
                                  "qwen3-moe-30b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_launcher_serves_smoke_config_on_cpu(arch):
    out = launch.main(arch=arch, smoke=True, requests=3, slots=2,
                      prompt_len=(6, 20), max_new=3, capacity=32,
                      device="cpu", verbose=False)
    ph = out["phases"]
    assert len(out["finished"]) == 3
    assert all(len(r.generated) == 3 for r in out["finished"])
    assert [p["request"] for p in ph["prefill"]] == [0, 1, 2]
    cfg = registry.get_smoke_config(arch)
    assert out["cfg"] == cfg
    assert [p["tokens"] for p in ph["prefill"]] == [
        len(p) for p in launch.draw_prompts(cfg.vocab, 3, (6, 20), 0)]
    assert ph["decode_tokens"] == 3 * 2      # one token of each at prefill
    assert ph["nonfinite_logits"] == 0
    sess = out["session"]
    assert not sess.queue and not any(sess.slots)


def test_draw_prompts_is_seeded_and_in_range():
    a = launch.draw_prompts(32000)
    assert [len(p) for p in a] == [1781, 1398, 1172, 739, 807, 329, 390, 285]
    b = launch.draw_prompts(32000)
    assert all(np.array_equal(x, y) and x.dtype == np.int32
               for x, y in zip(a, b))
    assert all(0 <= x.min() and x.max() < 32000 for x in a)
    assert [len(p) for p in launch.draw_prompts(100, 3, 7, seed=1)] == [7] * 3


def test_entry_points_default_to_the_card():
    cfg = registry.get_smoke_config("zamba2_7b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    params = params_from_jax(
        cfg, jax.tree.map(np.asarray, JM.init_model(
            jax.random.PRNGKey(0), jax_registry.get_smoke_config("zamba2_7b"))),
        device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServeSession(params, cfg, batch_slots=1, capacity=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(smoke=True, verbose=False)
