"""The served model's cell on the CPU at a tiny size of the same
architecture (MLA, a dense first layer, routed and shared experts): the
reference against the port, the FLOP count by hand, the check passing a
sound run and failing the control and each fault this cell can have: a
step that hands back its state unchanged, half of the batch left out, a
token altered where it is produced. (The cell runs on one card: there is
no exchange between cards to leave out.)"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import harness, lm_flops
from portbench.control import Control
from portbench.gen import lm as gen_lm
from portbench.program import Program, serve_request
from portbench.reference import lm as ref_lm

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
CELL = "dsv2-lite.decode"

# DeepSeek-V2-Lite's config.json as published (the model-configs catalog)
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "seq_aux": True,
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
    "v_head_dim": 128, "vocab_size": 102400}


def test_the_configuration_is_the_published_one():
    config = harness.find_cell(CELL).config
    assert {k: config[k] for k in PUBLISHED} == PUBLISHED
    assert config["reduced"] == []
    assert set(config["departures"]) <= set(PUBLISHED)


def test_weights_are_the_seeds_and_the_published_size():
    config = harness.find_cell(CELL).config
    n = sum(np.prod(s) for i in range(config["num_hidden_layers"] + 1)
            for _, s in gen_lm.layer_shapes(config, i))
    assert 15.6e9 < n < 15.8e9                       # 15.7 B, 31.4 GB bf16
    tiny = harness.find_cell(CELL).config | _tiny()
    a, b = gen_lm.layer(tiny, 5, 1, CPU), gen_lm.layer(tiny, 5, 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], gen_lm.layer(tiny, 6, 1, CPU)["wq"])


def _tiny():
    from conftest import TINY_LM
    return dict(TINY_LM)


def _config(**kw):
    return {**harness.find_cell(CELL).config, **_tiny(), **kw}


def test_prefill_then_decode_agrees_with_the_full_forward():
    """The port's prefill, then decode through its latent cache one token
    at a time, against the reference's full forward over the same tokens,
    on logits, in float32 (where the two differ by round-off only)."""
    from repro_torch.serve import engine
    config = _config(dtype="float32")
    weights = gen_lm.model(config, SEED, CPU)
    sess = Program(CPU).serve_session(config, weights, 1, 64)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, config["vocab_size"], 20)
    follow = rng.integers(0, config["vocab_size"], 12)
    logits, caches = engine.prefill_step(
        sess.params, sess.cfg, {"tokens": torch.as_tensor(prompt[None])}, 64)
    got = [logits[0]]
    for t in follow:
        logits, caches = engine.decode_step(
            sess.params, sess.cfg, torch.as_tensor([[int(t)]]), caches)
        got.append(logits[0])
    want = ref_lm.logits(config, SEED, np.concatenate([prompt, follow]), CPU)
    got = torch.stack(got)
    want = want[len(prompt) - 1:]
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * want.abs().max())


def test_bf16_session_serves_within_the_limits():
    cell = harness.find_cell(CELL)
    config = _config()
    weights = gen_lm.model(config, SEED, CPU)
    sess = Program(CPU).serve_session(config, weights, 2, 96)
    rng = np.random.default_rng(4)
    reqs = [serve_request(i, rng.integers(0, 512, 10 + 7 * i,
                                          dtype=np.int32), 24)
            for i in range(3)]
    for r in reqs:
        sess.submit(r)
    sess.run_to_completion()
    gaps = ref_lm.served_gaps(config, SEED,
                              [(r.prompt, r.generated) for r in reqs], CPU)
    assert all(len(g) == 24 for g in gaps)
    assert max(g.max() for g in gaps) <= cell.limits["logit_gap_max"]


def test_flops_by_hand():
    """The tiny preset: D 64, 4 heads of 16 + 8 (v 16), latent 32; 3
    layers, a dense one of 128 and two of 8 experts of 32, top 2, and two
    shared (64); vocabulary 512."""
    config = _config()
    attn = 64 * 4 * 24 + 64 * (32 + 8) + 32 * 4 * (16 + 16) + 4 * 16 * 64
    assert attn == 6_144 + 2_560 + 4_096 + 4_096
    dense = 3 * 64 * 128
    moe = 64 * 8 + 2 * 3 * 64 * 32 + 3 * 64 * 64
    head = 64 * 512
    assert lm_flops.weight_macs(config) == 3 * attn + dense + 2 * moe + head
    assert lm_flops.attended_macs(config) == 3 * 4 * (24 + 16)
    # a prompt of 5 tokens attends over 1 + 2 + ... + 5 positions
    assert lm_flops.flops(config, 5, 15) == 2 * (
        5 * lm_flops.weight_macs(config) + 15 * 480)


def _run(small_cell, program, seed=SEED, seconds=3.0, trace=False,
         **config):
    cell = small_cell(CELL)
    cell = dataclasses.replace(cell, config={**cell.config, **config})
    return harness.run_cell(cell, seed, seconds, trace, CPU, program=program)


def test_sound_run_is_correct(small_cell):
    for trace in (False, True):
        res = _run(small_cell, Program(CPU), trace=trace)
        assert res["correct"], res["checks"]
        assert res["attempted"] > 0 and res["failed"] == 0
        json.loads(json.dumps(res, allow_nan=False))
    assert set(res["checks"]) == {"missing", "nonfinite_logits",
                                  "logit_gap_max", "logit_gap_mean"}


def test_the_window_counts_every_token_and_its_work(small_cell):
    """Every step returns a token for each of the full batch's slots (and
    a first token for each request it admits); the items of the window's
    steps are every token served in it, and the work counted is that of
    the tokens processed: one a slot a step, a prompt's in its prefill."""
    cell = small_cell(CELL)
    program = Program(CPU)
    loop, st = harness.prepare(cell, SEED, CPU, program)
    before = sum(st.served.values())
    run, sess, _ = harness.measure(cell, loop, st, program, 1.0, True, CPU)
    steps = [r for r in run.requests if r.name == "step"]
    slots = cell.traffic["batch_slots"]
    assert all(r.items >= slots for r in steps) and st.stalled == 0
    assert sum(r.items for r in steps) == sum(st.served.values()) - before
    for r in steps:
        admitted = r.items - slots
        assert r.meta["processed"] >= slots + admitted * 8
        assert r.meta["attended"] >= r.meta["processed"]
    assert (run.timings["prefill"] > 0) == any(
        r.items > slots for r in steps)


@pytest.mark.parametrize("seed", [SEED, 3, 2 ** 33 + 1])
def test_control_is_not_correct(small_cell, seed):
    """The reference on float8 e4m3 weights in the program's place, 12
    layers deep: as at full size, its error grows with depth past the
    limits (at 3 layers it reads about the limit)."""
    res = _run(small_cell, Control(CPU, {}), seed=seed, num_hidden_layers=12)
    assert not res["correct"]


def test_float32_serves_the_references_tokens(small_cell):
    """In float32 the program's slots, splices and caches serve exactly
    the reference's argmax at every position judged."""
    res = _run(small_cell, Program(CPU), dtype="float32")
    assert res["checks"]["logit_gap_max"]["value"] == 0.0


class Unchanged(Program):
    """Every decode step hands back the caches it was given: no position
    is kept, so each token is computed over the prompt alone."""

    def serve_session(self, *a):
        from repro_torch.serve import engine
        sess = super().serve_session(*a)
        real = engine.decode_step

        def step():
            engine.decode_step = lambda p, c, t, caches, ctx=None: (
                real(p, c, t, caches, ctx)[0], caches)
            try:
                return type(sess).step(sess)
            finally:
                engine.decode_step = real
        sess.step = step
        return sess


class HalfBatch(Program):
    """Each step serves only the first half of the slots: the others'
    tokens are taken back."""

    def serve_session(self, *a):
        sess = super().serve_session(*a)

        def step():
            before = {id(r): len(r.generated) for r in sess.slots if r}
            n = type(sess).step(sess)
            for r in sess.slots[len(sess.slots) // 2:]:
                if r is not None and id(r) in before:
                    del r.generated[before[id(r)]:]
            return n
        sess.step = step
        return sess


class AlteredToken(Program):
    """Every request's third token is replaced where it is produced."""

    def serve_session(self, *a):
        sess = super().serve_session(*a)
        vocab = sess.cfg.vocab

        def step():
            n = type(sess).step(sess)
            for i, r in enumerate(sess.slots):
                if r is not None and len(r.generated) == 3:
                    r.generated[2] = (r.generated[2] + 1) % vocab
                    sess.tokens[i, 0] = r.generated[2]
            return n
        sess.step = step
        return sess


@pytest.mark.parametrize("fault,number", [
    (Unchanged, "logit_gap_max"), (HalfBatch, "missing"),
    (AlteredToken, "logit_gap_max")])
def test_faults_are_not_correct(small_cell, fault, number):
    res = _run(small_cell, fault(CPU))
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
