"""The Kimi-Linear cell on the CPU at a tiny size of the same architecture
(width 64; 4 KDA layers and 1 NoPE MLA layer; a dense first FFN, then 4
held of 16 sigmoid-routed experts, top 4, and a shared expert; vocabulary
512): the reference's KDA against the token-by-token recurrence, the
reference against the port, discovery of the cell's files, the FLOP and
byte counts by hand, and the check passing a sound run and failing the
control and each fault this model can have: a reused slot's stale KDA
state, the router's correction bias dropped, its scaling (2.446) dropped,
rope applied in MLA, a held expert's output computed for an expert not
held. (The cell runs on one card: there is no exchange to leave out.)"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import harness, kimi_linear_flops, program_kimi_linear
from portbench.control import Control
from portbench.gen import kimi_linear as gen_kl
from portbench.program import Program
from portbench.reference import kimi_linear as ref_kl

CPU = torch.device("cpu")
SEED = 2 ** 31 + 29
CELL = "kimi-linear-48b.decode256"
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
        "num_experts": 4, "num_experts_published": 16,
        "experts_held_from": 4, "num_experts_per_token": 4,
        "moe_intermediate_size": 32, "intermediate_size": 96,
        "vocab_size": 512, "num_hidden_layers": 5,
        "linear_attn_config": {"full_attn_layers": [3],
                               "kda_layers": [1, 2, 4, 5], "head_dim": 16,
                               "num_heads": 4, "short_conv_kernel_size": 4}}
MIX = {"clients": 4, "requests_per_client": 4, "batch_slots": 4,
       "capacity": 160, "prompt_tokens": [8, 40], "answer_tokens": [8, 100],
       "judged": 3}
# The cell's limits are set for 27 layers 2,304 wide, whose bf16 logit
# gaps are some twenty times the tiny model's. Here they are set the same
# way: between the sound program's readings in bf16 (largest 0.0068 /
# 0.0047 / 0.040 of logit_gap_mean / kda_state_gap / mla_latent_gap over
# seeds SEED, 3 and 2**33 + 1, two runs each) and the control's (smallest
# 0.066 / 0.066 / 0.109).
LIMITS = {"missing": 0, "nonfinite_logits": 0, "logit_gap_mean": 0.025,
          "kda_state_gap": 0.015, "mla_latent_gap": 0.07}


def _config(**kw):
    return {**harness.find_cell(CELL).config, **TINY, **kw}


def _cell(**config):
    cell = harness.find_cell(CELL)
    assert set(cell.limits) == set(LIMITS)
    return dataclasses.replace(cell, config=_config(**config),
                               traffic={**cell.traffic, **MIX},
                               limits=LIMITS)


def _run(program, seed=SEED, seconds=2.0, trace=False, **config):
    return harness.run_cell(_cell(**config), seed, seconds, trace, CPU,
                            program=program)


def test_the_configuration_is_the_published_one():
    """Every key of the published config.json as published but the
    experts held, which ``reduced`` names beside the published count."""
    catalog = {"first_k_dense_replace": 1, "head_dim": 72,
               "hidden_act": "silu", "hidden_size": 2304,
               "intermediate_size": 9216, "kv_lora_rank": 512,
               "linear_attn_config": {
                   "full_attn_layers": [4, 8, 12, 16, 20, 24, 27],
                   "head_dim": 128,
                   "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15,
                                  17, 18, 19, 21, 22, 23, 25, 26],
                   "num_heads": 32, "short_conv_kernel_size": 4},
               "mla_use_nope": True, "model_max_length": 1048576,
               "model_type": "kimi_linear", "moe_intermediate_size": 1024,
               "moe_layer_freq": 1, "moe_renormalize": True,
               "moe_router_activation_func": "sigmoid",
               "num_attention_heads": 32, "num_expert_group": 1,
               "num_experts": 256, "num_experts_per_token": 8,
               "num_hidden_layers": 27, "num_key_value_heads": 32,
               "num_nextn_predict_layers": 0, "num_shared_experts": 1,
               "q_lora_rank": None, "qk_nope_head_dim": 128,
               "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
               "rope_scaling": None, "rope_theta": 10000,
               "routed_scaling_factor": 2.446, "tie_word_embeddings": False,
               "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
               "vocab_size": 163840}
    config = harness.find_cell(CELL).config
    assert config["reduced"] == ["num_experts"]
    assert {k: v for k, v in config.items() if k in catalog
            and k not in config["reduced"]} == {
        k: v for k, v in catalog.items() if k not in config["reduced"]}
    assert (config["num_experts"], config["num_experts_published"],
            config["experts_held_from"]) == (64, 256, 0)


def test_weights_are_the_seeds_and_the_cut_size():
    config = harness.find_cell(CELL).config
    n = sum(np.prod(s) for i in range(config["num_hidden_layers"] + 1)
            for _, s in gen_kl.layer_shapes(config, i))
    assert 13.7e9 < n < 13.8e9                   # 13.79 B with the routers
    a, b = gen_kl.layer(_config(), 5, 1, CPU), gen_kl.layer(_config(), 5, 1,
                                                            CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], gen_kl.layer(_config(), 6, 1, CPU)["wq"])


@pytest.mark.parametrize("T,chunk,g_min", [(37, 8, -1.0), (64, 16, -16.0),
                                            (5, 64, -3.0), (130, 64, -16.0)])
def test_reference_chunks_match_the_recurrence(T, chunk, g_min):
    gen = torch.Generator().manual_seed(T)
    H, K = 3, 8
    q = torch.randn((T, H, K), generator=gen)
    k = F.normalize(torch.randn((T, H, K), generator=gen), dim=-1)
    v = torch.randn((T, H, K), generator=gen)
    g = torch.rand((T, H, K), generator=gen) * g_min
    beta = torch.rand((T, H), generator=gen)
    s0 = torch.randn((H, K, K), generator=gen)
    o, s = ref_kl.kda_chunks(q, k, v, g, beta, s0, chunk)
    o_ref, s_ref = ref_kl.kda_recurrent(*(t.double() for t in
                                          (q, k, v, g, beta, s0)))
    assert torch.isfinite(o).all()
    assert torch.allclose(o.double(), o_ref, atol=2e-5)
    assert torch.allclose(s.double(), s_ref, atol=2e-5)


def test_prefill_then_decode_agrees_with_the_reference():
    """The port's prefill and decode through its caches against the
    reference's full forward, on logits, in float32."""
    from repro_torch.serve import engine
    config = _config(dtype="float32")
    sess = program_kimi_linear.serve_session(
        config, gen_kl.model(config, SEED, CPU), 1, 64, CPU)
    rng = np.random.default_rng(3)
    prompt, follow = rng.integers(0, 512, 21), rng.integers(0, 512, 12)
    logits, caches = engine.prefill_step(
        sess.params, sess.cfg, {"tokens": torch.as_tensor(prompt[None])}, 64)
    got = [logits[0]]
    for t in follow:
        logits, caches = engine.decode_step(
            sess.params, sess.cfg, torch.as_tensor([[int(t)]]), caches)
        got.append(logits[0])
    want = ref_kl.logits(config, SEED, np.concatenate([prompt, follow]), CPU)
    got = torch.stack(got)[:, :512]
    want = want[len(prompt) - 1:]
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * want.abs().max())


def test_reference_keeps_what_the_port_keeps():
    """What the check reads: the port's first KDA layer's state and its
    first MLA layer's latent cache in a slot after a prefill and decode
    steps, in float32, against the reference's after the same tokens; the
    slot read is the request's own."""
    from portbench import judge_kimi_linear
    from repro_torch.serve.engine import Request
    config = _config(dtype="float32")
    sess = program_kimi_linear.serve_session(
        config, gen_kl.model(config, SEED, CPU), 3, 64, CPU)
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, 512, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(9, 30), (21, 6), (14, 30)])]
    for r in reqs[:2]:
        sess.submit(r)
    for _ in range(8):                   # the second finishes, its slot
        sess.step()                      # goes to the third
    sess.submit(reqs[2])
    for _ in range(3):
        sess.step()
    live = judge_kimi_linear.state_sample([reqs[0], reqs[2]])
    assert [r.request_id for r in live] == [0, 2]
    assert reqs[2].slot == reqs[1].slot
    toks = [judge_kimi_linear.state_tokens(r) for r in live]
    kept = [(t, program_kimi_linear.first_kda_state(sess, r.slot),
             program_kimi_linear.first_mla_latent(sess, r.slot, len(t)))
            for t, r in zip(toks, live)]
    refs = zip(ref_kl.kda_states(config, SEED, toks, CPU),
               ref_kl.mla_latents(config, SEED, toks, CPU))
    for (_, state, latent), (s_ref, c_ref) in zip(kept, refs):
        assert torch.allclose(state, s_ref, rtol=0,
                              atol=1e-5 * s_ref.abs().max())
        assert torch.allclose(latent, c_ref, rtol=0,
                              atol=1e-5 * c_ref.abs().max())
    for gaps in judge_kimi_linear.kept_gaps(config, SEED, kept, CPU):
        assert max(gaps) < 1e-5


def test_cell_loop_and_readers_are_found():
    cell = harness.find_cell(CELL)
    assert cell.loop().__name__.endswith("serve_closed_kimi_linear")
    names = {m["name"] for m in cell.metrics}
    assert names == {"decode_tokens_per_s", "setup_s", "kda_decode_roofline",
                     "kda_share.decode256", "decode_mfu.kimi-linear-48b",
                     "kernels_per_step.decode256", "device_idle.decode256",
                     "prefill_share.decode256"}
    for m in cell.metrics:
        mod = harness.find_module("metrics", m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
    assert harness.find_module(
        "metrics", "decode_mfu.kimi-linear-48b").LAYER == \
        "serve: serve.engine.ServeSession"


def _kda_step_bytes(slots):
    """The tiny preset's KDA bytes a decode step, by hand: 4 layers, each
    slot's float32 state (4 heads of 16 x 16) read and written, and the
    weights once: bf16 ``wq``/``wk``/``wv``/``wo`` (64 x 64), the conv taps
    (3 x 4 x 64), the low-rank pairs (2 x (64 x 16 + 16 x 64)), ``w_beta``
    (64 x 4), ``g_bias`` (64), ``o_norm`` (16); float32 ``A_log`` (4) and
    ``dt_bias`` (64)."""
    bf16 = 4 * 64 * 64 + 3 * 4 * 64 + 2 * (64 * 16 + 16 * 64) + 64 * 4 \
        + 64 + 16
    return 4 * (2 * slots * 4 * 4 * 16 * 16 + 2 * bf16 + 4 * (4 + 64))


def test_flops_and_bytes_by_hand():
    """The tiny preset: D 64; 4 KDA layers (4 heads of 16, conv 4, low
    rank 16) and 1 MLA layer (4 heads of 16 + 8, v 16, latent 32); a dense
    layer of 96 and 4 expert layers of 16 experts of 32, 4 held, top 4,
    one shared; vocabulary 512."""
    config = _config()
    kda = 3 * 64 * 64 + 3 * 4 * 64 + 2 * (64 * 16 + 16 * 64) + 64 * 4 \
        + 64 * 64
    assert kimi_linear_flops.kda_weights(config) == kda
    mla = 64 * 4 * 24 + 64 * (32 + 8) + 32 * 4 * (16 + 16) + 4 * 16 * 64
    moe = 64 * 16 + 4 * 4 * 3 * 64 * 32 // 16 + 3 * 64 * 32
    assert kimi_linear_flops.weight_macs(config) == (
        4 * kda + mla + 3 * 64 * 96 + 4 * moe + 64 * 512)
    assert kimi_linear_flops.state_macs(config) == 4 * 3 * 4 * 16 * 16
    assert kimi_linear_flops.attended_macs(config) == 4 * (24 + 16)
    assert kimi_linear_flops.flops(config, 5, 15) == 2 * (
        5 * (kimi_linear_flops.weight_macs(config) + 12288) + 15 * 160)
    # the bytes the program counts a decode step, at 3 slots
    sess = program_kimi_linear.serve_session(
        config, gen_kl.model(config, SEED, CPU), 3, 32, CPU)
    from repro_torch.core import telemetry
    from repro_torch.serve.engine import Request
    sess.submit(Request(0, np.arange(6, dtype=np.int32), 2))
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        sess.step()
    assert tr.metrics.snapshot()["counters"]["serve.kda_state_bytes"] == \
        _kda_step_bytes(3)


def test_sound_run_is_correct_and_reads_its_metrics():
    for trace in (False, True):
        res = _run(Program(CPU), trace=trace)
        assert res["correct"], res["checks"]
        assert res["attempted"] > 0 and res["failed"] == 0
        json.loads(json.dumps(res, allow_nan=False))
    assert set(res["checks"]) == {"missing", "nonfinite_logits",
                                  "logit_gap_mean", "kda_state_gap",
                                  "mla_latent_gap"}


def test_traced_window_copies_the_sums_its_readers_need():
    """A trace run records the port's serving spans over the window: on
    the CPU the spans carry no device seconds, so the program-span
    readers report nothing, and the counted bytes are the decode steps'."""
    cell = _cell()
    program = Program(CPU)
    loop, st = harness.prepare(cell, SEED, CPU, program)
    run, _, _ = harness.measure(cell, loop, st, program, 1.0, True, CPU)
    t = run.timings
    assert t["decode_steps"] > 0 and t["kda_device_s"] == 0.0
    assert t["kda_state_bytes"] == t["decode_steps"] * \
        _kda_step_bytes(MIX["batch_slots"])
    for name in ("kda_decode_roofline", "kda_share.decode256"):
        assert harness.find_module("metrics", name).read(run) is None
    run.timings.update(kda_device_s=0.5, decode_device_s=2.0)
    assert harness.find_module("metrics", "kda_share.decode256").read(
        run) == 25.0


def test_float32_serves_the_references_tokens():
    res = _run(Program(CPU), dtype="float32")
    assert res["checks"]["logit_gap_mean"]["value"] == 0.0
    assert res["checks"]["kda_state_gap"]["value"] < 1e-5
    assert res["checks"]["mla_latent_gap"]["value"] < 1e-5


@pytest.mark.parametrize("seed", [SEED, 3])
def test_control_is_not_correct(seed):
    """The reference on float8 e4m3 weights in the program's place."""
    res = _run(Control(CPU, {}), seed=seed)
    assert not res["correct"]
    for name in ("logit_gap_mean", "kda_state_gap", "mla_latent_gap"):
        assert res["checks"][name]["value"] > LIMITS[name]


class _Faulty(Program):
    """A program whose Kimi-Linear session is broken by ``breaks``."""

    def serve_kimi_linear(self, config, weights, slots, capacity):
        sess = program_kimi_linear.serve_session(config, weights, slots,
                                                 capacity, self.device)
        self.breaks(sess)
        return sess


class StaleState(_Faulty):
    """A reused slot keeps the KDA state its last request left."""

    @staticmethod
    def breaks(sess):
        from repro_torch.models.kda import KDAState
        splice = type(sess)._splice

        def keep_state(slot, caches_new, token):
            kept = {id(c): c.s[slot].clone() for kind in sess.caches
                    for c in sess.caches[kind] if isinstance(c, KDAState)}
            splice(sess, slot, caches_new, token)
            for kind in sess.caches:
                for c in sess.caches[kind]:
                    if isinstance(c, KDAState):
                        c.s[slot] += kept[id(c)]
        sess._splice = keep_state


class NoBias(_Faulty):
    """The router's correction bias is left out of the selection (drawn
    ten times wider than the cell's, so that at 16 experts it moves the
    selection as often as at 256)."""
    bias_std = 10 * gen_kl.BIAS_STD

    @staticmethod
    def breaks(sess):
        for name, p in sess.params.named_parameters():
            if name.endswith("router_bias"):
                p.zero_()


class NoScaling(_Faulty):
    """The routed experts' weights are not scaled by 2.446."""

    @staticmethod
    def breaks(sess):
        sess.cfg = dataclasses.replace(sess.cfg, moe=dataclasses.replace(
            sess.cfg.moe, routed_scaling=1.0))


class Rotated(_Faulty):
    """RoPE is applied in the MLA layers, which are NoPE."""

    @staticmethod
    def breaks(sess):
        sess.cfg = dataclasses.replace(sess.cfg, mla=dataclasses.replace(
            sess.cfg.mla, rope=True))


class NotHeld(_Faulty):
    """The held experts' outputs are weighed as the next four experts',
    which this layer does not hold."""

    @staticmethod
    def breaks(sess):
        sess.cfg = dataclasses.replace(sess.cfg, moe=dataclasses.replace(
            sess.cfg.moe, held_from=sess.cfg.moe.held_from + 4))


@pytest.mark.parametrize("fault", [StaleState, NoBias, NoScaling, Rotated,
                                   NotHeld], ids=lambda f: f.__name__)
def test_faults_are_not_correct(fault, monkeypatch):
    monkeypatch.setattr(gen_kl, "BIAS_STD",
                        getattr(fault, "bias_std", gen_kl.BIAS_STD))
    res = _run(fault(CPU), seconds=3.0)
    assert not res["correct"]
    assert any(res["checks"][n]["value"] > LIMITS[n]
               for n in ("logit_gap_mean", "kda_state_gap", "mla_latent_gap"))
    if fault is StaleState:     # the slot's state read on its own
        assert res["checks"]["kda_state_gap"]["value"] > 10 * LIMITS[
            "kda_state_gap"]
