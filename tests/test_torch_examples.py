"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/*.py``), both run here on the CPU.

Each reference example runs as it is, through its ``main``; what it
computes is recorded by wrapping the classes it calls (the staging client,
the dataflow, the driver, the serving session, ``jax.jit``'s train step).
The port's example gets the reference's weights through
``params_from_jax``. Held:

* ``api_quickstart`` and ``mapreduce_dataflow``: printed text identical,
  and every staging ``Report`` and the dataflow's engine statistics equal
  (the numpy simulator is a copy);
* ``serve_lm``: every served token identical (rwkv6-3b smoke), the
  makespan model's line identical;
* ``train_lm`` and ``quickstart``: the staging report equal, and every
  step's loss within 1e-5 |loss|, the bound tests/test_torch_train.py
  holds three steps to, here over all 12 and 20 steps. Adam's update lr g /
  (|g| + eps) magnifies float32 roundings of grads near eps, so the two
  packages drift apart step by step (ROADMAP §3), but on these configs not
  near the bound: at most 9.9e-7 over train_lm's 12 steps and 1.2e-6 over
  quickstart's 20 (measured here). ``quickstart``'s session serves the
  reference's trained weights on both sides, so its tokens are held
  identical;
* ``train_lm --fail-at``: the port restarts from its step-10 checkpoint
  and replays, its losses up to the failure equal to an uninterrupted
  run's (one thread: the same reductions in the same order); the
  reference's driver cannot restore its own tuple state (ROADMAP §3), so
  this is the port's alone.
"""
import importlib.util
import os
import sys
import types

import jax
import numpy as np
import pytest

from repro_torch.configs.registry import get_smoke_config
from repro_torch.examples import (api_quickstart, mapreduce_dataflow,
                                  quickstart, serve_lm, train_lm)
from repro_torch.models.convert import params_from_jax
from torch_parity import plain

ROOT = os.path.join(os.path.dirname(__file__), "..")
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these step-by-step runs of small models:
    beside other test workers, torch's thread pool oversubscribes the
    cores and each of the thousands of small ops waits on it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def reference(name):
    """The reference's example module, loaded from examples/ afresh."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def record_stage(mod, monkeypatch):
    """Every report of the module's ``StagingClient.stage``."""
    reports = []

    class Client(mod.StagingClient):
        def stage(self, *a, **k):
            reports.append(super().stage(*a, **k))
            return reports[-1]
    monkeypatch.setattr(mod, "StagingClient", Client)
    return reports


def record_session(mod, monkeypatch):
    """The weights each ``ServeSession`` of the module is made with, and
    the requests it finished."""
    seen = {"params": [], "finished": []}

    class Session(mod.ServeSession):
        def __init__(self, params, *a, **k):
            seen["params"].append(params)
            super().__init__(params, *a, **k)

        def run_to_completion(self, *a, **k):
            seen["finished"].append(super().run_to_completion(*a, **k))
            return seen["finished"][-1]
    monkeypatch.setattr(mod, "ServeSession", Session)
    return seen


def assert_losses_close(port, ref):
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (i, a, b)


def test_api_quickstart_matches_reference(capsys, monkeypatch):
    ref = reference("api_quickstart")
    reports = record_stage(ref, monkeypatch)
    ref.main()
    text = capsys.readouterr().out
    out = api_quickstart.main(device="cpu", verbose=False)
    assert out["text"] == text
    got = out["reports"]
    assert [plain(got[k]) for k in ("collective", "pipelined", "stream")] \
        == [plain(r) for r in reports]
    assert got["service"].leases[0].dataset == "scan/*.bin"


def test_mapreduce_dataflow_matches_reference(capsys, monkeypatch):
    ref = reference("mapreduce_dataflow")
    stats = []

    class Flow(ref.Dataflow):
        def run(self, *a, **k):
            stats.append(super().run(*a, **k))
            return stats[-1]
    monkeypatch.setattr(ref, "Dataflow", Flow)
    ref.main()
    text = capsys.readouterr().out
    out = mapreduce_dataflow.main(device="cpu", verbose=False)
    assert out["text"] == text
    assert plain(out["stats"]) == plain(stats[0])
    assert out["count"] == sum(i * i for i in range(32))
    assert out["first_merge"] < out["last_map"]


def test_serve_lm_matches_reference(capsys, monkeypatch):
    ref = reference("serve_lm")
    seen = record_session(ref, monkeypatch)
    ref.main()
    text = capsys.readouterr().out
    cfg = get_smoke_config("rwkv6_3b")
    out = serve_lm.main(device="cpu", verbose=False, params=params_from_jax(
        cfg, numpy_tree(seen["params"][0]), device="cpu"))
    ref_tokens = [(r.request_id, r.generated) for r in seen["finished"][0]]
    assert [(r.request_id, r.generated) for r in out["finished"]] == \
        ref_tokens
    assert len(ref_tokens) == 10 and all(len(t) == 6 for _, t in ref_tokens)
    # the wall-time line differs; the makespan line and tokens do not
    assert out["text"].splitlines()[1:] == text.splitlines()[1:]


def _reference_train_lm(monkeypatch, capsys, tmp_path, steps):
    ref = reference("train_lm")
    seen = {}

    class Driver(ref.TrainDriver):
        def __init__(self, store, build_step, **kw):
            def build(mesh_spec):
                step_fn, state = build_step(mesh_spec)
                seen.setdefault("init", numpy_tree(state[0]))
                return step_fn, state
            super().__init__(store, build, **kw)

        def run(self, *a, **k):
            seen["report"] = super().run(*a, **k)
            return seen["report"]
    monkeypatch.setattr(ref, "TrainDriver", Driver)
    monkeypatch.setattr(sys, "argv", [
        "train_lm.py", "--steps", str(steps), "--batch", "2", "--seq", "16",
        "--ckpt-dir", str(tmp_path / "reference")])
    ref.main()
    return seen, capsys.readouterr().out


def test_train_lm_matches_reference(capsys, monkeypatch, tmp_path):
    seen, text = _reference_train_lm(monkeypatch, capsys, tmp_path, 12)
    cfg = train_lm.PRESETS["demo"]
    out = train_lm.main(device="cpu", steps=12, batch=2, seq=16,
                        ckpt_dir=str(tmp_path / "port"), verbose=False,
                        params=params_from_jax(cfg, seen["init"],
                                               device="cpu"))
    rep, ref_rep = out["report"], seen["report"]
    assert_losses_close(rep.losses, ref_rep.losses)
    assert (rep.steps_completed, rep.checkpoints, rep.restarts) == \
        (ref_rep.steps_completed, ref_rep.checkpoints, 0) == (12, [10], 0)
    assert rep.losses[-1] < rep.losses[0]
    assert out["text"].splitlines()[:2] == text.splitlines()[:2]


def test_train_lm_restarts_from_its_checkpoint(tmp_path):
    runs = {name: train_lm.main(device="cpu", steps=12, batch=2, seq=16,
                                ckpt_dir=str(tmp_path / name),
                                fail_at=fail, verbose=False)["report"]
            for name, fail in (("straight", None), ("failed", 11))}
    straight, failed = runs["straight"], runs["failed"]
    assert (failed.restarts, failed.checkpoints, failed.steps_completed) == \
        (1, [10], 13)
    # steps 0..10 ran before the failure, then steps 10 and 11 from the
    # step-10 checkpoint on the stream's next batches
    assert failed.losses[:11] == straight.losses[:11]
    assert np.isfinite(failed.losses).all()


def test_quickstart_matches_reference(capsys, monkeypatch):
    ref = reference("quickstart")
    reports = record_stage(ref, monkeypatch)
    seen = record_session(ref, monkeypatch)
    init, losses = [], []

    def init_train_state(*a, **k):
        init.append(ref_init(*a, **k))
        return init[-1]
    ref_init = ref.init_train_state
    monkeypatch.setattr(ref, "init_train_state", init_train_state)

    def jit(fn):
        step = jax.jit(fn)

        def run(*a):
            out = step(*a)
            losses.append(float(out[2]["loss"]))
            return out
        return run
    monkeypatch.setattr(ref, "jax", types.SimpleNamespace(
        jit=jit, random=jax.random))
    ref.main()
    text = capsys.readouterr().out

    cfg = get_smoke_config("qwen3_32b")
    out = quickstart.main(device="cpu", verbose=False, params=params_from_jax(
        cfg, numpy_tree(init[0][0]), device="cpu"))
    assert plain(out["staging"]) == plain(reports[0])
    assert_losses_close(out["losses"], losses)
    assert len(losses) == 20 and out["losses"][-1] < out["losses"][0]
    assert out["text"].splitlines()[:4] == text.splitlines()[:4]
    # the same trained weights on both sides serve the same tokens
    finished = quickstart.serve(params_from_jax(
        cfg, numpy_tree(seen["params"][0]), device="cpu"), cfg, "cpu",
        say=lambda line: None)
    assert [(r.request_id, r.generated) for r in finished] == \
        [(r.request_id, r.generated) for r in seen["finished"][0]]


@pytest.mark.parametrize("name", ["api_quickstart", "mapreduce_dataflow",
                                  "serve_lm", "train_lm", "quickstart"])
def test_examples_need_a_card_by_default(name):
    mod = sys.modules[f"repro_torch.examples.{name}"]
    assert mod.main.__defaults__[0] == "cuda"
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main()


@pytest.mark.parametrize("mod", [api_quickstart, mapreduce_dataflow],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_examples_run_as_modules(mod):
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", mod.__name__, "--device",
                           "cpu"], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == mod.main(device="cpu", verbose=False)["text"]
