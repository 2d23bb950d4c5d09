"""The result line: its keys and types on a small run on the CPU, and the
command's refusals: no card, or a checkout that holds only the benchmark."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.program import Program

CPU = torch.device("cpu")


def _check_line(res, trace):
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert isinstance(res["correct"], bool)
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    assert res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(res, allow_nan=False))
    assert all(isinstance(c["value"], (int, float)) for c in res["checks"].values())


def test_result_line_of_each_cell(small_cell):
    for name in ("nf-f32.stage1", "nf-u16.frame1", "nf-f32.refit"):
        for trace in (False, True):
            cell = small_cell(name)
            res = harness.run_cell(cell, 2 ** 31 + 11, 0.5, trace, CPU)
            _check_line(res, trace)
            assert res["correct"]
            reported = {m["name"] for m in cell.reported(trace)}
            assert set(res["metrics"]) <= reported
            if not trace:
                assert set(res["metrics"]) == reported


def test_open_loop_answers_every_frame_due(small_cell):
    """The open loop (``loops/open_frames.py``, kept for a live cell)
    sends frame i at i / rate_hz and answers every frame due in the
    window, also past its end."""
    cell = small_cell("nf-u16.frame1", loop="open_frames", rate_hz=25.0)
    program = Program(CPU)
    loop, state = harness.prepare(cell, 9, CPU, program)
    run, sess, _ = harness.measure(cell, loop, state, program, 1.0, False,
                                   CPU)
    assert len(run.requests) == 25 and len(sess.answers) == 25
    assert [r.due - run.t0 for r in run.requests] == pytest.approx(
        [i / 25.0 for i in range(25)])
    assert all(r.sent >= r.due for r in run.requests)
    assert len(run.lateness) == 25
    assert harness.find_module("metrics", "frame_latency_p95_ms").read(
        run) > 0


def test_same_seed_same_inputs(small_cell):
    cell = small_cell("nf-u16.frame1")
    a = cell.loop().prepare(cell.config, cell.traffic, 2 ** 32 + 3, CPU)
    b = cell.loop().prepare(cell.config, cell.traffic, 2 ** 32 + 3, CPU)
    c = cell.loop().prepare(cell.config, cell.traffic, 5, CPU)
    assert (a.frames == b.frames).all() and (a.dark == b.dark).all()
    assert not (a.frames == c.frames).all()


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nf-u16.frame1",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_no_card_no_result():
    p = _run_py(harness.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
