"""The check fails what it must: each run below skips the look for a card
and drives the rest of a run on the CPU at a small size, with the timed
path broken underneath (or the control in its place), and ``correct``
must come out false. The faults are those these cells can have: an answer
altered where it is produced, half of a batch left out, a fit that hands
back its state unchanged. (Every cell runs on one card, so there is no
exchange between cards to leave out.)"""
import pytest
import torch

from portbench import harness
from portbench.control import Control
from portbench.program import Program

CPU = torch.device("cpu")
SEED = 2 ** 31 + 101


class AlteredPeak(Program):
    """The first call of the window (after two of warm-up) comes back with
    one peak moved."""
    calls = 0

    def reduce_frames(self, frames, dark, threshold, timings=None):
        out = super().reduce_frames(frames, dark, threshold, timings)
        type(self).calls += 1
        if type(self).calls == 3 and out[0].n_spots:
            out[0].peaks = out[0].peaks.copy()
            out[0].peaks[0, 1] += 0.5
        return out


class AlteredCount(Program):
    def reduce_frames(self, frames, dark, threshold, timings=None):
        out = super().reduce_frames(frames, dark, threshold, timings)
        out[-1].n_signal_pixels += 1
        return out


class HalfFrames(Program):
    """Only the first half of each window is reduced."""

    def reduce_frames(self, frames, dark, threshold, timings=None):
        keep = max(1, frames.shape[0] // 2)
        return super().reduce_frames(frames[:keep], dark, threshold, timings)


class Unchanged(Program):
    def fit_grid(self, y_obs, gvec, theta0, iters):
        return theta0.clone()


class HalfPoints(Program):
    """Only the first half of the grid is fitted; the rest keeps its
    starting orientation."""

    def fit_grid(self, y_obs, gvec, theta0, iters):
        half = y_obs.shape[0] // 2
        fitted = super().fit_grid(y_obs[:half], gvec, theta0[:half], iters)
        return torch.cat([fitted, theta0[half:]])


class AlteredFit(Program):
    """The first call of the window (after two of warm-up) comes back
    moved by 1e-3."""
    calls = 0

    def fit_grid(self, y_obs, gvec, theta0, iters):
        out = super().fit_grid(y_obs, gvec, theta0, iters)
        type(self).calls += 1
        return out + 1e-3 if type(self).calls == 3 else out


def _run(cell, program):
    return harness.run_cell(cell, SEED, 0.6, False, CPU, program=program)


@pytest.mark.parametrize("name,loop", [("nf-f32.stage1", "closed_windows"),
                                       ("nf-u16.frame1", "closed_windows"),
                                       ("nf-u16.frame1", "open_frames")])
def test_sound_program_is_correct(small_cell, name, loop):
    res = _run(small_cell(name, loop=loop, rate_hz=20.0), Program(CPU))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault,number", [
    ("nf-f32.stage1", AlteredPeak, "peak_gap"),
    ("nf-f32.stage1", AlteredCount, "count_mismatch"),
    ("nf-f32.stage1", HalfFrames, "missing"),
    ("nf-u16.frame1", AlteredPeak, "peak_gap"),
    ("nf-u16.frame1", AlteredCount, "count_mismatch")])
def test_stage1_faults_are_not_correct(small_cell, name, fault, number):
    """(A call of ``nf-u16.frame1`` carries one frame: it has no half.)"""
    fault.calls = 0
    res = _run(small_cell(name, rate_hz=20.0), fault(CPU))
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_refit_sound_program_is_correct(small_cell):
    res = _run(small_cell("nf-f32.refit"), Program(CPU))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [Unchanged, HalfPoints, AlteredFit])
def test_refit_faults_are_not_correct(small_cell, fault):
    fault.calls = 0
    res = _run(small_cell("nf-f32.refit"), fault(CPU))
    assert not res["correct"]
    assert res["checks"]["rot_gap_p99"]["value"] > \
        res["checks"]["rot_gap_p99"]["limit"]


@pytest.mark.parametrize("name", ["nf-f32.stage1", "nf-u16.frame1",
                                  "nf-f32.refit"])
@pytest.mark.parametrize("seed", [SEED, 3, 2 ** 33 + 1])
def test_control_is_not_correct(small_cell, name, seed):
    """The reference one precision down (bfloat16 for stage 1, TF32
    operands for stage 2) in the program's place fails the check."""
    cell = small_cell(name, rate_hz=20.0)
    res = harness.run_cell(cell, seed, 0.6, False, CPU,
                           program=Control(CPU, cell.config))
    assert not res["correct"]
