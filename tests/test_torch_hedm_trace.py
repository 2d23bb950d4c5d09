"""The HEDM hot path's recording (`repro_torch.core.telemetry.recording`):
the span trees and counters of ``reduce_frames`` and ``fit_grid``, results
bit-identical with recording on and off, and nothing read, made or
synchronized with it off. On the CPU; the CUDA-event timing of the device
phases is checked on the card (``tests/test_torch_cuda.py``)."""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import telemetry
from repro_torch.hedm import pipeline as T

CPU = torch.device("cpu")
STAGE1_CHILDREN = ("stage1.h2d", "stage1.filter", "stage1.d2h",
                   "stage1.index")


def _scan(n=3, size=48, dtype=np.float32, seed=2):
    frames, dark = T.simulate_detector_frames(n, size=size, n_spots=4,
                                              seed=seed)
    return frames.astype(dtype), dark


def _grid(points=40):
    gvec = T.make_gvectors()
    _, obs = T.synth_grid_observations(points, gvec, device=CPU)
    return obs, gvec, np.zeros((points, 3), np.float32)


def _inside(child, parent):
    return parent.t_start <= child.t_start <= child.t_end <= parent.t_end


def _same(a, b):
    assert T.pack_reduced(a).tobytes() == T.pack_reduced(b).tobytes()


def test_current_defaults_to_the_null_tracer_and_recording_restores():
    assert telemetry.current() is telemetry.NULL_TRACER
    outer, inner = telemetry.Tracer(), telemetry.Tracer()
    with telemetry.recording(outer) as got:
        assert got is outer and telemetry.current() is outer
        with telemetry.recording(inner):
            assert telemetry.current() is inner
        assert telemetry.current() is outer
    assert telemetry.current() is telemetry.NULL_TRACER


def test_recording_is_scoped_to_its_thread():
    seen = []
    with telemetry.recording(telemetry.Tracer()):
        t = threading.Thread(target=lambda: seen.append(telemetry.current()))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [telemetry.NULL_TRACER]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.float64])
def test_reduce_frames_span_tree(use_kernel, dtype):
    frames, dark = _scan(dtype=dtype)
    F = frames.shape[0]
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        for _ in range(2):
            T.reduce_frames(frames, dark, use_kernel=use_kernel, device=CPU)
    roots = tr.roots()
    assert [r.name for r in roots] == ["stage1.reduce_frames"] * 2
    for root in roots:
        assert root.track == "host"
        assert root.attrs == {"frames": F, "dtype": np.dtype(dtype).name}
        kids = tr.children(root)
        names = [k.name for k in kids]
        assert tuple(names[:4]) == STAGE1_CHILDREN
        assert names[4:] == ["stage1.labels", "stage1.centroids"] * F
        for k in kids:
            assert k.track == "host" and _inside(k, root)
            assert not tr.children(k)
        for a, b in zip(kids, kids[1:]):       # in order, not overlapping
            assert a.t_end <= b.t_start
        for k in kids[:3]:                      # device seconds: a card's
            assert k.attrs["device_s"] is None


@pytest.mark.parametrize("use_kernel", [True, False])
def test_host_path_labels_no_frame_on_the_card(use_kernel):
    # the CPU, like use_kernel=False on a card, takes the host path: the
    # card's labeling counter stays 0 and the host's span tree is whole
    frames, dark = _scan(n=3, size=40, dtype=np.uint16)
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        T.reduce_frames(frames, dark, use_kernel=use_kernel, device=CPU)
    counters = tr.metrics.snapshot()["counters"]
    assert counters.get("stage1.card_labeled_frames", 0) == 0
    assert counters["stage1.frames"] == 3
    (root,) = tr.roots()
    names = [k.name for k in tr.children(root)]
    assert names == list(STAGE1_CHILDREN) + [
        "stage1.labels", "stage1.centroids"] * 3
    assert not {"stage1.label", "stage1.unpack"} & set(names)


def test_reduce_frames_counters_are_the_arithmetic():
    frames, dark = _scan(n=3, size=40, dtype=np.uint16)
    F, H, W = frames.shape
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        T.reduce_frames(frames, dark, device=CPU)
        T.reduce_frames(frames[:1], dark, device=CPU)
    c = tr.metrics.snapshot()["counters"]
    # the frames and a float32 dark of H x W a call
    assert c == {"stage1.frames": F + 1,
                 "stage1.h2d_bytes": (frames.nbytes + frames[:1].nbytes
                                      + 2 * H * W * 4)}


def test_reduce_frames_counts_the_float32_copy_of_other_dtypes():
    frames, dark = _scan(n=2, size=32, dtype=np.float64)
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        T.reduce_frames(frames, dark, device=CPU)
    c = tr.metrics.snapshot()["counters"]
    assert c["stage1.h2d_bytes"] == frames.astype(np.float32).nbytes \
        + 32 * 32 * 4


@pytest.mark.parametrize("iters", [1, 3])
def test_fit_grid_records_a_step_a_iteration(iters):
    obs, gvec, theta0 = _grid()
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        T.fit_grid(obs, gvec, theta0, iters=iters, device=CPU)
        T.fit_grid(obs, gvec, theta0, iters=iters, device=CPU)
    roots = tr.roots()
    assert [r.name for r in roots] == ["stage2.fit_grid"] * 2
    for root in roots:
        assert root.track == "host"
        assert root.attrs == {"points": obs.shape[0],
                              "n_gvec": gvec.shape[0], "iters": iters}
        steps = tr.children(root)
        assert [s.name for s in steps] == ["stage2.gn_step"] * iters
        assert [s.attrs["step"] for s in steps] == list(range(iters))
        for step in steps:
            assert _inside(step, root) and step.track == "host"
            kids = tr.children(step)
            assert [k.name for k in kids] == [
                "stage2.residual", "stage2.jacobian", "stage2.solve"]
            assert all(_inside(k, step) for k in kids)
            assert [kids[0].t_start, kids[0].t_end, kids[1].t_end,
                    kids[2].t_end] == [step.t_start, kids[1].t_start,
                                       kids[2].t_start, step.t_end]
    assert tr.metrics.snapshot()["counters"] == {}


def test_outputs_are_bit_identical_with_recording_on_and_off():
    frames, dark = _scan(n=4, size=64)
    off = T.reduce_frames(frames, dark, device=CPU)
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        on = T.reduce_frames(frames, dark, device=CPU, timings={})
    assert sum(r.n_spots for r in off) >= 4
    _same(on, off)
    obs, gvec, theta0 = _grid()
    fit_off = T.fit_grid(obs, gvec, theta0, device=CPU)
    with telemetry.recording(tr):
        fit_on = T.fit_grid(obs, gvec, theta0, device=CPU)
    assert torch.equal(fit_on, fit_off)
    assert len(tr.spans) > 0


class _NoClock:
    """Stands in for the ``time`` module: any clock read raises."""

    def perf_counter(self):
        raise AssertionError("a clock was read with recording off")


def _refuse(what):
    def raiser(*args, **kwargs):
        raise AssertionError(f"{what} with recording off")
    return raiser


def test_off_reads_no_clock_makes_no_event_and_never_synchronizes(
        monkeypatch):
    frames, dark = _scan(n=2, size=40, dtype=np.uint16)
    obs, gvec, theta0 = _grid()
    want = T.reduce_frames(frames, dark, device=CPU)
    want_fit = T.fit_grid(obs, gvec, theta0, iters=2, device=CPU)
    idle = telemetry.Tracer()              # made, but never current
    monkeypatch.setattr(T, "_time", _NoClock())
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse("synchronize"))
    monkeypatch.setattr(torch.cuda, "Event", _refuse("a CUDA event"))
    _same(T.reduce_frames(frames, dark, device=CPU), want)
    assert torch.equal(T.fit_grid(obs, gvec, theta0, iters=2, device=CPU),
                       want_fit)
    assert idle.spans == [] and idle.metrics.snapshot()["counters"] == {}
    assert telemetry.current() is telemetry.NULL_TRACER


@pytest.mark.parametrize("recording", [False, True])
def test_timings_keeps_its_four_phases(recording):
    frames, dark = _scan(n=2, size=40)
    timings = {}
    tr = telemetry.Tracer() if recording else telemetry.NULL_TRACER
    with telemetry.recording(tr):
        T.reduce_frames(frames, dark, device=CPU, timings=timings)
        once = dict(timings)
        T.reduce_frames(frames, dark, device=CPU, timings=timings)
    assert set(timings) == {"h2d", "kernel", "d2h", "labeling"}
    assert all(v >= 0 for v in timings.values())
    assert all(timings[k] >= once[k] for k in timings)   # summed per call
    if recording:
        # the phases are the spans' host seconds, and add up to the call
        root = tr.roots()[-1]
        kids = {k.name: k for k in tr.children(root)}
        got = {k: timings[k] - once[k] for k in timings}
        for key, name in (("h2d", "stage1.h2d"), ("kernel", "stage1.filter"),
                          ("d2h", "stage1.d2h")):
            assert got[key] == pytest.approx(kids[name].duration)
        assert got["labeling"] == pytest.approx(
            root.t_end - kids["stage1.index"].t_start)
        assert sum(got.values()) == pytest.approx(root.duration)


def test_hot_path_recording_exports_to_chrome_trace(tmp_path):
    frames, dark = _scan(n=2, size=32)
    obs, gvec, theta0 = _grid(points=8)
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        T.reduce_frames(frames, dark, device=CPU)
        T.fit_grid(obs, gvec, theta0, iters=2, device=CPU)
    path = telemetry.write_chrome_trace(tr, str(tmp_path / "hot.json"))
    trace = json.loads(open(path).read())
    assert telemetry.validate_chrome_trace(trace) == len(tr.spans) + 1
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"stage1.reduce_frames", "stage1.labels", "stage2.fit_grid",
            "stage2.gn_step", "stage2.solve"} <= names
