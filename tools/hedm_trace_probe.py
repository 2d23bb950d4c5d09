"""Probe of the NF-HEDM hot path's recording on a CUDA card.

    PYTHONPATH=src python3 tools/hedm_trace_probe.py --out probe.json \
        [--seed 7] [--seconds 10] [--calls 240] [--fits 40] [--cost-only]

Part 1 runs the benchmark cells ``nf-u16.frame1`` and ``nf-f32.refit`` as a
``--trace 1`` run does (portbench's set-up, measured window and device
profiler), with ``repro_torch.core.telemetry.recording`` current around
each call of the program. From the program's spans and the device trace it
reports:

* the seconds of each span name, and each stage-1 child's share of
  ``stage1.reduce_frames`` (on the card ``label`` and ``unpack``, on the
  host ``index``, ``labels`` and ``centroids``);
* each idle gap of the card named by the innermost span covering its
  midpoint: a program span, else the harness's request or ``wait``, else
  ``harness``;
* the clock check: every ``hedm_reduce`` kernel starts after its call's
  ``stage1.filter`` span opens, every copy to the host lies inside a
  ``stage1.d2h`` and every copy to the card inside ``stage1.h2d`` (the
  smallest margins, in us; a negative margin is a misalignment, except at
  the end of a copy to the card: the span ends when the staging ring has
  queued its last chunk, whose DMA lands after it);
* the CUDA runtime calls (``cudaStreamSynchronize``, ...) by the program
  span they start in: where the host waits for the card.

Part 2 (alone with ``--cost-only``) times calls on the cells' own inputs
with recording off and on, in rounds of one call a variant on the same
input, the order rotated a round: ``--calls`` rounds of ``reduce_frames``
(one frame a call, the layer's frames in turn) off, on, and on with the
CUDA events stubbed out; ``--fits`` rounds of ``fit_grid`` (its answer
copied to the host, as the benchmark's loop does, the grids in turn) off
and on. The recording tracer is one for all the calls, as in a traced
window.

Needs a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness                           # noqa: E402
from portbench.program import Program                   # noqa: E402
from portbench.trace import Tracer as DeviceTracer, union  # noqa: E402
from repro_torch.core import telemetry                  # noqa: E402


class Recording(Program):
    """The benchmark's program with ``tracer`` current around each call."""

    def __init__(self, device, tracer):
        super().__init__(device)
        self.tracer = tracer

    def reduce_frames(self, *args, **kwargs):
        with telemetry.recording(self.tracer):
            return super().reduce_frames(*args, **kwargs)

    def fit_grid(self, *args, **kwargs):
        with telemetry.recording(self.tracer):
            return super().fit_grid(*args, **kwargs)


class SpanIndex:
    """The innermost program span covering a time: roots do not overlap
    (the loops are closed) and nor do a span's children, so a bisection
    a level finds it."""

    def __init__(self, program):
        kids = {}
        for s in program.spans:
            kids.setdefault(s.parent, []).append(s)
        self.kids = {k: sorted(v, key=lambda s: s.t_start)
                     for k, v in kids.items()}
        self.starts = {k: [s.t_start for s in v]
                       for k, v in self.kids.items()}

    def find(self, t):
        best, level = None, None
        while True:
            spans = self.kids.get(level)
            if not spans:
                return best
            i = bisect.bisect_right(self.starts[level], t) - 1
            if i < 0 or spans[i].t_end < t:
                return best
            best = spans[i]
            level = best.span_id


def harness_span(t, spans, starts):
    """The harness span (request or ``wait``; they do not overlap)
    covering ``t``, else None."""
    i = bisect.bisect_right(starts, t) - 1
    return spans[i] if i >= 0 and spans[i][2] >= t else None


def gaps(trace):
    out, edge = [], trace.t0
    for a, b in union(trace.intervals()) + [[trace.t1, trace.t1]]:
        if a > edge:
            out.append((edge, min(a, trace.t1)))
        edge = max(edge, b)
    return out


def idle_by_span(trace, index, harness_spans):
    """Idle seconds by the innermost span covering each gap's midpoint."""
    hs = sorted(harness_spans, key=lambda s: s[1])
    hstarts = [s[1] for s in hs]
    named, total, in_req, in_req_prog = {}, 0.0, 0.0, 0.0
    for a, b in gaps(trace):
        mid, dur = (a + b) / 2, b - a
        total += dur
        hit = index.find(mid)
        req = harness_span(mid, hs, hstarts)
        name = hit.name if hit else req[0] if req else "harness"
        named[name] = named.get(name, 0.0) + dur
        if req is not None and req[0] != "wait":
            in_req += dur
            in_req_prog += dur if hit else 0.0
    prog_s = sum(v for k, v in named.items()
                 if k.startswith(("stage1.", "stage2.")))
    return {"idle_s": total, "window_s": trace.window_s,
            "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1]),
            "program_named_share": prog_s / total if total else None,
            "in_request_idle_s": in_req,
            "in_request_program_share":
                in_req_prog / in_req if in_req else None}


def span_seconds(program, t0, t1):
    out = {}
    for s in program.spans:
        if t0 <= s.t_start and s.t_end <= t1:
            out[s.name] = out.get(s.name, 0.0) + s.duration
    return out


def clock_check(trace, program):
    """Margins (us) of the device's K1 and copies against stage 1's
    spans, over the calls wholly inside the traced window."""
    ops = sorted(trace.ops, key=lambda op: op[2])
    k1, dtoh, htod = [], [], []
    for root in program.roots():
        if root.name != "stage1.reduce_frames" or not (
                trace.t0 <= root.t_start and root.t_end <= trace.t1):
            continue
        kids = {k.name: k for k in program.children(root)}
        d2hs = [k for k in program.children(root) if k.name == "stage1.d2h"]
        mine = [op for op in ops if root.t_start <= op[2] <= root.t_end]
        for name, kind, a, b in mine:
            if kind == "kernel" and "hedm_reduce" in name:
                k1.append((a - kids["stage1.filter"].t_start) * 1e6)
            elif kind == "memcpy" and "DtoH" in name:
                # on the card path a call copies twice, each in its own
                # span: the one opened last before the copy began
                d2h = max((k for k in d2hs if k.t_start <= a),
                          key=lambda k: k.t_start, default=d2hs[0])
                dtoh.append(((a - d2h.t_start) * 1e6,
                             (d2h.t_end - b) * 1e6))
            elif kind == "memcpy" and "HtoD" in name:
                h2d = kids["stage1.h2d"]
                htod.append(((a - h2d.t_start) * 1e6,
                             (h2d.t_end - b) * 1e6))

    def margins(pairs):
        return {"n": len(pairs),
                "min_start_margin_us": min((p[0] for p in pairs),
                                           default=None),
                "min_end_margin_us": min((p[1] for p in pairs),
                                         default=None)}
    return {"k1": {"n": len(k1),
                   "start_minus_filter_open_us_min": min(k1, default=None),
                   "start_minus_filter_open_us_median":
                       statistics.median(k1) if k1 else None},
            "dtoh_in_d2h": margins(dtoh), "htod_in_h2d": margins(htod)}


def runtime_calls(dev_tracer, index):
    """The CUDA runtime calls the profiler saw, by the innermost program
    span they start in: ``{"span|call": [count, seconds]}``."""
    from torch.autograd import DeviceType
    out = {}
    off = dev_tracer.offset_ns
    for e in dev_tracer.events:
        if e.device_type() == DeviceType.CUDA or \
                not e.name().startswith("cuda"):
            continue
        t = (e.start_ns() - off) * 1e-9
        hit = index.find(t)
        key = f"{hit.name if hit else None}|{e.name()}"
        n, sec = out.get(key, [0, 0.0])
        out[key] = [n + 1, sec + e.duration_ns() * 1e-9]
    return out


def traced_cell(name, seed, seconds, device):
    cell = harness.find_cell(name)
    program_tr = telemetry.Tracer()
    program = Recording(device, program_tr)
    loop, state = harness.prepare(cell, seed, device, program,
                                  say=lambda *a, **k: None)
    dev_tr = DeviceTracer(cell.traffic.get("trace_seconds"))
    run, sess, _ = harness.measure(cell, loop, state, program, seconds,
                                   True, device, dev_tr)
    numbers = loop.judge(state, sess.answers, run.requests, device)
    trace = run.trace
    spans = span_seconds(program_tr, trace.t0, trace.t1)
    index = SpanIndex(program_tr)
    out = {"requests": len(run.requests), "errors": len(sess.errors),
           "checks": numbers, "span_s": spans,
           "counters": program_tr.metrics.snapshot()["counters"],
           "breakdown": idle_by_span(trace, index, run.spans),
           "runtime_calls": runtime_calls(dev_tr, index)}
    if name.endswith("frame1"):
        root = spans["stage1.reduce_frames"]
        # the card path records label and unpack, the host path index,
        # labels and centroids
        for part in ("index", "labels", "centroids", "label", "unpack",
                     "h2d", "filter", "d2h"):
            if f"stage1.{part}" in spans:
                out[f"{part}_share"] = 100 * spans[f"stage1.{part}"] / root
        c = out["counters"]
        out["h2d_bytes_per_frame_MiB"] = (c["stage1.h2d_bytes"]
                                          / c["stage1.frames"] / 2 ** 20)
        out["clock"] = clock_check(trace, program_tr)
        out["device_s"] = {
            k: sum(s.attrs["device_s"] for s in program_tr.spans
                   if s.name == k and trace.t0 <= s.t_start <= trace.t1)
            for k in ("stage1.h2d", "stage1.filter", "stage1.label",
                      "stage1.d2h")}
    else:
        root = spans["stage2.fit_grid"]
        for part in ("jacobian", "solve", "residual"):
            out[f"{part}_share"] = 100 * spans[f"stage2.{part}"] / root
    return out, state


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [q[0], q[1], q[2]]


class _NoEvent:
    """Stands in for a CUDA event: recording without the events' cost."""

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.0


def alternating(call, n, variants):
    """Per-call seconds of ``call(i)`` under each of ``variants`` (``off``,
    ``on``: recording current; ``on_no_events``: the same with
    ``pipeline._event`` stubbed), ``n`` rounds of one call a variant on
    the same input, the order rotated a round."""
    from repro_torch.hedm import pipeline
    tr = telemetry.Tracer()
    real_event = pipeline._event
    secs = {v: [] for v in variants}
    for i in range(n):
        k = i % len(variants)
        for v in variants[k:] + variants[:k]:
            if v == "on_no_events":
                pipeline._event = lambda dev: _NoEvent()
            t = time.perf_counter()
            if v == "off":
                call(i)
            else:
                with telemetry.recording(tr):
                    call(i)
            secs[v].append(time.perf_counter() - t)
            pipeline._event = real_event
    out = {"rounds": n, "spans_recorded": len(tr.spans)}
    base = secs["off"]
    for v, xs in secs.items():
        out[f"{v}_ms_quartiles"] = [x * 1e3 for x in quartiles(xs)]
        if v == "off":
            continue
        out[f"{v}_median_delta_us"] = (statistics.median(xs)
                                       - statistics.median(base)) * 1e6
        out[f"{v}_median_delta_pct"] = 100 * (statistics.median(xs)
                                              / statistics.median(base) - 1)
        out[f"{v}_paired_delta_us_quartiles"] = [
            x * 1e6 for x in quartiles([b - a for a, b in zip(base, xs)])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--calls", type=int, default=240)
    ap.add_argument("--fits", type=int, default=40)
    ap.add_argument("--cost-only", action="store_true",
                    help="skip part 1's traced windows")
    a = ap.parse_args(argv)
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    t_start = time.perf_counter()
    result = {"card": card, "seed": a.seed}
    program = Program(device)
    if a.cost_only:
        layer, grids = (harness.prepare(harness.find_cell(name), seed,
                                        device, program,
                                        say=lambda *a, **k: None)[1]
                        for name, seed in (("nf-u16.frame1", a.seed),
                                           ("nf-f32.refit", a.seed + 1)))
    else:
        frame1, layer = traced_cell("nf-u16.frame1", a.seed, a.seconds,
                                    device)
        refit, grids = traced_cell("nf-f32.refit", a.seed + 1, a.seconds,
                                   device)
        result["nf-u16.frame1"], result["nf-f32.refit"] = frame1, refit
    F = layer.frames.shape[0]
    result["cost"] = {
        "reduce_frames": alternating(
            lambda i: program.reduce_frames(
                layer.frames[i % F:i % F + 1], layer.dark,
                layer.threshold),
            a.calls, ["off", "on", "on_no_events"]),
        "fit_grid": alternating(
            lambda i: program.fit_grid(
                grids.y[i % len(grids.y)], grids.gvec, grids.theta0,
                grids.iters).cpu(),
            a.fits, ["off", "on"])}
    result["seconds"] = time.perf_counter() - t_start
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
