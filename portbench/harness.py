"""One run of one cell: discovery by name, set-up, the measured window, the
check against the reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix, loop or
metric is a file of its own, found by the name that ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the deployment (sizes, dtypes, guarantees);
- ``traffic/<traffic>.json``: the mix's parameters and the ``loop`` that
  drives it;
- ``loops/<loop>.py``: ``prepare``, ``warmup``, ``window`` and ``judge``;
- ``workloads/<cell>.json``: the cell's configuration and mix, as
  ``BENCHMARK.json`` has them, and the limit of each number it compares;
- ``metrics/<metric>.py``, else ``metrics/<part before the first
  dot>.py``: ``read(run)``, the metric's value or ``None``.

Adding a cell or a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def find_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py``, else ``<kind>/<name up to its first dot>.py``
    (so ``device_idle.refit`` is read by ``metrics/device_idle.py``),
    imported as ``portbench.<kind>.<stem>`` (a stem with dots by its
    path)."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / kind / f"{stem}.py"
        if not path.exists():
            continue
        if stem.isidentifier():
            return importlib.import_module(f"portbench.{kind}.{stem}")
        modname = f"portbench.{kind}.{stem}"
        if modname not in sys.modules:
            spec = importlib.util.spec_from_file_location(modname, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules[modname] = mod
        return sys.modules[modname]
    raise FileNotFoundError(f"no {kind}/{name}.py")


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files."""
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    chips: int
    metrics: List[Dict[str, Any]]      # end_to_end entries, then per_layer

    def loop(self) -> ModuleType:
        return find_module("loops", self.traffic["loop"])

    def reported(self, trace: bool) -> List[Dict[str, Any]]:
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.metrics if m["kind"] == kind]


def find_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``, which the
    tests extend with cells proven but not yet benchmarked) with its
    configuration, mix and limits."""
    if bench is None:
        bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{spec[key]!r}, BENCHMARK.json {entry[key]!r}")
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if name in m.get("workloads", [name]):
                metrics.append({**m, "kind": kind})
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic,
                limits=spec["limits"], chips=entry["chips"], metrics=metrics)


def process_age() -> float:
    """Seconds since this process started (``/proc``; the interpreter's
    start-up included)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    now = time.clock_gettime(time.CLOCK_BOOTTIME)
    return now - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Request:
    """One call into the program: when it was due, sent and answered."""
    name: str
    due: float
    sent: float
    done: float
    items: int
    meta: Dict[str, Any] = field(default_factory=dict)
    ok: bool = True


@dataclass
class Run:
    """What a measured window leaves for the metric readers."""
    cell: Cell
    seconds: float
    setup_s: float
    t0: float = 0.0                    # window start (perf_counter)
    t1: float = 0.0                    # the last answer of the window
    requests: List[Request] = field(default_factory=list)
    spans: List[tuple] = field(default_factory=list)   # (name, start, end)
    timings: Optional[Dict[str, float]] = None         # program phase clock
    trace: Any = None                  # trace.DeviceTrace or None
    lateness: List[float] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


class Session:
    """The measured window as the loops drive it: the program, the clock,
    the requests and their answers, and the tracer."""

    def __init__(self, run: Run, program: Any, tracer: Any = None):
        self.run, self.program, self.tracer = run, program, tracer
        self.answers: List[tuple] = []
        self.errors: List[str] = []
        self.t_end = math.inf

    def start(self) -> float:
        """Open the window (after the profiler has started, which takes
        seconds) and return its start."""
        if self.tracer is not None:
            self.tracer.start()
        t0 = time.perf_counter()
        self.run.setup_s = process_age()
        self.run.t0, self.t_end = t0, t0 + self.run.seconds
        return t0

    def over(self) -> bool:
        return time.perf_counter() >= self.t_end

    def wait_until(self, t: float) -> None:
        """Sleep until ``t``; the host's time waiting is a span."""
        now = time.perf_counter()
        if now < t:
            time.sleep(t - now)
            self.run.spans.append(("wait", now, time.perf_counter()))

    def request(self, name: str, fn: Callable[[], Any], items: int,
                key: Any, due: Optional[float] = None,
                meta: Optional[Dict[str, Any]] = None) -> None:
        """Send ``fn()`` now and keep its answer under ``key``."""
        sent = time.perf_counter()
        ok = True
        try:
            out = fn()
        except Exception:                   # a failed request is counted
            ok, out = False, None
            self.errors.append(traceback.format_exc())
        done = time.perf_counter()
        req = Request(name, sent if due is None else due, sent, done, items,
                      meta or {}, ok)
        self.run.requests.append(req)
        self.run.spans.append((name, sent, done))
        self.run.t1 = done
        if ok:
            self.answers.append((key, out))
        if self.tracer is not None:
            self.tracer.tick(done)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one that no run may load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def prepare(cell: Cell, seed: int, device: Any, program: Any,
            say: Callable[..., None] = print):
    """Set-up: the cell's inputs from ``seed`` and the warm-up of its
    shapes. Returns ``(loop, state)``."""
    loop = cell.loop()
    t_start = process_age()
    t = time.perf_counter()
    state = loop.prepare(cell.config, cell.traffic, seed, device)
    t_inputs = time.perf_counter() - t
    t = time.perf_counter()
    loop.warmup(state, program)
    say(f"[portbench] set-up: start to inputs {t_start!r} s, inputs "
        f"{t_inputs!r} s, warm-up {time.perf_counter() - t!r} s",
        file=sys.stderr)
    return loop, state


def measure(cell: Cell, loop: ModuleType, state: Any, program: Any,
            seconds: float, trace: bool, device: Any, tracer: Any = None):
    """The measured window. Returns ``(run, session, device peak bytes)``;
    the peak is the window's own."""
    import torch
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(cell=cell, seconds=seconds, setup_s=0.0,
              timings={} if trace else None)
    sess = Session(run, program, tracer if trace else None)
    loop.window(sess, state)
    peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    if sess.tracer is not None:
        run.trace = sess.tracer.finish()
    return run, sess, peak


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: Any, program: Any = None, tracer: Any = None,
             trace_path: Optional[Path] = None,
             say: Callable[..., None] = print) -> Dict[str, Any]:
    """Run ``cell`` once on ``device`` and return the result line's object.

    ``program`` is the system under test (``program.Program`` by default);
    the check and the tests put the control or a broken program in its
    place. ``tracer`` records the device trace of a ``trace`` run, which
    is saved to ``trace_path`` when one is given."""
    import torch
    if program is None:
        from portbench.program import Program
        program = Program(device)
    loop, state = prepare(cell, seed, device, program, say)
    run, sess, peak = measure(cell, loop, state, program, seconds, trace,
                              device, tracer)
    if run.trace is not None and trace_path is not None:
        run.trace.save(trace_path, run.spans)
    for err in sess.errors[:1]:
        say(f"[portbench] a request failed:\n{err}", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.judge(state, sess.answers, run.requests, device)
    del state
    checks = {}
    for name, value in numbers.items():
        if name not in cell.limits:
            raise KeyError(f"no limit for {name!r} in workloads/"
                           f"{cell.name}.json")
        if not math.isfinite(value):        # keep the line strict JSON
            value = sys.float_info.max
        checks[name] = {"value": value, "limit": cell.limits[name]}
    failed = sum(not r.ok for r in run.requests)
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in cell.reported(trace):
        value = find_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.requests),
              "failed": failed, "metrics": metrics,
              "device": device_info(device, peak)}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown(run.spans)
    result["checks"] = checks
    if run.lateness:
        say(f"[portbench] generator lateness: max "
            f"{max(run.lateness) * 1e3!r} ms, mean "
            f"{sum(run.lateness) / len(run.lateness) * 1e3!r} ms over "
            f"{len(run.lateness)} sends", file=sys.stderr)
    return result


def device_info(device: Any, peak: int) -> Dict[str, Any]:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}
