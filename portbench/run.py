"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs a CUDA card (and as many as the cell asks for): without one it exits
with 2 and prints no result. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared, with its limit); the checks are also the last lines of standard
error. Builds, caches and the trace of a ``--trace 1`` run stay inside
the checkout, under ``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the script's own directory gives way: its trace.py would shadow the
# standard library's
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench import harness
    cell = harness.find_cell(a.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"[portbench] {a.workload} needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    tracer = None
    if a.trace:
        from portbench.trace import Tracer
        tracer = Tracer(cell.traffic.get("trace_seconds"))
    trace_path = ROOT / "build" / "portbench" / f"{a.workload}.{a.seed}.json"
    result = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), device,
                              tracer=tracer, trace_path=trace_path)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"[portbench] loaded modules that no run may load: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"[portbench] check {name} {c['value']!r} limit {c['limit']!r} "
              f"{ok}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
