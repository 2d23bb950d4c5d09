"""Find the highest rate an open-loop cell sustains, on the card.

    python3 portbench/sweep.py --workload nf-u16.live --seed 7 \\
        --seconds 20 --rates 6 8 10 12

One set-up; then, for each rate, one window of the cell's open loop at
that rate (the mix's ``rate_hz`` replaced), printing one JSON line: the
frames due, the median, 95th percentile and largest latency, the latency
of the window's last tenth of frames against its first tenth (a backlog
that grows shows as a ratio well over 1), and the generator's lateness.
A rate is sustained when the backlog does not grow. The cell's mix then
takes four fifths of the highest rate sustained. Nothing is judged here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the script's own directory gives way: its trace.py would shadow the
# standard library's
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.program import Program
    if not torch.cuda.is_available():
        print("[portbench] no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(a.workload)
    program = Program(device)
    loop, state = harness.prepare(cell, a.seed, device, program)
    for rate in a.rates:
        c = dataclasses.replace(cell, traffic={**cell.traffic,
                                               "rate_hz": rate})
        run, _, _ = harness.measure(c, loop, state, program, a.seconds,
                                    False, device)
        lat = [(r.done - r.due) * 1e3 for r in run.requests]
        svc = [(r.done - r.sent) * 1e3 for r in run.requests]
        tenth = max(1, len(lat) // 10)
        p95 = sorted(lat)[max(0, math.ceil(0.95 * len(lat)) - 1)]
        print(json.dumps({
            "rate_hz": rate, "frames": len(lat),
            "service_ms_median": statistics.median(svc),
            "latency_ms_median": statistics.median(lat),
            "latency_ms_p95": p95,
            "latency_ms_max": max(lat),
            "backlog_growth": (statistics.mean(lat[-tenth:])
                               / statistics.mean(lat[:tenth])),
            "lateness_ms_max": max(run.lateness) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
