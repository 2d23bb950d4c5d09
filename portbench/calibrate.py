"""Readings for the limits of ``correct``: the numbers a cell compares, over
many seeds in one process, from the program or from the control.

    python3 portbench/calibrate.py --workload nf-f32.refit --seconds 30 \\
        --seeds 11 12 13 [--control]

Each seed is one whole run of the cell (set-up, the window at the cell's
own load, the check), and prints one JSON line: the seed, whether the
control stood in for the program, and each number compared. The lower
reading of a number is the largest the program gives over a dozen seeds or
more; the upper, the smallest the control gives (``control.py``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the script's own directory gives way: its trace.py would shadow the
# standard library's
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("[portbench] no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(a.workload)
    if a.control:
        from portbench.control import Control
        program = Control(device, cell.config)
    else:
        from portbench.program import Program
        program = Program(device)
    for seed in a.seeds:
        res = harness.run_cell(cell, seed, a.seconds, False, device,
                               program=program)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": a.control, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "numbers": {k: v["value"] for k, v in
                                      res["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
