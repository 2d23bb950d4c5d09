"""The cells the benchmark's own tests run besides ``BENCHMARK.json``'s."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bench_with_stage1():
    """``BENCHMARK.json`` with the cell ``nf-f32.stage1`` and its metrics
    (``stage1_entries.json``) added: proven correct on the card, left out
    of the benchmark for the spread of its rate (PERF.md)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((Path(__file__).parent /
                        "stage1_entries.json").read_text())
    for key, entries in extra.items():
        known = {e["name"]: e for e in bench[key]}
        for entry in entries:
            if entry["name"] in known:          # one more cell reports it
                known[entry["name"]]["workloads"] += entry["workloads"]
            else:
                bench[key].append(entry)
    return bench
