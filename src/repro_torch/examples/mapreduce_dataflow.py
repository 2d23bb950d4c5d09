"""The paper's Fig. 4 MapReduce-in-Swift example on the dataflow engine —
including the no-barrier property (Fig. 5): merges start while maps run.

Counterpart of ``examples/mapreduce_dataflow.py`` on the port's copy of
the dataflow engine (``repro_torch.core.dataflow``), in simulated seconds;
nothing here runs on a device.

    PYTHONPATH=src python -m repro_torch.examples.mapreduce_dataflow \
        --device cpu
"""
from __future__ import annotations

import argparse
import random
from typing import Dict

from repro_torch.core.dataflow import Dataflow
from repro_torch.core.fabric import Fabric
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.examples._say import Say


def main(device: DeviceLike = "cuda", verbose: bool = True) -> Dict:
    """Map 32 files, merge them pairwise on 8 workers, and return ``text``,
    ``count`` (the merged result), ``stats`` (the engine's) and
    ``first_merge``/``last_map`` (simulated seconds)."""
    resolve_device(device)
    say = Say(verbose)
    fabric = Fabric(n_hosts=8, ranks_per_host=4)
    df = Dataflow(fabric)
    r = random.Random(0)

    N = 32
    # map phase: find_file(i) |> map_function  (paper lines 6-8)
    maps = df.foreach(lambda i: {"file": f"part{i}", "count": i * i},
                      list(range(N)),
                      durations=[r.uniform(0.5, 4.0) for _ in range(N)])

    # reduce phase: recursive pairwise merge (paper lines 13-23)
    def merge_pair(a, b):
        return {"file": "merged", "count": a["count"] + b["count"]}

    final = df.merge_pairwise(merge_pair, maps, duration=0.2)
    stats = df.run(n_workers=8)

    say(f"final.data -> count={final.result()['count']} "
        f"(expected {sum(i * i for i in range(N))})")
    say(f"makespan {stats.makespan:.2f}s on 8 workers "
        f"(sum of work {stats.cpu_seconds():.2f}s)")
    events = {e.task_id: e for e in stats.events}
    first_merge = min(e.start for tid, e in events.items() if tid >= N)
    last_map = max(e.end for tid, e in events.items() if tid < N)
    say(f"no barrier: first merge at t={first_merge:.2f}s, "
        f"last map finishes t={last_map:.2f}s")
    return {"text": say.text, "count": final.result()["count"],
            "stats": stats, "first_merge": first_merge, "last_map": last_map}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
