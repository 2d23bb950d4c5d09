"""Serving example: a request stream dispatched through the many-task engine
into the continuous-batching session — serving as "many-task over staged
node-local data" (weights + caches are the staged data; requests are tasks).

Counterpart of ``examples/serve_lm.py``: rwkv6-3b's smoke config (O(1)
state per slot) served on ``device``, 10 requests of 12 prompt tokens and
6 new tokens on 4 slots, then the many-task engine's makespan model on the
simulator's ``TPU_POD`` constants (simulated seconds).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.fabric import TPU_POD, Fabric
from repro_torch.core.manytask import ManyTaskEngine, Task
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.examples._say import Say
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeSession


def main(device: DeviceLike = "cuda", params: Optional[M.Model] = None,
         verbose: bool = True) -> Dict:
    """Serve the requests and return ``text``, ``finished`` (the requests
    in order of completion, their ``generated`` tokens), ``stats`` (the
    many-task engine's) and ``wall_s``. ``params`` (a model on
    ``device``) defaults to ``init_model`` from a generator seeded 0."""
    dev = resolve_device(device)
    say = Say(verbose)
    cfg = get_smoke_config("rwkv6_3b")     # O(1)-state decode arch
    if params is None:
        params = M.init_model(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    sess = ServeSession(params, cfg, batch_slots=4, capacity=64, device=dev)
    rng = np.random.default_rng(0)

    # requests arrive as many-task work items; the engine accounts queueing/
    # locality while the session does the real decode compute
    fabric = Fabric(n_hosts=1, ranks_per_host=4, constants=TPU_POD)
    n_requests = 10
    t0 = time.perf_counter()
    for rid in range(n_requests):
        sess.submit(Request(request_id=rid,
                            prompt=rng.integers(0, cfg.vocab, 12,
                                                dtype=np.int32),
                            max_new_tokens=6))
    finished = sess.run_to_completion()
    wall = time.perf_counter() - t0

    eng = ManyTaskEngine(fabric, n_workers=4)
    stats = eng.run([Task(task_id=r.request_id,
                          duration=len(r.generated) * 0.02)
                     for r in finished])
    tokens = sum(len(r.generated) for r in finished)
    say(f"served {len(finished)} requests / {tokens} tokens "
        f"in {wall:.2f}s wall ({tokens / wall:.1f} tok/s)")
    say(f"many-task makespan model: {stats.makespan:.2f}s on 4 workers")
    for r in finished[:3]:
        say(f"  req {r.request_id}: {r.generated}")
    return {"text": say.text, "finished": finished, "stats": stats,
            "wall_s": wall}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
