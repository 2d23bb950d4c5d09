"""Interactive multi-session NF-HEDM over the dataset catalog and staging
service, on the port.

Step for step the counterpart of ``examples/hedm_service.py``: the paper's
interactive regime, where data lives in node memory for extended periods
while several analysis tasks reach it. Four concurrent sessions lease three
scans through the long-lived staging service under a node-memory budget
that fits only two scans at once, so concurrent requests coalesce into
shared collective stages, unleased datasets evict (cheapest to re-stage
first) and re-stage on the next miss, admissions queue on lease releases,
and each session's reduced results are written back to the shared FS with
the collective ``stage_out``. A late session then leases a scan through
the unified client inside a session scope, which releases it on exit.

Stage 1 runs through the ``hedm_reduce`` kernel on a card (its plain
version on the CPU), and every session's output must equal, byte for
byte, a direct reduction of its scan. The defaults are the example's: 3
scans of 16 frames of 128x128 (6 spots a frame) on 64 hosts, a budget of
2 scans plus 1 KB. On a card the scans are rendered there
(``simulate_detector_frames(device=...)``); on the CPU they are the numpy
scans, the reference's own. Staging, leases and turnarounds are the numpy
simulator, in simulated seconds.

    PYTHONPATH=src python -m repro_torch.hedm.service [--frames N --size W]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core.api import StagingClient
from repro_torch.core.fabric import BGQ, Fabric
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hedm.pipeline import (SessionScript, pack_reduced,
                                       reduce_frames, run_interactive_hedm,
                                       simulate_detector_frames)

SCANS = ("scanA", "scanB", "scanC")
N_HOSTS, N_SPOTS = 64, 6


def sessions():
    """The example's four tenants: which scans each reduces, in order, and
    when it starts (simulated s)."""
    return [SessionScript("ana", ["scanA", "scanB", "scanC"]),
            SessionScript("ben", ["scanA", "scanC", "scanB"]),
            SessionScript("cam", ["scanB", "scanA", "scanC"], t_start=0.5),
            SessionScript("dee", ["scanC", "scanB", "scanA"], t_start=1.0)]


def main(device: DeviceLike = "cuda", n_frames: int = 16,
         frame_size: int = 128, verbose: bool = True) -> Dict:
    """Run the sessions on ``device`` and return: ``outputs`` (session ->
    scan -> packed result), ``turnaround_s`` and ``session_done``
    (simulated), ``stats`` (the service's ``ServiceStats``), ``late``
    (the late session's lease: ``t_late``, ``t_ready``, ``hit`` and the
    lease count after its scope), ``n_outputs`` and ``wall``: host seconds
    of ``generation``, ``sessions`` and ``direct``, each ending with the
    device done. Raises if any output differs from direct reduction."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    wall: Dict[str, float] = {}

    def sync() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync()
    scans, dark = {}, None
    for i, name in enumerate(SCANS):
        scans[name], dark = simulate_detector_frames(
            n_frames, size=frame_size, n_spots=N_SPOTS, seed=i,
            device=dev if dev.type == "cuda" else None)
    wall["generation"] = sync() - t0
    frame_bytes = frame_size * frame_size * 4
    budget = 2 * n_frames * frame_bytes + 1024      # 2 of the 3 scans fit

    fab = Fabric(n_hosts=N_HOSTS, constants=BGQ)
    scripts = sessions()
    say(f"=== Interactive HEDM: dataset catalog + staging service on "
        f"{dev} ===")
    say(f"{len(scans)} scans x {n_frames} frames "
        f"({n_frames * frame_bytes >> 20} MB each), budget "
        f"{budget >> 20} MB/node, {len(scripts)} sessions\n")

    t0 = sync()
    res = run_interactive_hedm(fab, scans, dark, scripts, budget,
                               use_kernel=True, device=dev)
    wall["sessions"] = sync() - t0
    svc, st = res.service, res.service.stats

    say("catalog lifecycle:")
    for entry in svc.catalog:
        trail = " -> ".join(f"{s.value}@{t:.2f}s" for t, s in entry.history)
        say(f"  {entry.name}: {trail}")
        say(f"    residencies={entry.stage_count} acquires={entry.acquires}"
            f" (coalesced={entry.coalesced}, hits={entry.hits})")
    say(f"\nservice: {st.stages} stages ({st.restages} transparent "
        f"re-stages), {st.coalesced} coalesced acquires, {st.evictions} "
        f"evictions, {st.queue_waits} queued admissions "
        f"({st.queue_wait_time:.2f}s waiting on leases)")
    say("\nwrite-back (collective stage_out):")
    for name, rep in sorted(res.writeback.items()):
        say(f"  {name}: {rep.fs_write_bytes >> 10} KB in "
            f"{rep.total_time * 1e3:.1f} ms "
            f"(done at {res.session_done[name]:.2f}s)")

    # a late tenant through the unified client: its session scope releases
    # its leases on exit, even under an exception
    client = StagingClient(fab, service=svc)
    t_late = res.turnaround + 1.0
    with client.session("emma") as emma:
        lease = emma.acquire("scanA", t_late)
    late = {"t_late": t_late, "t_ready": lease.t_ready,
            "hit": lease.t_ready == t_late,
            "lease_count": svc.catalog["scanA"].lease_count}
    say(f"\nlate session 'emma': scanA leased at t={t_late:.2f}s "
        f"({'residency hit' if late['hit'] else 're-stage'}, ready "
        f"{lease.t_ready:.2f}s) — no explicit release")
    say(f"  after scope exit: scanA lease count {late['lease_count']} "
        f"(auto-released)")

    # every session's outputs equal direct reduction, eviction and
    # re-staging notwithstanding
    t0 = sync()
    for name, frames in scans.items():
        ref = pack_reduced(reduce_frames(np.float32(frames), dark,
                                         use_kernel=True, device=dev))
        for session, outs in res.outputs.items():
            if outs[name].tobytes() != ref.tobytes():
                raise AssertionError(f"session {session}'s {name} differs "
                                     f"from direct reduction")
    wall["direct"] = sync() - t0
    n_out = sum(len(o) for o in res.outputs.values())
    say(f"\n==> turnaround {res.turnaround:.2f}s; all {n_out} session "
        f"outputs byte-exact vs direct reduction: True")
    return {"outputs": res.outputs, "turnaround_s": res.turnaround,
            "session_done": res.session_done, "stats": st, "late": late,
            "n_outputs": n_out, "wall": wall}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=16,
                    help="frames a scan")
    ap.add_argument("--size", type=int, default=128)
    a = ap.parse_args()
    main(device=a.device, n_frames=a.frames, frame_size=a.size)


if __name__ == "__main__":
    _cli()
