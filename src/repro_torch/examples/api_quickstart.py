"""Unified staging client API in five minutes.

Counterpart of ``examples/api_quickstart.py``: the same numpy simulator
(``repro_torch.core``, a copy of the reference's), the same fabric and
the same printed lines. One surface for every way data reaches
compute-node memory:

  1. typed engine configs (validated — no stringly-typed stage_kw dicts),
  2. the pluggable engine registry (mode name -> config type -> engine),
  3. ``client.stage(spec_or_patterns, config)`` for any one-shot engine,
  4. a declarative spec that round-trips its engine config through JSON
     (the Fig. 6 env-var hook, now fully typed),
  5. catalog-backed acquisition with ``with client.session(...)`` scopes
     whose leases auto-release — even when the body raises.

Nothing here runs on a device; ``device`` is resolved as every entry
point resolves it.

    PYTHONPATH=src python -m repro_torch.examples.api_quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from repro_torch.core.api import (ENGINES, BroadcastEntry, CollectiveConfig,
                                  PipelinedConfig, ServiceConfig,
                                  StagingClient, StagingSpec, StreamConfig)
from repro_torch.core.fabric import BGQ, Fabric
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.examples._say import Say


def make_fabric(n_hosts=32):
    fab = Fabric(n_hosts=n_hosts, constants=BGQ)
    rng = np.random.default_rng(0)
    for i in range(6):
        fab.fs.put(f"scan/frame_{i:03d}.bin",
                   rng.integers(0, 255, 1 << 16, dtype=np.uint8))
    return fab


def main(device: DeviceLike = "cuda", verbose: bool = True) -> Dict:
    """Run the tour and return ``text`` (what it printed) and ``reports``:
    the collective, pipelined, stream and service-session ``Report``s."""
    resolve_device(device)
    say = Say(verbose)
    say("=== Unified staging client API ===\n")

    # (1) the registry: every engine, its typed config, one table
    say("registered engines (config -> engine matrix):")
    for e in ENGINES.entries():
        kind = "one-shot batch" if e.batch else "streamed delivery"
        say(f"  {e.name:<11} {e.config_type.__name__:<17} "
            f"{e.stage_fn.__module__.split('.')[-1]}.{e.stage_fn.__name__}"
            f"  ({kind})")

    # (2) one-shot staging through the client, engine picked by config
    fab = make_fabric()
    client = StagingClient(fab)
    rep = client.stage("scan/*.bin", CollectiveConfig())
    say(f"\n(collective) staged {len(rep.resolved_files)} files "
        f"({rep.total_bytes >> 10} KB) to {rep.n_hosts} nodes in "
        f"{rep.total_time:.3f}s simulated — fs_bytes {rep.fs_bytes >> 10} "
        f"KB (1x), delivered {rep.delivered_bytes >> 20} MB")

    rep_p = StagingClient(make_fabric()).stage(
        "scan/*.bin", PipelinedConfig(chunk_bytes=1 << 14))
    say(f"(pipelined)  same dataset in {rep_p.total_time:.3f}s "
        f"({rep_p.reports[0].n_chunks} chunks, "
        f"{rep_p.reports[0].overlap_saved * 1e3:.2f} ms hidden)")

    rep_s = StagingClient(make_fabric()).stage(
        "scan/*.bin", StreamConfig(rate_hz=50.0))
    say(f"(stream)     detector-push in {rep_s.total_time:.3f}s — "
        f"fs_bytes {rep_s.fs_bytes} (never read back)")

    # typed configs fail loudly instead of silently ignoring a typo
    try:
        StreamConfig(rate_hz=-1.0)
    except ValueError as e:
        say(f"(validation) StreamConfig(rate_hz=-1.0) -> ValueError: {e}")

    # (3) the declarative spec carries its engine config through JSON
    spec = StagingSpec([BroadcastEntry(files=("scan/*.bin",))],
                       config=PipelinedConfig(chunk_bytes=1 << 14))
    wire = spec.to_json()
    spec2 = StagingSpec.from_json(wire)
    if spec2 != spec:
        raise AssertionError("the spec did not survive its JSON round trip")
    say(f"\nspec JSON round-trip (engine included): {wire[:74]}...")

    # (4) catalog-backed acquisition with session scopes
    fab = make_fabric()
    client = StagingClient(fab, service=ServiceConfig(budget_bytes=1 << 22))
    with client.session("alice") as alice:
        arep = alice.stage("scan/*.bin")
        say(f"\n(service) alice leased "
            f"{arep.leases[0].dataset!r} (ready at "
            f"{arep.leases[0].t_ready:.3f}s); coalesces with concurrent "
            f"tenants, auto-releases on scope exit")
    name = arep.leases[0].dataset
    if client.service.catalog[name].lease_count != 0:
        raise AssertionError("the session scope leaked its lease")
    say(f"          lease count after scope: "
        f"{client.service.catalog[name].lease_count} (no wedge footgun)")

    # even an exception cannot leak the lease
    try:
        with client.session("bob") as bob:
            bob.stage("scan/*.bin")
            raise RuntimeError("analysis crashed")
    except RuntimeError:
        pass
    if client.service.catalog[name].lease_count != 0:
        raise AssertionError("a crashed session leaked its lease")
    say("          crashed session released its leases too")

    # staged replicas are byte-exact on every node, whatever the path
    for host in fab.hosts:
        for i in range(6):
            p = f"scan/frame_{i:03d}.bin"
            if not np.array_equal(host.store.data[p], fab.fs.files[p]):
                raise AssertionError(f"host {host.host_id}: {p} differs")
    say("\n==> all replicas byte-exact on every node-local store")
    return {"text": say.text, "reports": {
        "collective": rep, "pipelined": rep_p, "stream": rep_s,
        "service": arep}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
