"""Sharded checkpointing of torch (or numpy) trees, and the dataset-catalog
snapshot.

Counterpart of ``repro.checkpoint.store``, on the same on-disk format, so
that the two stores read each other's checkpoints: one directory
``step_<8 digits>`` a step holding ``meta.json`` (step, shard count and,
per leaf path, its shape, dtype and shard axis) and one ``.npy`` object per
leaf, or per shard of a leaf along its largest axis; ``LATEST`` names the
newest step. bfloat16 leaves are saved as a uint16 view under the dtype
``"bfloat16"``.

Trees are dicts, NamedTuples, tuples and lists (their items keyed by index)
and ``nn.Module``s (their parameters keyed by dotted name); leaves are
torch tensors or numpy arrays. The reference keys a tuple as one leaf,
which its ``restore`` cannot load back; here a tuple's items are leaves
of their own. ``save_async`` snapshots every leaf to host memory before
its writer thread starts; ``restore`` puts each leaf back on its template
leaf's device in that leaf's dtype, and writes a module's parameters in
place. ``restore_resharded`` restores on the host as ``restore`` does, then
lays each leaf onto a ``torch.distributed`` ``DeviceMesh`` as a ``DTensor``
with the placements of its spec (elastic restore onto another mesh or
participant count).

Beyond model state, the store also snapshots the DATASET CATALOG of a
`repro_torch.core.datasvc.StagingService` (:meth:`CheckpointStore.save_catalog`
/ :meth:`CheckpointStore.restore_catalog`), copied from the reference as
it is: a simulated service restart rebuilds the service against the
(surviving) fabric, re-verifies every entry's replica coverage against what
the node-local stores actually hold, re-pins live leases, and marks entries
whose replicas went missing DEGRADED so the self-healing path
(`StagingService.re_replicate`) brings them back.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import distribute_params


class CheckpointError(RuntimeError):
    """A checkpoint object is missing or unreadable — the error names the
    offending shard/file so operators can see WHICH object to recover
    from replication instead of guessing from a bare traceback."""


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], _join(prefix, k)))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), _join(prefix, k)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, _join(prefix, str(i))))
    else:
        out[prefix] = tree
    return out


def _leaf_like(template: Any, arr: np.ndarray, marker: str) -> Any:
    """The restored array as a tensor on ``template``'s device in its dtype
    (a CPU tensor in the saved dtype when the template is no tensor)."""
    if marker == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(template, torch.Tensor):
        return t.to(device=template.device, dtype=template.dtype)
    return t


def _unflatten_like(template: Any, flat: Dict[str, Tuple[np.ndarray, str]],
                    prefix: str = ""):
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for k, p in template.named_parameters():
                p.copy_(_leaf_like(p, *flat[_join(prefix, k)]))
        return template
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], flat, _join(prefix, k))
                for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten_like(getattr(template, k), flat, _join(prefix, k))
            for k in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten_like(v, flat, _join(prefix, str(i)))
                              for i, v in enumerate(template))
    return _leaf_like(template, *flat[prefix])


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory as numpy, and its dtype marker:
    bf16 (no numpy dtype) as a uint16 view marked ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), ""
    arr = np.array(leaf)
    return arr, ""


class CheckpointStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _leaf_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    @staticmethod
    def _shard_axis(shape: Tuple[int, ...]) -> int:
        if not shape:
            return -1
        return int(np.argmax(shape))

    def save(self, step: int, tree: Any, n_shards: int = 8) -> None:
        """Sharded synchronous save (each shard = independent object)."""
        self._write(step, {p: _host(leaf)
                           for p, leaf in _flatten(tree).items()}, n_shards)

    def _write(self, step: int, flat: Dict[str, Tuple[np.ndarray, str]],
               n_shards: int) -> None:
        d = self._leaf_dir(step)
        os.makedirs(d, exist_ok=True)
        meta = {"step": step, "n_shards": n_shards, "leaves": {}}
        for path, (arr, marker) in flat.items():
            ax = self._shard_axis(arr.shape)
            meta["leaves"][path] = {
                "shape": list(arr.shape),
                "dtype": marker or str(arr.dtype),
                "shard_axis": ax,
            }
            safe = path.replace("/", "__")
            if ax < 0 or arr.shape[ax] < n_shards:
                np.save(os.path.join(d, f"{safe}.full.npy"), arr)
            else:
                for i, piece in enumerate(np.array_split(arr, n_shards,
                                                         axis=ax)):
                    np.save(os.path.join(d, f"{safe}.shard{i}.npy"), piece)
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(self.root, "LATEST"), "w") as f:
            f.write(str(step))

    def save_async(self, step: int, tree: Any, n_shards: int = 8) -> None:
        """Snapshot every leaf to host memory (blocking only for the copy
        off the device), then write in a background thread (off the
        training critical path): the caller may update the tree in place as
        soon as this returns."""
        snap = {p: _host(leaf) for p, leaf in _flatten(tree).items()}
        self.wait()
        t = threading.Thread(target=self._write, args=(step, snap, n_shards))
        t.start()
        self._async_thread = t

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.root, "LATEST")
        if not os.path.exists(p):
            return None
        return int(open(p).read().strip())

    @staticmethod
    def _load_object(fp: str, leaf: str, step: int) -> np.ndarray:
        """np.load with loud failure: a missing or truncated checkpoint
        object names ITSELF (shard path, leaf, step) so the operator knows
        exactly which object to re-fetch from replication."""
        if not os.path.exists(fp):
            raise CheckpointError(
                f"checkpoint step {step}: leaf {leaf!r} is missing object "
                f"{fp} — the shard was never written or was lost; restore "
                f"it from a replica or re-save the checkpoint")
        try:
            return np.load(fp)
        except Exception as exc:
            raise CheckpointError(
                f"checkpoint step {step}: leaf {leaf!r} object {fp} is "
                f"unreadable (truncated or corrupt: {exc}); restore it "
                f"from a replica or re-save the checkpoint") from exc

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore a tree shaped like ``template``, each leaf on its template
        leaf's device in its dtype (a module's parameters written in
        place). Every shard is read; values are byte-exact.

        A missing or truncated object (full leaf or any shard) raises
        :class:`CheckpointError` naming the bad file — never a bare
        ``FileNotFoundError``/pickle error deep inside numpy."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint")
        d = self._leaf_dir(step)
        meta_path = os.path.join(d, "meta.json")
        if not os.path.exists(meta_path):
            raise CheckpointError(
                f"checkpoint step {step}: manifest {meta_path} is missing "
                f"— the checkpoint directory is incomplete")
        meta = json.load(open(meta_path))
        flat = {}
        for path, info in meta["leaves"].items():
            safe = path.replace("/", "__")
            # the MANIFEST decides the layout (mirrors the save-side
            # rule), so a missing shard is reported as that shard — not
            # misdiagnosed as a missing full object
            ax = info["shard_axis"]
            sharded = ax >= 0 and info["shape"][ax] >= meta["n_shards"]
            if not sharded:
                arr = self._load_object(
                    os.path.join(d, f"{safe}.full.npy"), path, step)
            else:
                pieces = [self._load_object(
                    os.path.join(d, f"{safe}.shard{i}.npy"), path, step)
                    for i in range(meta["n_shards"])]
                arr = np.concatenate(pieces, axis=ax)
            marker = "bfloat16" if info["dtype"] == "bfloat16" else ""
            flat[path] = (arr, marker)
        return _unflatten_like(template, flat)

    def restore_resharded(self, template: Any, mesh, pspecs,
                          step: Optional[int] = None) -> Any:
        """Elastic restore: place restored leaves directly onto a (possibly
        different) mesh with the given specs (``pspecs`` in the template's
        structure; for a module, a dict of its parameter names, as
        `repro_torch.distributed.sharding.param_pspecs` gives it). Returns
        the tree of ``DTensor``s (a dict of parameter names for a module),
        on the mesh's device."""
        host = self.restore(template, step)
        return distribute_params(host, pspecs, mesh)

    # -- dataset-catalog snapshot (simulated service restart) ----------------
    def _catalog_path(self, tag: str) -> str:
        return os.path.join(self.root, f"catalog_{tag}.json")

    def save_catalog(self, service, t: float, tag: str = "catalog") -> str:
        """Snapshot a `repro_torch.core.datasvc.StagingService` catalog to JSON.

        What survives a service restart: the engine selection, every
        dataset entry (paths, state, leases, holders, striped placement,
        per-entry counters, history) and the service-wide stats. What
        does NOT: un-flushed dirty result buffers (real arrays living in
        node memory — a restarted service re-learns them from sessions),
        and the node-local replicas themselves, which belong to the
        FABRIC and are re-verified at restore time. Returns the snapshot
        path."""
        from repro_torch.core.api import ENGINES, TopologyConfig
        entry = next((e for e in ENGINES.entries()
                      if e.stage_fn is service._stage_fn), None)
        if entry is None:
            raise CheckpointError(
                "cannot snapshot a service whose staging engine is not in "
                "the process-wide ENGINES registry (register it first)")
        params = {k: (v.to_dict() if isinstance(v, TopologyConfig) else v)
                  for k, v in service._stage_kw.items()}
        snap: Dict[str, Any] = {
            "t": t,
            "budget_bytes": service.budget_bytes,
            "engine": {"name": entry.name, "params": params},
            "stats": {k: v for k, v in vars(service.stats).items()
                      if isinstance(v, (int, float))},
            "entries": [],
        }
        for e in service.catalog:
            snap["entries"].append({
                "name": e.name,
                "paths": list(e.paths),
                "nbytes": e.nbytes,
                "state": e.state.value,
                "t_ready": e.t_ready,
                "t_unleased": e.t_unleased,
                "leases": dict(e.leases),
                "stage_count": e.stage_count,
                "acquires": e.acquires,
                "hits": e.hits,
                "coalesced": e.coalesced,
                "repairs": e.repairs,
                "holders": sorted(e.holders),
                "placement": (None if e.placement is None else {
                    "replication": e.placement.replication,
                    "owners": {str(i): list(own)
                               for i, own in e.placement.owners.items()},
                }),
                "history": [[ht, hs.value] for ht, hs in e.history],
            })
        path = self._catalog_path(tag)
        with open(path, "w") as f:
            json.dump(snap, f)
        return path

    def restore_catalog(self, fabric, tag: str = "catalog",
                        registry=None):
        """Rebuild a :class:`~repro_torch.core.datasvc.StagingService` from a
        catalog snapshot — the simulated SERVICE RESTART.

        The service process died; `fabric` (node-local stores included)
        is whatever survived. Every snapshotted entry's replica coverage
        is RE-VERIFIED against the stores: fully replicated entries whose
        live coverage is intact come back RESIDENT, entries missing
        replicas (a host died or was wiped while the service was down)
        come back DEGRADED with ``holders``/striped owners reflecting
        what is actually there — the next acquire repairs them through
        the normal self-healing path. Live leases are re-pinned on the
        surviving replica keys. Raises :class:`CheckpointError` if no
        snapshot ``tag`` exists."""
        from repro_torch.core.api import ENGINES
        from repro_torch.core.datasvc import (DatasetEntry, DatasetState,
                                        StagingService)
        path = self._catalog_path(tag)
        if not os.path.exists(path):
            raise CheckpointError(
                f"no catalog snapshot {path} — save_catalog was never "
                f"called (or the snapshot was lost)")
        snap = json.load(open(path))
        reg = registry if registry is not None else ENGINES
        engine = reg.config_for(snap["engine"]["name"],
                                **snap["engine"]["params"])
        service = StagingService(fabric, snap["budget_bytes"],
                                 engine=engine, registry=reg)
        for k, v in snap["stats"].items():
            if hasattr(service.stats, k):
                setattr(service.stats, k, v)
        t = snap["t"]
        live = set(fabric.live_ids(t)) if not fabric.faults.trivial else set(
            range(fabric.n_hosts))
        occupied = (DatasetState.RESIDENT, DatasetState.DEGRADED,
                    DatasetState.STAGING)
        for ed in snap["entries"]:
            entry = DatasetEntry(name=ed["name"], paths=list(ed["paths"]),
                                 nbytes=ed["nbytes"])
            entry.t_ready = ed["t_ready"]
            entry.t_unleased = ed["t_unleased"]
            entry.leases = dict(ed["leases"])
            entry.stage_count = ed["stage_count"]
            entry.acquires = ed["acquires"]
            entry.hits = ed["hits"]
            entry.coalesced = ed["coalesced"]
            entry.repairs = ed["repairs"]
            entry.history = [(ht, DatasetState(hs))
                             for ht, hs in ed["history"]]
            state = DatasetState(ed["state"])
            if state in occupied:
                state = self._verify_entry(fabric, entry, ed, live, t)
            entry.state = state
            entry.history.append((t, state))
            service.catalog.add(entry)
            # live leases survive the restart: re-pin each lease depth on
            # the replica keys that actually exist
            for _ in range(entry.lease_count):
                service._pin_once(entry, t)
        return service

    @staticmethod
    def _verify_entry(fabric, entry, ed: Dict[str, Any], live: set,
                      t: float):
        """Audit one snapshotted entry against the fabric's stores:
        returns the verified state and rewrites ``entry.holders`` /
        ``entry.placement`` to match reality."""
        from repro_torch.core.datasvc import DatasetState
        from repro_torch.core.staging import ReplicaPlacement
        n = fabric.n_hosts
        if ed["placement"] is None:
            holders = {h for h in ed["holders"]
                       if h in live and h < n
                       and all(p in fabric.hosts[h].store.data
                               for p in entry.paths)}
            entry.holders = holders
            return (DatasetState.RESIDENT if holders and live <= holders
                    else DatasetState.DEGRADED)
        pl = ed["placement"]
        owners = {}
        intact = True
        for i_str, own in pl["owners"].items():
            i = int(i_str)
            keys = [ReplicaPlacement.stripe_key(p, i) for p in entry.paths]
            alive_own = tuple(
                o for o in own
                if o in live and o < n
                and all(k in fabric.hosts[o].store.data for k in keys))
            owners[i] = alive_own
            if len(alive_own) < len(own):
                intact = False
        entry.placement = ReplicaPlacement(
            replication=pl["replication"], owners=owners)
        entry.holders = set(entry.placement.hosts())
        return (DatasetState.RESIDENT if intact
                else DatasetState.DEGRADED)
