"""Staged training-data pipeline: the paper's technique as the input path.

Counterpart of ``repro.data.pipeline``. A dataset lives on the simulated
shared FS as shard files. Leaders resolve the shard manifest once and stage
each host's shards collectively into node-local stores (an aggregate FS
read of 1x the dataset, paper §IV); batches are then cut from node-local
data at memory speed, and repeats hit the pinned cache at no FS cost
(§VI-B). ``StagedLoader.batches`` yields int32 torch tensors on the
training device; the staging report's simulated seconds are the
simulator's (`repro_torch.core`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core.api import (BroadcastEntry, CollectiveConfig,
                                  NaiveConfig, StagingClient, StagingSpec)
from repro_torch.core.fabric import Fabric
from repro_torch.core.staging import StagingReport
from repro_torch.device import DeviceLike, resolve_device


def write_token_shards(fabric: Fabric, n_shards: int, tokens_per_shard: int,
                       vocab: int, seed: int = 0, prefix: str = "data"
                       ) -> List[str]:
    """Synthesize a token dataset as shard files on the shared FS."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_shards):
        toks = rng.integers(0, vocab, tokens_per_shard, dtype=np.int32)
        path = f"{prefix}/shard_{i:04d}.bin"
        fabric.fs.put(path, toks.view(np.uint8))
        paths.append(path)
    return paths


@dataclass
class StagedLoader:
    fabric: Fabric
    pattern: str
    batch: int
    seq: int
    host_id: int = 0
    staging_time: float = 0.0
    _data: Optional[np.ndarray] = None

    def stage(self, collective: bool = True) -> StagingReport:
        """Stage the shard manifest through the unified client, on the
        collective engine or the naive one; returns the staging report
        (simulated time)."""
        config = CollectiveConfig() if collective else NaiveConfig()
        spec = StagingSpec([BroadcastEntry(files=(self.pattern,), pin=True)])
        res = StagingClient(self.fabric).stage(spec, config)
        self.staging_time = res.total_time
        store = self.fabric.hosts[self.host_id].store
        blobs = [store.data[p] for p in sorted(res.resolved_files)]
        self._data = np.concatenate(blobs).view(np.int32)
        return res.reports[0]

    def batches(self, seed: int = 0, device: DeviceLike = "cuda"
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield {tokens, labels} (B, seq) int32 batches on ``device``, cut
        from node-local data at windows drawn from numpy's generator at
        ``seed``, as the reference draws them."""
        if self._data is None:
            raise RuntimeError("call stage() first")
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        n_tok = self.batch * self.seq
        while True:
            start = int(rng.integers(0, max(1, len(self._data) - n_tok - 1)))
            window = self._data[start:start + n_tok].reshape(self.batch,
                                                             self.seq)
            toks = torch.from_numpy(window.copy()).to(dev)
            yield {"tokens": toks, "labels": toks}
