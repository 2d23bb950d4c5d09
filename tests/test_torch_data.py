"""The port's staged training-data pipeline against the reference's.

The same token shards written on two fabrics (the reference's simulator and
the port's copy), staged collectively and naively: identical shard bytes,
staging reports (simulated seconds included) and node-local stores, and
the same token windows cut from them for the same seed, as int32 torch
tensors on the device asked for.
"""
import numpy as np
import pytest
import torch

import repro.core.fabric as J_fabric
import repro.data.pipeline as J_pipe
import repro_torch.core.fabric as T_fabric
import repro_torch.data.pipeline as T_pipe
from torch_parity import plain, stores


def _staged(fabric_mod, pipe, collective, n_hosts=8):
    fab = fabric_mod.Fabric(n_hosts=n_hosts, constants=fabric_mod.BGQ)
    paths = pipe.write_token_shards(fab, n_shards=4, tokens_per_shard=4096,
                                    vocab=1000, seed=3)
    loader = pipe.StagedLoader(fab, "data/*.bin", batch=2, seq=64,
                               host_id=n_hosts - 1)
    report = loader.stage(collective=collective)
    return fab, paths, loader, report


@pytest.mark.parametrize("collective", [True, False],
                         ids=["collective", "naive"])
def test_staging_matches_reference(collective):
    jfab, jpaths, jloader, jrep = _staged(J_fabric, J_pipe, collective)
    fab, paths, loader, rep = _staged(T_fabric, T_pipe, collective)
    assert paths == jpaths
    for p in paths:
        assert np.array_equal(fab.fs.files[p], jfab.fs.files[p])
    assert plain(rep) == plain(jrep)
    assert loader.staging_time == jloader.staging_time > 0
    assert stores(fab) == stores(jfab)


def test_batches_match_reference():
    _, _, jloader, _ = _staged(J_fabric, J_pipe, True)
    _, _, loader, _ = _staged(T_fabric, T_pipe, True)
    b = next(loader.batches(seed=5, device="cpu"))
    for k in ("tokens", "labels"):
        assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
        assert b[k].shape == (2, 64)
    ours = loader.batches(seed=5, device="cpu")
    theirs = jloader.batches(seed=5)
    for _ in range(4):
        assert np.array_equal(next(ours)["tokens"].numpy(),
                              np.asarray(next(theirs)["tokens"]))


def test_batches_before_staging_raise():
    fab = T_fabric.Fabric(n_hosts=2, constants=T_fabric.BGQ)
    loader = T_pipe.StagedLoader(fab, "data/*.bin", batch=1, seq=8)
    with pytest.raises(RuntimeError, match="stage"):
        next(loader.batches(device="cpu"))


def test_batches_default_to_the_card():
    """The device defaults to "cuda"; with no card that raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, loader, _ = _staged(T_fabric, T_pipe, True, n_hosts=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(loader.batches())
