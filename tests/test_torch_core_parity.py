"""The port's copy of the staging simulator against the reference package.

At the interactive example's settings (128 BG/Q hosts of 16 ranks, the
``"scan/*.bin"`` spec) the copy must give identical ``Report``s, identical
node-local stores and identical many-task statistics.
"""
import numpy as np
import pytest

import repro.core.api as J_api
import repro.core.fabric as J_fabric
import repro.core.manytask as J_manytask
import repro_torch.core.api as T_api
import repro_torch.core.fabric as T_fabric
import repro_torch.core.manytask as T_manytask
from torch_parity import plain, stores


def _frames(n=8, size=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.poisson(8.0, (n, size, size)).astype(np.float32)


def _fabric(pkg_fabric, frames, **kw):
    fab = pkg_fabric.Fabric(n_hosts=128, ranks_per_host=16,
                            constants=pkg_fabric.BGQ, **kw)
    for i, frame in enumerate(frames):
        fab.fs.put(f"scan/frame_{i:05d}.bin", frame.view(np.uint8))
    return fab


def _stage(api, fabric_mod, config_name, frames, **config_kw):
    fab = _fabric(fabric_mod, frames)
    spec = api.StagingSpec([api.BroadcastEntry(files=("scan/*.bin",))])
    rep = api.StagingClient(fab).stage(
        spec, getattr(api, config_name)(**config_kw))
    return fab, rep


@pytest.mark.parametrize("config,kw", [
    ("CollectiveConfig", {}),
    ("NaiveConfig", {}),
    ("PipelinedConfig", {"chunk_bytes": 4096}),
    ("CollectiveConfig", {"topology": "bgq_torus"}),
    ("CollectiveConfig", {"compression": "frame-fast",
                          "topology": "bgq_torus"}),
    ("ReplicatedConfig", {"replication": 2}),
])
def test_report_and_stores_identical(config, kw):
    frames = _frames()
    fab_j, rep_j = _stage(J_api, J_fabric, config, frames, **kw)
    fab_t, rep_t = _stage(T_api, T_fabric, config, frames, **kw)
    assert plain(rep_t) == plain(rep_j)
    assert rep_t.total_time == rep_j.total_time
    assert rep_t.net_bytes == rep_j.net_bytes
    assert stores(fab_t) == stores(fab_j)
    assert fab_t.fs.busy_time == fab_j.fs.busy_time


def test_collective_and_naive_times_identical_at_example_size():
    frames = _frames(n=24, size=128)
    times = {}
    for pkg, fab_mod in [("jax", J_fabric), ("torch", T_fabric)]:
        api = J_api if pkg == "jax" else T_api
        _, coll = _stage(api, fab_mod, "CollectiveConfig", frames)
        _, naive = _stage(api, fab_mod, "NaiveConfig", frames)
        times[pkg] = (coll.total_time, naive.total_time)
    assert times["torch"] == times["jax"]


def _engine_stats(fabric_mod, api, manytask, **engine_kw):
    frames = _frames()
    fab = _fabric(fabric_mod, frames)
    spec = api.StagingSpec([api.BroadcastEntry(files=("scan/*.bin",))])
    api.StagingClient(fab).stage(spec, api.CollectiveConfig())
    paths = [f"scan/frame_{i:05d}.bin" for i in range(len(frames))]
    fab.fs.put("extra/unstaged.bin", np.zeros(4096, np.uint8))
    tasks = [manytask.Task(task_id=i, duration=30.0 + (i % 7),
                           inputs=((paths[i % len(paths)],) if i % 5
                                   else ("extra/unstaged.bin",)),
                           deps=((i - 3,) if i % 11 == 0 and i >= 3 else ()))
             for i in range(300)]
    return manytask.ManyTaskEngine(fab, **engine_kw).run(tasks)


@pytest.mark.parametrize("engine_kw", [
    {"n_workers": 64},
    {"n_workers": 64, "straggler_factor": 0.1, "seed": 5},
    {"n_workers": 32, "failure_times": {3: 40.0, 7: 95.0}},
])
def test_manytask_stats_identical(engine_kw):
    s_j = _engine_stats(J_fabric, J_api, J_manytask, **engine_kw)
    s_t = _engine_stats(T_fabric, T_api, T_manytask, **engine_kw)
    assert plain(s_t) == plain(s_j)
    assert s_t.makespan == s_j.makespan and s_t.makespan > 0
