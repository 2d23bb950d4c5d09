"""The port's copy of the staging simulator against the reference package.

At the interactive example's settings (128 BG/Q hosts of 16 ranks, the
``"scan/*.bin"`` spec) the copy must give identical ``Report``s, identical
node-local stores and identical many-task statistics. The
application-memory cache (``core/cache.py``) and the dataflow engine
(``core/dataflow.py``) run the reference's own test scenarios
(tests/test_cache.py; the ``Dataflow`` cases of tests/test_manytask.py,
tests/test_streaming.py and tests/test_api.py) in both packages, with
every counter, resident set, pin, result and event identical.
"""
import importlib
import types

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


# ---------------------------------------------------------------------------
# core/cache.py and core/dataflow.py: the reference's scenarios, both packages
# ---------------------------------------------------------------------------

def _core(pkg):
    return types.SimpleNamespace(**{
        m: importlib.import_module(f"{pkg}.core.{m}")
        for m in ("api", "cache", "dataflow", "fabric", "streaming")})


def _snap(cache, got=None):
    """What a ``TaskInputCache`` shows: counters, the charged time, the
    resident entries in FIFO order, the pins and the value returned."""
    return (cache.hits, cache.misses, cache.read_time_charged,
            list(cache._mem), dict(cache._pins), sorted(cache._faulted),
            cache.resident_bytes, plain(got))


def _store_cache(core, names, size, **kw):
    store = core.fabric.NodeLocalStore(0, core.fabric.BGQ)
    for name in names:
        store.write(name, np.ones(size, np.uint8), 0.0)
    return store, core.cache.TaskInputCache(store, **kw)


def cache_store_pin(core):
    store, _ = _store_cache(core, "ab", 1000)
    store.pin("a")
    store.evict_lru(budget_bytes=1200)
    return sorted(store.data)


def cache_second_read_free(core):
    _, cache = _store_cache(core, ["x"], 1 << 20)
    return [_snap(cache, cache.get("x")), _snap(cache, cache.get("x"))]


def cache_capacity_fifo(core):
    store, cache = _store_cache(core, "abcd", 400, capacity_bytes=1000)
    return [_snap(cache, cache.get(n)) for n in "abcda"]


def cache_deserialize_once(core):
    store = core.fabric.NodeLocalStore(0, core.fabric.BGQ)
    store.write("x", np.arange(256, dtype=np.uint8), 0.0)
    calls = []

    def parse(raw):
        calls.append(raw.size)
        return raw.astype(np.float64)
    cache = core.cache.TaskInputCache(store)
    vals = [cache.get("x", parse) for _ in range(3)]
    assert vals[0] is vals[1] is vals[2]
    return [_snap(cache, vals[0]), calls, cache.get("nope", parse), calls]


def cache_read_time_charged(core):
    store, cache = _store_cache(core, ["x"], 1 << 20)
    store.write("y", np.ones(1 << 19, np.uint8), 0.0)
    return [_snap(cache, cache.get(n)) for n in ("nope", "x", "x", "y")]


def cache_pins(core):
    store, cache = _store_cache(core, "abc", 400, capacity_bytes=900)
    out = [_snap(cache, cache.get("a"))]
    cache.pin("a")
    cache.pin("a")
    out += [_snap(cache, cache.get(n)) for n in "bc"]
    cache.unpin("a")
    out.append(_snap(cache, cache.get("b")))
    cache.unpin("a")
    store.write("d", np.ones(400, np.uint8), 0.0)
    return out + [_snap(cache, cache.get("d"))]


def cache_linear_sweep(core):
    n = 2000
    store, cache = _store_cache(core, [f"f{i}" for i in range(n)], 10,
                                capacity_bytes=10 * n + 5)
    store.write("big", np.ones(10 * n, np.uint8), 0.0)
    for i in range(n):
        cache.get(f"f{i}")
    probes = []

    class CountingPins(dict):
        def __contains__(self, key):
            probes.append(key)
            return super().__contains__(key)
    cache._pins = CountingPins()
    cache.get("big")
    assert len(probes) <= n + 1
    return [len(probes), list(cache._mem), cache.resident_bytes]


def cache_drop(core):
    store, cache = _store_cache(core, "ab", 400, capacity_bytes=900)
    cache.get("a")
    cache.pin("a")
    cache.pin("a")
    cache.drop("a")
    out = [_snap(cache)]
    store.write("c", np.ones(400, np.uint8), 0.0)
    return out + [_snap(cache, cache.get(n)) for n in "abc"]


def cache_stale_pin_cleared(core):
    store, cache = _store_cache(core, ["a"], 400, capacity_bytes=900)
    store.write("x", np.ones(600, np.uint8), 0.0)
    out = [_snap(cache, cache.get(n)) for n in "ax"]
    cache.pin("a")
    store.drop("a")
    out.append(_snap(cache, cache.get("a")))
    store.write("a", np.ones(400, np.uint8), 0.0)
    store.write("b", np.ones(400, np.uint8), 0.0)
    cache2 = core.cache.TaskInputCache(store, capacity_bytes=900)
    return out + [_snap(cache2, cache2.get(n)) for n in "ax"]


def cache_pin_ahead_of_fault(core):
    store = core.fabric.NodeLocalStore(0, core.fabric.BGQ)
    cache = core.cache.TaskInputCache(store, capacity_bytes=900)
    cache.pin("a")
    out = [_snap(cache, cache.get("a")), _snap(cache, cache.get("a"))]
    for n in "abc":
        store.write(n, np.ones(400, np.uint8), 0.0)
    return out + [_snap(cache, cache.get(n)) for n in "abc"]


def _flow_result(flow, stats, futs):
    return [plain(stats), [f.result() for f in futs],
            plain(flow.stage_report)]


def dataflow_mapreduce_no_barrier(core):
    flow = core.dataflow.Dataflow(core.fabric.Fabric(n_hosts=4))
    maps = flow.foreach(lambda x: x, list(range(16)),
                        durations=[1.0 if i < 15 else 50.0
                                   for i in range(16)])
    total = flow.merge_pairwise(lambda a, b: a + b, maps, duration=0.5)
    stats = flow.run(n_workers=4)
    ev = {e.task_id: e for e in stats.events}
    assert min(e.start for t, e in ev.items() if t >= 16) < ev[15].end
    return _flow_result(flow, stats, maps + [total])


def dataflow_frame_futures(core):
    fab = core.fabric.Fabric(n_hosts=2, constants=core.fabric.BGQ)
    frames = _frames(n=8, size=32, seed=3)
    src = core.streaming.DetectorSource.from_frames(frames, rate_hz=2.0)
    _, recs = core.streaming.StreamStager(
        fab, window_bytes=8 * frames[0].nbytes).stage(src)
    flow = core.dataflow.Dataflow(fab)
    futs = [flow.frame_task(lambda r: r.frame_id, rec, duration=0.01)
            for rec in recs]
    total = flow.merge_pairwise(lambda a, b: a + b, futs, duration=0.0)
    stats = flow.run(n_workers=4)
    ev = {e.task_id: e for e in stats.events}
    assert all(ev[f.task_id].start >= r.t_avail - 1e-12
               for r, f in zip(recs, futs))
    assert total.result() == sum(range(8))
    return _flow_result(flow, stats, futs + [total])


def dataflow_not_befores(core):
    flow = core.dataflow.Dataflow(core.fabric.Fabric(n_hosts=2))
    futs = flow.foreach(lambda x: x, [10, 20], durations=[0.1, 0.1],
                        not_befores=[3.0, 0.0])
    return _flow_result(flow, flow.run(n_workers=2), futs)


def dataflow_stage_hook(core):
    fab = core.fabric.Fabric(n_hosts=2, constants=core.fabric.BGQ)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        fab.fs.put(f"d/f{i}.bin", rng.integers(0, 255, 1 << 16,
                                               dtype=np.uint8))
        paths.append(f"d/f{i}.bin")
    flow = core.dataflow.Dataflow(
        fab, stage="d/*.bin",
        stage_config=core.api.PipelinedConfig(chunk_bytes=1 << 12))
    futs = flow.foreach(lambda p: p, paths, durations=[0.5] * len(paths),
                        inputs_of=lambda p: [p])
    stats = flow.run(n_workers=2)
    assert flow.stage_report.engine == "pipelined"
    assert all(e.start >= flow.stage_report.total_time
               for e in stats.events)
    assert stats.cache_hits == len(paths) and stats.cache_misses == 0
    return _flow_result(flow, stats, futs) + [stores(fab)]


def dataflow_without_stage_hook(core):
    flow = core.dataflow.Dataflow(core.fabric.Fabric(n_hosts=2))
    fut = flow.task(lambda: 41, duration=1.0)
    stats = flow.run(n_workers=1)
    assert flow.stage_report is None and fut.result() == 41
    return _flow_result(flow, stats, [fut])


@pytest.mark.parametrize("scenario", [
    cache_store_pin, cache_second_read_free, cache_capacity_fifo,
    cache_deserialize_once, cache_read_time_charged, cache_pins,
    cache_linear_sweep, cache_drop, cache_stale_pin_cleared,
    cache_pin_ahead_of_fault, dataflow_mapreduce_no_barrier,
    dataflow_frame_futures, dataflow_not_befores, dataflow_stage_hook,
    dataflow_without_stage_hook], ids=lambda f: f.__name__)
def test_cache_and_dataflow_identical(scenario):
    assert scenario(_core("repro_torch")) == scenario(_core("repro"))
