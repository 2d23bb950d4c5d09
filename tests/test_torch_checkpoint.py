"""The port's checkpoint store and fault-tolerant driver.

The cases of tests/test_checkpoint.py on torch trees (round trip, latest
step, async save, the driver's restart and elastic rescale, the heartbeat,
damaged checkpoints that fail naming the bad object), then what the port
adds: the two stores read each other's checkpoints byte for byte (bf16
leaves included), an async save is a snapshot, a module and a tuple state
restore in place on their own device and type, and the trainer restarts
from its checkpoint on the same state it saved.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.datasvc as J_datasvc
import repro.core.fabric as J_fabric
import repro_torch.core.datasvc as T_datasvc
import repro_torch.core.fabric as T_fabric
from repro.checkpoint.store import CheckpointStore as JStore
from repro_torch.checkpoint.store import CheckpointError, CheckpointStore
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.runtime import driver as D
from repro_torch.runtime.driver import HeartbeatMonitor, TrainDriver


def make_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn((64, 32), generator=g),
        "emb": {"table": torch.randn((100, 16), generator=g)
                .to(torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def leaves(tree):
    """{path: tensor} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": t for p, t in leaves(v).items()})
        else:
            out[k] = v
    return out


def same_bytes(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.reshape(-1).view(torch.uint8).tolist()
            == b.reshape(-1).view(torch.uint8).tolist())


def test_roundtrip_exact(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = make_tree()
    store.save(3, tree, n_shards=4)
    back = store.restore(tree)
    for p, t in leaves(tree).items():
        assert same_bytes(leaves(back)[p], t), p


def test_latest_and_multiple_steps(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = make_tree()
    store.save(1, t)
    store.save(5, t)
    assert store.latest_step() == 5


def test_async_save_is_a_snapshot(tmp_path):
    """``save_async`` copies to host before it returns: a later in-place
    update of the tree does not reach the checkpoint."""
    store = CheckpointStore(str(tmp_path))
    t = make_tree()
    before = t["w"].clone()
    store.save_async(9, t)
    t["w"].add_(1.0)
    store.wait()
    back = store.restore(t)
    assert torch.equal(back["w"], before)


def test_restore_follows_the_template(tmp_path):
    """Each leaf comes back on its template leaf's device in its dtype; a
    module's parameters and a tuple's items are restored in place of the
    template's."""
    store = CheckpointStore(str(tmp_path))
    cfg = get_smoke_config("qwen3_32b")
    model = M.init_model(torch.Generator().manual_seed(0), cfg)
    store.save(2, (model, {"step": torch.tensor(2)}))
    other = M.init_model(torch.Generator().manual_seed(1), cfg)
    back, extra = store.restore((other, {"step": torch.tensor(0)}))
    assert back is other and int(extra["step"]) == 2
    for (n, p), (_, q) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(p, q), n
    as_bf16 = store.restore((other.to(torch.bfloat16),
                             {"step": torch.tensor(0.0)}))
    assert as_bf16[0].embed.table.dtype == torch.bfloat16
    assert as_bf16[1]["step"].dtype == torch.float32


def test_driver_restart_from_failure(tmp_path):
    """Node failure at step 7 -> restart resumes from checkpoint 5 and still
    reaches the target step count."""
    store = CheckpointStore(str(tmp_path))

    def build_step(mesh_spec):
        state = {"x": torch.zeros(()), "step": torch.zeros((),
                                                          dtype=torch.int32)}

        def step_fn(s):
            s = {"x": s["x"] + 1.0, "step": s["step"] + 1}
            return s, {"loss": 1.0 / (1.0 + float(s["x"]))}
        return step_fn, state

    driver = TrainDriver(store, build_step, checkpoint_every=5,
                         failure_schedule={7: "fail"})
    report = driver.run(total_steps=10, mesh_spec={})
    assert report.restarts == 1
    assert report.checkpoints[-1] == 10
    final = store.restore({"x": torch.zeros(()),
                           "step": torch.zeros((), dtype=torch.int32)})
    assert float(final["x"]) == 10.0


def test_driver_restart_waits_for_the_last_save(tmp_path, monkeypatch):
    """A failure right after an async save restarts from that checkpoint,
    not from step 0: the driver waits for the writer before it reads
    LATEST (the reference's restart does not)."""
    store = CheckpointStore(str(tmp_path))
    real_write = store._write

    def slow_write(*a):
        import time
        time.sleep(0.3)
        real_write(*a)
    monkeypatch.setattr(store, "_write", slow_write)

    def build_step(mesh_spec):
        def step_fn(s):
            return {"x": s["x"] + 1.0}, {"loss": 0.0}
        return step_fn, {"x": torch.zeros(())}

    report = TrainDriver(store, build_step, checkpoint_every=4,
                         failure_schedule={5: "fail"}).run(6, mesh_spec={})
    assert report.restarts == 1 and report.steps_completed == 5 + 2


def test_driver_elastic_rescale(tmp_path):
    store = CheckpointStore(str(tmp_path))
    seen_meshes = []

    def build_step(mesh_spec):
        seen_meshes.append(dict(mesh_spec))
        state = {"x": torch.zeros(())}

        def step_fn(s):
            return {"x": s["x"] + 1.0}, {"loss": 0.0}
        return step_fn, state

    driver = TrainDriver(store, build_step, checkpoint_every=4,
                         failure_schedule={6: "rescale"})
    report = driver.run(total_steps=8, mesh_spec={"n_devices": 8})
    assert report.rescales == 1
    assert seen_meshes[-1]["n_devices"] == 4      # shrunk after rescale


def test_elastic_rescale_counts_the_devices_it_has(tmp_path):
    """With no ``n_devices`` given, the rescale halves the CUDA device
    count (1 on a machine without a card), never below 1."""
    seen = []

    def build_step(mesh_spec):
        seen.append(dict(mesh_spec))
        return (lambda s: ({"x": s["x"] + 1.0}, {"loss": 0.0}),
                {"x": torch.zeros(())})

    TrainDriver(CheckpointStore(str(tmp_path)), build_step,
                checkpoint_every=2,
                failure_schedule={3: "rescale"}).run(4, mesh_spec={})
    assert seen[-1]["n_devices"] == max(1, D._device_count() // 2)


def test_heartbeat_monitor():
    mon = HeartbeatMonitor(n_workers=4, timeout=5.0)
    for w in range(4):
        mon.beat(w, 0.0)
    mon.beat(0, 8.0)
    assert set(mon.dead_workers(9.0)) == {1, 2, 3}


# ---------------------------------------------------------------------------
# restore hardening: damaged checkpoints fail loudly, naming the bad object
# ---------------------------------------------------------------------------

def _damaged(tmp_path, name, truncate=None):
    store = CheckpointStore(str(tmp_path))
    store.save(3, make_tree(), n_shards=4)
    bad = os.path.join(str(tmp_path), "step_00000003", name)
    if truncate is None:
        os.remove(bad)
    else:
        with open(bad, "r+b") as f:
            f.truncate(truncate)
    return store


@pytest.mark.parametrize("name,truncate,match", [
    ("w.shard2.npy", None, r"w\.shard2\.npy"),
    ("emb__table.shard1.npy", 12, r"emb__table\.shard1\.npy.*unreadable"),
    ("step.full.npy", None, r"step\.full\.npy"),
    ("step.full.npy", 4, r"step\.full\.npy.*unreadable"),
    ("meta.json", None, "manifest"),
], ids=["missing-shard", "truncated-shard", "missing-full",
        "truncated-full", "missing-manifest"])
def test_damaged_checkpoint_names_the_object(tmp_path, name, truncate,
                                             match):
    store = _damaged(tmp_path, name, truncate)
    with pytest.raises(CheckpointError, match=match):
        store.restore(make_tree())


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (1, 1) ("data", "model") CPU mesh over a gloo group of one rank,
    destroyed after the test."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec", [("data",), (None, "model"), ()],
                         ids=["data", "model", "replicated"])
def test_restore_resharded_onto_one_rank_mesh(tmp_path, one_rank_mesh,
                                              spec):
    """Each leaf comes back as a DTensor on the mesh with the placements
    of its spec, its local block and full tensor equal to the saved one."""
    from repro_torch.distributed.sharding import P, placements
    store = CheckpointStore(str(tmp_path / "ckpt"))
    tree = make_tree()
    store.save(1, tree)
    specs = {"w": P(*spec), "emb": {"table": P(*spec)}, "step": P()}
    back = store.restore_resharded(make_tree(), one_rank_mesh, specs)
    for (p, t), (_, s) in zip(leaves(tree).items(), leaves(specs).items()):
        got = leaves(back)[p]
        assert list(got.placements) == placements(s, one_rank_mesh)
        assert same_bytes(got.to_local(), t) and same_bytes(
            got.full_tensor(), t), p


def test_restore_resharded_module_onto_one_rank_mesh(tmp_path,
                                                     one_rank_mesh):
    """A model restores by parameter name with ``param_pspecs``' specs."""
    from repro_torch.distributed.sharding import make_ctx, param_pspecs
    cfg = get_smoke_config("qwen3_32b")
    saved = M.init_model(torch.Generator().manual_seed(3), cfg)
    store = CheckpointStore(str(tmp_path / "ckpt"))
    store.save(2, saved)
    template = M.init_model(torch.Generator().manual_seed(4), cfg)
    specs = param_pspecs(cfg, template, make_ctx(one_rank_mesh))
    back = store.restore_resharded(template, one_rank_mesh, specs)
    assert list(back) == [n for n, _ in saved.named_parameters()]
    for n, p in saved.named_parameters():
        assert same_bytes(back[n].full_tensor(), p.detach()), n


# ---------------------------------------------------------------------------
# the two stores read each other's checkpoints
# ---------------------------------------------------------------------------

def _jax_tree():
    key = jax.random.PRNGKey(0)
    return {
        "w": jax.random.normal(key, (64, 32), jnp.float32),
        "emb": {"table": jax.random.normal(key, (100, 16))
                .astype(jnp.bfloat16)},
        "step": jnp.asarray(7, jnp.int32),
    }


def raw(x):
    """(shape, bytes) of a torch tensor or a numpy or JAX array, bf16 as
    its bits."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    return x.shape, x.tobytes()


@pytest.mark.parametrize("n_shards", [1, 4])
def test_port_restores_a_reference_checkpoint(tmp_path, n_shards):
    jtree = _jax_tree()
    JStore(str(tmp_path)).save(4, jtree, n_shards=n_shards)
    template = make_tree()
    back = CheckpointStore(str(tmp_path)).restore(template)
    for p, t in leaves(back).items():
        assert t.dtype == leaves(template)[p].dtype, p
        assert raw(t) == raw(leaves(jtree)[p]), p


@pytest.mark.parametrize("n_shards", [1, 4])
def test_reference_restores_a_port_checkpoint(tmp_path, n_shards):
    tree = make_tree()
    CheckpointStore(str(tmp_path)).save(6, tree, n_shards=n_shards)
    back = JStore(str(tmp_path)).restore(_jax_tree())
    assert back["emb"]["table"].dtype == jnp.bfloat16
    for p, t in leaves(tree).items():
        assert raw(leaves(back)[p]) == raw(t), p


# ---------------------------------------------------------------------------
# the dataset-catalog snapshot, copied from the reference
# ---------------------------------------------------------------------------

def _service(fabric_mod, datasvc_mod):
    fab = fabric_mod.Fabric(n_hosts=8, constants=fabric_mod.BGQ)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        paths.append(f"d/f{i}.bin")
        fab.fs.put(paths[-1], rng.integers(0, 255, 1 << 12, dtype=np.uint8))
    svc = datasvc_mod.StagingService(fab, budget_bytes=1 << 20)
    svc.register("scan", paths=paths, t=0.0)
    return fab, svc


@pytest.mark.parametrize("lose_host", [False, True],
                         ids=["intact", "host-lost"])
def test_catalog_restart_matches_reference(tmp_path, lose_host):
    """A service snapshot and its restart, with or without a host lost while
    the service was down: the same snapshot JSON, and the restored entry in
    the same state with the same holders and leases, in both packages."""
    out = {}
    for name, store_cls, fabric_mod, datasvc_mod in [
            ("ref", JStore, J_fabric, J_datasvc),
            ("port", CheckpointStore, T_fabric, T_datasvc)]:
        fab, svc = _service(fabric_mod, datasvc_mod)
        lease = svc.acquire("alice", "scan", 0.0)
        store = store_cls(str(tmp_path / name))
        path = store.save_catalog(svc, t=lease.t_ready + 1.0)
        if lose_host:
            fab.kill_host(4, lease.t_ready + 2.0)
        entry = store.restore_catalog(fab).catalog["scan"]
        out[name] = (json.load(open(path)), entry.state.value,
                     sorted(entry.holders), entry.lease_count)
    assert out["port"] == out["ref"]
    assert out["port"][1] == ("degraded" if lose_host else "resident")


def test_catalog_restore_without_snapshot_is_loud(tmp_path):
    fab, _ = _service(T_fabric, T_datasvc)
    with pytest.raises(CheckpointError, match="no catalog snapshot"):
        CheckpointStore(str(tmp_path)).restore_catalog(fab)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_restarts_on_the_state_it_saved(tmp_path, monkeypatch):
    """``launch.train.main`` on the CPU: smoke qwen3-32b, 12 steps,
    checkpoints every 10, a failure at step 11. One restart, from step 10,
    onto a state equal byte for byte to the one saved; the losses finite
    and the run 10 + 1 + 2 steps long."""
    saved, restored = {}, {}
    real_save, real_restore = CheckpointStore.save_async, TrainDriver._restore

    def save_async(self, step, tree, n_shards=8):
        from repro_torch.checkpoint.store import _flatten
        saved[step] = {p: t.detach().clone()
                       for p, t in _flatten(tree).items()}
        real_save(self, step, tree, n_shards)

    def restore(self, template, step):
        from repro_torch.checkpoint.store import _flatten
        state = real_restore(self, template, step)
        restored[step] = {p: t.detach().clone()
                          for p, t in _flatten(state).items()}
        return state
    monkeypatch.setattr(CheckpointStore, "save_async", save_async)
    monkeypatch.setattr(TrainDriver, "_restore", restore)
    report = launch_train.main(arch="qwen3-32b", smoke=True, steps=12,
                               batch=2, seq=16, ckpt_dir=str(tmp_path),
                               device="cpu", fail_at=11)
    assert report.restarts == 1 and report.checkpoints == [10]
    assert report.steps_completed == 13
    assert np.isfinite(report.losses).all()
    assert sorted(saved[10]) == sorted(restored[10])
    for p, t in saved[10].items():
        assert same_bytes(restored[10][p], t), p
