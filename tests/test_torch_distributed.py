"""The port's mesh layer against the reference package on the CPU.

Sharding rules, with no process group and no device: for the ten configs at
full size, on the production meshes (16, 16) ("data", "model") and (2, 16,
16) ("pod", "data", "model"), ``param_pspecs`` of the port's meta-device
model, ``input_pspecs`` of every shape cell and ``cache_pspecs`` of the
decode caches equal the reference's leaf by leaf (the reference over
``jax.eval_shape``; its ``ShardCtx`` reads only the mesh's ``shape`` and
``axis_names``, so a namespace stands in for 256 devices). A per-layer
leaf of the port equals the reference's stacked leaf without its leading
layer dim.

Collectives, against the JAX package: one JAX process on 8 fake CPU devices
(as tests/test_distributed.py runs it) and one gloo group of 4 port ranks
(tests/torch_dist_worker.py), started together on the same inputs and each
bounded in time. Bit-exact (``np.array_equal``, the int8 payloads and
float32 scales included): ``device_replicate`` and ``staged_restore``
(shards in key order), ``device_shard``'s local blocks, ``quantize_int8``
(ties round half to even), ``compress_residual``, ``compressed_psum`` and
``compressed_grad_allreduce`` over a pod axis of 2 (grads and error state),
and ``restore_resharded`` of the reference's checkpoint onto a mesh of 4
and of (2, 2): each rank's local block equals the slice its placement
names and the reference's shard on the same device index. The dequant-sum
is held exact (tolerance 0): at two participants each product and the one
sum round once in both packages. Ranks holding different blocks are held
to the numpy formula (per-block scale max|x| / 127 + 1e-12 in float32,
round half to even, products summed in rank order), exactly, over pod axes
of 2 and 4.
"""
import functools
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.configs import registry as jax_registry
from repro.configs.base import SHAPES as J_SHAPES
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import sharding as TS
from repro_torch.models.model import Model
from repro_torch.models.transformer import init_caches

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TIMEOUT_S = 240


def _ctx(pkg, mesh):
    shape, axes = MESHES[mesh]
    ns = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                               axis_names=axes, mesh_dim_names=axes)
    if pkg is JS:
        return JS.make_ctx(ns)
    return TS.make_ctx(types.SimpleNamespace(mesh_dim_names=axes,
                                             shape=shape))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jax_registry.get_config(arch)
    return cfg, jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                     cfg))


def _flat_ref(specs):
    return {p: tuple(s) for p, s in JS._tree_paths(specs).items()}


def _per_layer(port_flat, ref_flat):
    """The port's specs, each keyed by the reference's path; a per-layer
    leaf's spec gets the reference's leading layer entry back (None)."""
    out = {}
    for name, spec in port_flat.items():
        path, per_layer = TS._ref_path(name)
        spec = tuple(spec)
        full = (None,) + spec if per_layer and len(ref_flat[path]) else spec
        assert out.setdefault(path, full) == full, (name, spec)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_pspecs_match_reference(arch, mesh):
    jcfg, shapes = _ref_params(arch)
    ref = _flat_ref(JS.param_pspecs(jcfg, shapes, _ctx(JS, mesh)))
    cfg = registry.get_config(arch)
    model = Model(cfg, None, "meta")
    port = TS.param_pspecs(cfg, model, _ctx(TS, mesh))
    assert list(port) == [n for n, _ in model.named_parameters()]
    assert all(isinstance(s, TS.P) for s in port.values())
    assert _per_layer(port, ref) == ref
    assert any(s != () for s in ref.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_pspecs_match_reference(arch, mesh):
    jcfg, cfg = jax_registry.get_config(arch), registry.get_config(arch)
    for name in registry.supported_shapes(cfg):
        ref = JS.input_pspecs(jcfg, J_SHAPES[name], _ctx(JS, mesh))
        port = TS.input_pspecs(cfg, SHAPES[name], _ctx(TS, mesh))
        assert {k: tuple(v) for k, v in port.items()} == \
            {k: tuple(v) for k, v in ref.items()}, name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_cache_pspecs_match_reference(arch, mesh):
    jcfg, cfg = jax_registry.get_config(arch), registry.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        caches = jax.eval_shape(lambda: JM.init_decode_state(
            jcfg, shape.global_batch, shape.seq_len))
        ref = _flat_ref(JS.cache_pspecs(jcfg, caches, _ctx(JS, mesh)))
        port_caches = init_caches(cfg, shape.global_batch, shape.seq_len,
                                  "meta")
        port = TS.cache_pspecs(cfg, port_caches, _ctx(TS, mesh))
        flat = TS._tree_paths(port)
        assert set(flat) == set(TS._tree_paths(port_caches))
        assert _per_layer(flat, ref) == ref, name


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TS.placements(TS.P(("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert TS.placements(TS.P(), mesh) == [Replicate()] * 3
    assert TS.placements(TS.P(None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        TS.placements(TS.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        TS.placements(TS.P("data", "data"), mesh)


def test_mesh_context_inside_the_model_raises(tmp_path):
    """A context that only names axes (the spec functions' namespace) has
    no mesh: every collective inside the model raises, none falls back to
    one rank. A context of a ``DeviceMesh`` carries it: on a (1, 1) gloo
    mesh ``constrain`` and ``gather`` keep a tensor whole and
    ``fsdp_gather`` gives every weight of a block laid onto the mesh back
    as the plain tensor it was."""
    from torch.distributed.tensor import DTensor
    from torch_parity import one_rank_mesh
    ctx = _ctx(TS, "16x16")
    assert (ctx.tp_size, ctx.dp_size) == (16, 16) and ctx.mesh is None
    assert _ctx(TS, "2x16x16").dp_size == 32
    cfg = registry.get_smoke_config("qwen3_32b")
    with pytest.raises(RuntimeError, match="no DeviceMesh"):
        ctx.constrain(torch.zeros(2), "data")
    with pytest.raises(RuntimeError, match="no DeviceMesh"):
        TS.fsdp_gather({"w": torch.zeros(2, 2)}, cfg, ctx)
    with one_rank_mesh(tmp_path) as mesh:
        ctx = TS.make_ctx(mesh)
        assert ctx.mesh is mesh and ctx.shape == {"data": 1, "model": 1}
        x = torch.arange(12.0).reshape(3, 4)
        assert torch.equal(ctx.constrain(x, "data", "model"), x)
        assert torch.equal(ctx.gather(x, "data", "model"), x)
        assert torch.equal(ctx.psum(x, ("data", "model")), x)
        model = Model(cfg, torch.Generator().manual_seed(0), "cpu")
        block = model.stack.layers[0]
        want = {n: p.detach().clone() for n, p in block.named_parameters()}
        TS.shard_model(model, cfg, ctx)
        assert all(isinstance(p, DTensor) for p in model.parameters())
        got = TS.fsdp_gather(block, cfg, ctx)
        assert got["attn"]["wq"].shape == want["attn.wq"].shape
        for n, w in want.items():
            node = got
            for part in n.split("."):
                node = node[part]
            assert not isinstance(node, DTensor) and torch.equal(node, w), n


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# collectives: the JAX package on 8 fake devices against 4 gloo ranks
# ---------------------------------------------------------------------------

JAX_SIDE = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint.store import CheckpointStore
    from repro.core.compat import make_auto_mesh
    from repro.core.staging import device_replicate, staged_restore
    from repro.launch.mesh import make_mesh
    from repro.train import compression as C
    d = sys.argv[1]
    data = dict(np.load(d + "/in.npz"))
    x = data["x"]
    out = {}
    mesh = make_auto_mesh((4, 2), ("data", "model"))
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    out["replicate"] = device_replicate(mesh, xs, "data")
    shards = {int(k.split("_")[1]): data[k] for k in data
              if k.startswith("shard_")}
    out["staged_restore"] = staged_restore(mesh, shards, "data")
    for name in ("x", "halves"):
        out["q_" + name], out["scale_" + name] = C.quantize_int8(data[name])
    out["cr_q"], out["cr_scale"], out["cr_err"] = C.compress_residual(
        data["g_w"], data["e_w"])
    pods = make_mesh((2,), ("pod",))
    out["psum_same"] = C.compressed_psum(x, pods, "pod")
    grads = {"w": data["g_w"], "b": {"c": data["g_c"]}}
    errors = {"w": data["e_w"], "b": {"c": data["e_c"]}}
    red, err = C.compressed_grad_allreduce(grads, errors, pods, "pod")
    out.update(red_w=red["w"], red_c=red["b"]["c"], err_w=err["w"],
               err_c=err["b"]["c"])
    store = CheckpointStore(d + "/ckpt")
    tree = {"w": data["w"]}
    for name, shape, axes, spec in (
            ("restore4", (4,), ("data",), P("data")),
            ("restore2x2", (2, 2), ("data", "model"), P("data", "model")),
            ("restore8", (8,), ("data",), P("data"))):
        back = store.restore_resharded(tree, make_mesh(shape, axes),
                                       {"w": spec})["w"]
        out[name + "_full"] = back
        for s in back.addressable_shards:
            out[f"{name}_dev{s.device.id}"] = s.data
    np.savez(d + "/jax.npz", **{k: np.asarray(v) for k, v in out.items()})
""")


def _inputs():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    data = {"x": x,
            "halves": np.array([127, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 126.5,
                                -127], np.float32),
            "g_w": (rng.standard_normal((32, 16)) * 0.01).astype(np.float32),
            "g_c": rng.standard_normal(7).astype(np.float32),
            "e_w": (rng.standard_normal((32, 16)) * 1e-3).astype(np.float32),
            "e_c": (rng.standard_normal(7) * 1e-2).astype(np.float32),
            "blocks": (rng.standard_normal((4, 32, 16))
                       * np.array([1, 3, 0.1, 20])[:, None, None])
            .astype(np.float32),
            "w": np.arange(64 * 16, dtype=np.float32).reshape(64, 16)}
    for i in (5, 2, 7, 0, 3, 6, 1, 4):          # keys out of order
        data[f"shard_{i}"] = x[8 * i:8 * (i + 1)]
    return data


def _run_bounded(procs, timeout):
    """Wait for every process; on the deadline kill them all and fail."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"collective processes still running after {timeout} s")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    data = _inputs()
    np.savez(d / "in.npz", **data)
    JStore(str(d / "ckpt")).save(1, {"w": data["w"]})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(d)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs += [subprocess.Popen(
        [sys.executable, WORKER, str(r), "4", str(d / "rendezvous"),
         str(d / "in.npz"), str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    _run_bounded(procs, TIMEOUT_S)
    return (data, dict(np.load(d / "jax.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(4)])


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def np_quantize(x):
    scale = np.abs(x).max() / np.float32(127.0) + np.float32(1e-12)
    return np.clip(np.rint(x / scale), -127, 127).astype(np.int8), scale


def test_device_replicate_matches_reference(runs):
    data, ref, ranks = runs
    assert same(ref["replicate"], data["x"])
    for r in ranks:
        assert same(r["replicate_data4"], ref["replicate"])
        assert same(r["replicate_data2x2"], ref["replicate"])


def test_staged_restore_matches_reference(runs):
    data, ref, ranks = runs
    assert same(ref["staged_restore"], data["x"])
    for r in ranks:
        assert same(r["staged_restore"], ref["staged_restore"])


def test_device_shard_local_blocks(runs):
    data, _, ranks = runs
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, 2)
        assert same(r["device_shard"],
                    data["x"][32 * d:32 * (d + 1), 4 * m:4 * (m + 1)])


@pytest.mark.parametrize("name", ["x", "halves"])
def test_quantize_int8_matches_reference(runs, name):
    data, ref, ranks = runs
    for r in ranks:
        assert same(r["q_" + name], ref["q_" + name])
        assert same(r["scale_" + name], ref["scale_" + name])
    q, scale = np_quantize(data[name])
    assert same(ref["q_" + name], q) and ref["scale_" + name] == scale
    if name == "halves":          # scale 1.0: ties to even, clipped at 127
        assert ref["q_halves"].tolist() == [127, 2, 4, -2, 0, 0, 2, 126,
                                            -127]


def test_compress_residual_matches_reference(runs):
    _, ref, ranks = runs
    for r in ranks:
        for k in ("cr_q", "cr_scale", "cr_err"):
            assert same(r[k], ref[k]), k


def test_compressed_psum_matches_reference(runs):
    data, ref, ranks = runs
    q, scale = np_quantize(data["x"])
    assert same(ref["psum_same"], scale * q.astype(np.float32) * 2)
    for r in ranks:
        assert same(r["psum_same"], ref["psum_same"])


def test_compressed_grad_allreduce_matches_reference(runs):
    _, ref, ranks = runs
    for r in ranks:
        for k in ("red_w", "red_c", "err_w", "err_c"):
            assert same(r[k], ref[k]), k
        assert not r["zeros_w"].any() and r["zeros_c"].dtype == np.float32


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_of_distinct_blocks(runs, n):
    data, _, ranks = runs
    blocks = data["blocks"][:n]
    parts = [np_quantize(b) for b in blocks]
    want = parts[0][1] * parts[0][0].astype(np.float32)
    for q, scale in parts[1:]:
        want = want + scale * q.astype(np.float32)
    for r in ranks:
        assert same(r[f"psum_distinct{n}"], want)


@pytest.mark.parametrize("name,grid", [("restore4", (4, 1)),
                                       ("restore2x2", (2, 2))])
def test_restore_resharded_matches_reference(runs, name, grid):
    data, ref, ranks = runs
    w = data["w"]
    assert same(ref[name + "_full"], w) and same(ref["restore8_full"], w)
    rows, cols = w.shape[0] // grid[0], w.shape[1] // grid[1]
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, grid[1])
        block = w[rows * d:rows * (d + 1), cols * m:cols * (m + 1)]
        assert same(r[name + "_local"], block)
        assert same(r[name + "_local"], ref[f"{name}_dev{rank}"])
        assert same(r[name + "_full"], w)
