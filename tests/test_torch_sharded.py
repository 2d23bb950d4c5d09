"""The port's sharded train step, expert-parallel MoE, pod branch, sharded
prefill and launcher over a gloo group of 4 CPU ranks.

Each run starts its 4 ranks together (tests/torch_sharded_worker.py, or the
launcher) with a ``file://`` rendezvous under ``tmp_path``, and kills them
all at 240 s. Compared as max |diff| over max |reference| unless said:

* (a) one train step of each of the seven smoke configs on a (2, 2)
  ("data", "model") mesh against the port's one-process step from the same
  weights: the loss within 1e-5, every grad leaf within 1e-4, the grad norm
  within 1e-5 and the parameters after the step within 1e-4 normwise (over
  the whole model: Adam's first step moves an element by lr g / (|g| +
  eps), so a zero-initialised leaf whose grads hold elements near eps,
  zamba2's ``loras.0.b_k``, differs by a few 1e-4 in its own norm between
  two float32 summation orders; its grads agree within 1e-5). The MoE
  configs' one-process step takes the reference's sharded aux (each data
  shard's Switch loss, averaged), not the whole batch's. qwen3-32b also in
  2 microbatches (consecutive rows, each cut over the data axis);
* (b) qwen3-32b, qwen3-moe-30b-a3b and zamba2-7b against the JAX package's
  sharded step on a (2, 2) mesh of 4 fake devices (as
  tests/test_distributed.py runs it), on the reference's weights through
  ``params_from_jax``: the loss within 1e-5, the grad norm within 1e-4;
* (c) qwen3-32b and qwen3-moe-30b-a3b (the experts' capacity counts every
  position, not this rank's block) with ``sequence_parallel`` against the
  one-process step, as (a), and against (a)'s loss;
* (d) the expert-parallel MoE layer (its experts laid onto the mesh) against
  the reference's ``_moe_ffn_shardmap``: out within 1e-5, aux within 1e-6,
  on two inputs whose sharded aux differs from the whole batch's;
* (e) the compressed-DCN pod branch, two steps of qwen3-32b: on (4, 1, 1)
  bit for bit equal to its one-process arithmetic (each pod's grads, the
  int8 hop as the reference's ``pod_body`` computes it, one quantization
  of each pod's whole leaf and the payloads summed in pod order, the clip,
  AdamW): losses, grad norms, parameters and pod 0's ``dcn_error``; on (2,
  1, 2), where each block is quantized with its whole leaf's scale, the
  losses within 1e-5, the grad norms within 1e-5 and the parameters within
  1e-4 normwise. That one-process hop agrees with the reference's on the
  reference's per-pod grads (the reduced grads within 1e-6, the errors
  within 3e-5 of the scale: XLA rounds its multiply-adds once), and on
  (2, 1, 2) from the reference's weights the branch follows the
  reference's per-pod grads, hop, clip and AdamW over two steps: the
  losses within 1e-5, the grad norms within 1e-4, the parameters within
  1e-4 normwise;
* (f) the sharded prefill of qwen3-32b (kv heads repeated over tp) and
  zamba2-7b against the unsharded one: logits and every cache within 1e-5,
  each rank holding only its blocks of the caches;
* (g) the launcher over 4 processes, ``--mesh 2x2`` (12 steps with a node
  failure before step 11, restored from the step-10 checkpoint that rank 0
  alone wrote, its blocks gathered to rank 0 alone; every loss within 1e-5
  of the one-process launcher's, the restart included) and ``--mesh 2x1x2
  --compress-dcn`` (the first loss within 1e-5: the later ones follow the
  int8 grads); a mesh without a checkpoint directory raises.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import registry as jax_registry
from repro.models import model as JM

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")
TIMEOUT_S = 240
ARCHS = ["qwen3_32b", "internvl2_2b", "hubert_xlarge", "qwen3_moe_30b_a3b",
         "deepseek_v2_lite_16b", "zamba2_7b", "rwkv6_3b"]
JAX_ARCHS = ["qwen3_32b", "qwen3_moe_30b_a3b", "zamba2_7b"]


def _run_bounded(procs, timeout):
    """Wait for every process; on the deadline kill them all and fail."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"processes still running after {timeout} s")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", **extra)


def _workers(d, cases):
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), "4", str(d / "rendezvous"), str(d),
         cases], env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-30))


def normwise(pairs):
    """||a - b|| / ||b|| over every pair's elements together."""
    num = sum(float(np.sum((np.asarray(a, np.float64) - b) ** 2))
              for a, b in pairs)
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for _, b in pairs)
    return (num / den) ** 0.5


def side(res, key, which):
    """{name: array} of ``key/which/...`` in a worker's results."""
    pre = f"{key}/{which}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    _run_bounded(_workers(d, "steps,pod,prefill"), TIMEOUT_S)
    return {c: dict(np.load(d / f"port_{c}.npz"))
            for c in ("steps", "pod", "prefill")}


# ---------------------------------------------------------------------------
# (a), (c): one sharded step against the one-process step
# ---------------------------------------------------------------------------

def _check_step(res, key):
    s, r = side(res, key, "sharded"), side(res, key, "ref")
    assert rel(s["loss"], r["loss"]) < 1e-5
    assert rel(s["grads_loss"], r["grads_loss"]) < 1e-5
    assert rel(s["grad_norm"], r["grad_norm"]) < 1e-5
    grads = [k for k in r if k.startswith("grad/")]
    assert grads and sorted(grads) == sorted(k for k in s
                                             if k.startswith("grad/"))
    for k in grads:
        assert rel(s[k], r[k]) < 1e-4, k
    params = [k for k in r if k.startswith("param/")]
    assert params and sorted(params) == sorted(k for k in s
                                               if k.startswith("param/"))
    assert normwise([(s[k], r[k]) for k in params]) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_process(port_runs, arch):
    _check_step(port_runs["steps"], arch)


def test_sharded_microbatches_match_one_process(port_runs):
    """2 microbatches of consecutive rows, each cut over the data axis."""
    _check_step(port_runs["steps"], "qwen3_32b_mb2")


def test_microbatch_rows_that_do_not_split_match_one_process(port_runs):
    """4 microbatches of one row each: a row does not split over the data
    axis's 2 ranks, so both hold it (the reference's ``input_pspecs``
    rule), and the loss and grads are still the batch's."""
    _check_step(port_runs["steps"], "qwen3_32b_mb4")


@pytest.mark.parametrize("arch", ["qwen3_32b", "qwen3_moe_30b_a3b"])
def test_sequence_parallel_step_matches_one_process(port_runs, arch):
    res = port_runs["steps"]
    _check_step(res, arch + "_sp")
    assert rel(res[arch + "_sp/sharded/loss"],
               res[arch + "/sharded/loss"]) < 1e-5


# ---------------------------------------------------------------------------
# (e): the pod branch
# ---------------------------------------------------------------------------

def test_pod_branch_on_4x1x1_is_the_one_process_arithmetic(port_runs):
    res = port_runs["pod"]
    s, r = side(res, "4x1x1", "sharded"), side(res, "4x1x1", "ref")
    assert sorted(s) == sorted(r) and any(k.startswith("dcn_error/")
                                          for k in r)
    for k in r:
        assert s[k].dtype == r[k].dtype and np.array_equal(s[k], r[k]), k
    assert any(r[k].any() for k in r if k.startswith("dcn_error/"))


def test_pod_branch_on_2x1x2_within_tolerance(port_runs):
    res = port_runs["pod"]
    s, r = side(res, "2x1x2", "sharded"), side(res, "2x1x2", "ref")
    for i in range(2):
        assert rel(s[f"loss{i}"], r[f"loss{i}"]) < 1e-5
        assert rel(s[f"grad_norm{i}"], r[f"grad_norm{i}"]) < 1e-5
    params = [k for k in r if k.startswith("param/")]
    assert normwise([(s[k], r[k]) for k in params]) < 1e-4


# ---------------------------------------------------------------------------
# (f): the sharded prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_32b", "zamba2_7b"])
def test_sharded_prefill_matches_unsharded(port_runs, arch):
    res = port_runs["prefill"]
    s, r = side(res, arch, "sharded"), side(res, arch, "ref")
    assert sorted(s) == sorted(r) and len(r) > 4
    for k in r:
        assert s[k].shape == r[k].shape, k
        assert rel(s[k], r[k]) < 1e-5 or not r[k].any() and not s[k].any(), k


@pytest.mark.parametrize("arch", ["qwen3_32b", "zamba2_7b"])
def test_sharded_prefill_hands_back_blocks(port_runs, arch):
    """The sharded prefill gathers no cache: each rank holds its block of
    every leaf in the decode's layout (``cache_pspecs``), the whole over
    the ranks that layout splits it over; the kv caches split over both
    axes (2 rows over data, the kv heads over model)."""
    res = port_runs["prefill"]
    blocks = {k: v for k, v in res.items()
              if k.startswith(f"{arch}/blocks/")}
    assert blocks
    for k, (local, whole, ranks) in blocks.items():
        assert local * ranks == whole, k
    kv = [v for k, v in blocks.items() if k.endswith(("/k", "/v"))]
    assert kv and all(ranks == 4 for _, _, ranks in kv)


# ---------------------------------------------------------------------------
# (b), (d): against the JAX package on 4 fake devices
# ---------------------------------------------------------------------------

JAX_SIDE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.distributed.sharding import make_ctx, param_pspecs
    from repro.launch.mesh import make_mesh
    from repro.models import moe as MOE
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import make_train_step
    d = sys.argv[1]
    data = dict(np.load(d + "/jax_in.npz"))

    def tree(prefix):
        t = {}
        for k, v in data.items():
            if k.startswith(prefix):
                node = t
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        return t
    mesh = make_mesh((2, 2), ("data", "model"))
    ctx = make_ctx(mesh)
    opt = OptConfig(total_steps=10, warmup_steps=2)
    out = {}
    for arch in sys.argv[2].split(","):
        cfg = get_smoke_config(arch)
        params = tree(arch + "/params/")
        sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                          param_pspecs(cfg, params, ctx),
                          is_leaf=lambda x: isinstance(x, P))
        params = jax.tree.map(jax.device_put, params, sh)
        toks = data[arch + "/tokens"]
        B, S = toks.shape
        batch = {"tokens": jnp.asarray(toks),
                 "labels": jnp.asarray(data[arch + "/labels"])}
        step = jax.jit(make_train_step(
            cfg, ShapeConfig("s", "train", S, B, 1, True), opt, ctx=ctx))
        _, _, m = step(params, init_opt_state(params), batch)
        out[arch + "/loss"] = np.asarray(m["loss"])
        out[arch + "/grad_norm"] = np.asarray(m["grad_norm"])
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    mp = jax.tree.map(lambda a: a[0], tree(
        "qwen3_moe_30b_a3b/params/")["stack"]["layers"]["moe"])
    for name in ("x_spread", "x_skewed"):
        x = jnp.asarray(data["moe/" + name])
        y, aux = jax.jit(lambda p, x: MOE._moe_ffn_shardmap(
            p, cfg, x, ctx, False))(mp, x)
        out[f"moe/{name}/out"] = np.asarray(y)
        out[f"moe/{name}/aux"] = np.asarray(aux)
        out[f"moe/{name}/aux_whole"] = np.asarray(MOE.moe_ffn(mp, cfg, x)[1])

    # the pod branch, two steps of qwen3-32b over 2 pods: each pod's
    # grads, the int8 hop as pod_body computes it, the clip, AdamW
    from repro.train import compression as comp
    from repro.train.optimizer import adamw_update, clip_by_global_norm
    from repro.train.train_step import grads_and_loss

    def put(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                put(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = np.asarray(v)
    cfg = get_smoke_config("qwen3_32b")
    params = tree("qwen3_32b/params/")
    state = init_opt_state(params)
    n_pod = 2
    B, S = data["pod/tokens0"].shape
    rows = B // n_pod
    pod_grads = jax.jit(lambda p, b: grads_and_loss(
        p, cfg, b, ShapeConfig("s", "train", S, rows, 1, True), None)[:2])

    @jax.jit
    def hop(gs, es):
        qs, ss, new_es = [], [], []
        for g, e in zip(gs, es):
            tgt = g + e
            q, scale = comp.quantize_int8(tgt)
            new_es.append(tgt - comp.dequantize_int8(q, scale))
            qs.append(q)
            ss.append(scale)
        red = jnp.tensordot(jnp.stack(ss), jnp.stack(qs).astype(jnp.float32),
                            axes=(0, 0))
        return red / n_pod, new_es

    @jax.jit
    def update(p, g, s):
        g, gnorm = clip_by_global_norm(g, opt.grad_clip)
        p, s, _ = adamw_update(p, g, s, opt)
        return p, s, gnorm
    errs = [jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
            for _ in range(n_pod)]
    for i in range(2):
        per = [pod_grads(params, {
            k: jnp.asarray(data[f"pod/{k}{i}"][j * rows:(j + 1) * rows])
            for k in ("tokens", "labels")}) for j in range(n_pod)]
        tdef = jax.tree.structure(per[0][0])
        flat_g = [jax.tree.leaves(g) for g, _ in per]
        flat_e = [jax.tree.leaves(e) for e in errs]
        outs = [hop([f[l] for f in flat_g], [f[l] for f in flat_e])
                for l in range(len(flat_g[0]))]
        red = jax.tree.unflatten(tdef, [o[0] for o in outs])
        errs = [jax.tree.unflatten(tdef, [o[1][j] for o in outs])
                for j in range(n_pod)]
        if i == 0:
            for j in range(n_pod):
                put(per[j][0], f"pod/g0/pod{j}/")
                put(errs[j], f"pod/err0/pod{j}/")
            put(red, "pod/red0/")
        params, state, gnorm = update(params, red, state)
        out[f"pod/loss{i}"] = np.asarray((per[0][1] + per[1][1]) / n_pod)
        out[f"pod/grad_norm{i}"] = np.asarray(gnorm)
    put(params, "pod/params/")
    np.savez(d + "/jax.npz", **out)
""")


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_jax")
    data = {}
    for arch in JAX_ARCHS:
        cfg = jax_registry.get_smoke_config(arch)
        params = jax.jit(JM.init_model, static_argnums=1)(
            jax.random.PRNGKey(0), cfg)
        _flat(jax.tree.map(np.asarray, params), arch + "/params/", data)
        rng = np.random.default_rng(3)
        for k in ("tokens", "labels"):
            data[f"{arch}/{k}"] = rng.integers(0, cfg.vocab,
                                               (4, 32)).astype(np.int32)
    rng = np.random.default_rng(6)
    for i in range(2):
        for k in ("tokens", "labels"):
            data[f"pod/{k}{i}"] = rng.integers(
                0, jax_registry.get_smoke_config("qwen3_32b").vocab,
                (8, 16)).astype(np.int32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 128)).astype(np.float32)
    skewed = x.copy()
    skewed[:2] += 2.0 * rng.standard_normal(128).astype(np.float32)
    data["moe/x_spread"], data["moe/x_skewed"] = x, skewed
    np.savez(d / "jax_in.npz", **data)
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(d), ",".join(JAX_ARCHS)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += _workers(d, "jax")
    _run_bounded(procs, TIMEOUT_S)
    return dict(np.load(d / "jax.npz")), dict(np.load(d / "port_jax.npz"))


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_sharded_step_matches_reference(jax_runs, arch):
    ref, port = jax_runs
    assert rel(port[arch + "/loss"], ref[arch + "/loss"]) < 1e-5
    assert rel(port[arch + "/grad_norm"], ref[arch + "/grad_norm"]) < 1e-4


@pytest.mark.parametrize("name", ["x_spread", "x_skewed"])
def test_expert_parallel_moe_matches_reference(jax_runs, name):
    ref, port = jax_runs
    key = f"moe/{name}/"
    assert rel(port[key + "out"], ref[key + "out"]) < 1e-5
    assert rel(port[key + "aux"], ref[key + "aux"]) < 1e-6
    # the sharded aux is not the whole batch's, and the port follows it
    assert rel(ref[key + "aux"], ref[key + "aux_whole"]) > 1e-3


def _tree_of(res, prefix):
    """The nested dict of the arrays under ``prefix`` in a result."""
    tree = {}
    for k, v in res.items():
        if k.startswith(prefix):
            node = tree
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


def test_pod_hop_arithmetic_matches_reference(jax_runs):
    """The one-process hop that (e) holds the pod branch to bit for bit,
    on the reference's per-pod grads of step 1, against the reference's
    pod_body hop on them: the reduced grads within 1e-6 (max |diff| over
    max |ref|) and each pod's new error within 3e-5 of its leaf's scale.
    Not bit for bit: XLA's jitted CPU code fuses the contraction's and the
    error's multiply and add into one rounding (an fma), where PyTorch
    rounds the product first, and its scale is an ulp off on some leaves
    (1 in 13 random ones); each moves an error by up to 127 * 2^-24 of the
    scale. A payload off by one would move its element by half a scale,
    0.4% of the leaf's largest."""
    import torch
    from torch_parity import int8_pod_hop
    ref, _ = jax_runs
    pods = [{k: torch.from_numpy(v) for k, v in side(
        ref, "pod/g0", f"pod{j}").items()} for j in range(2)]
    zeros = [{k: torch.zeros_like(v) for k, v in p.items()} for p in pods]
    red, errs = int8_pod_hop(pods, zeros)
    want = side(ref, "pod", "red0")
    assert sorted(red) == sorted(want) and len(want) > 4
    for k, v in want.items():
        assert v.any() and rel(red[k].numpy(), v) < 1e-6, k
    for j in range(2):
        for k, v in side(ref, "pod/err0", f"pod{j}").items():
            scale = float(pods[j][k].abs().max()) / 127
            assert v.any() and float(np.abs(errs[j][k].numpy() - v).max()) \
                < 3e-5 * scale, k


def test_pod_branch_matches_reference(jax_runs):
    """(e) on (2, 1, 2) from the reference's weights, two steps, against
    the reference's per-pod grads, int8 hop, clip and AdamW: the losses
    within 1e-5, the grad norms within 1e-4, the parameters after the
    second step within 1e-4 normwise."""
    from repro_torch.configs import registry
    from repro_torch.models.convert import params_from_jax
    ref, port = jax_runs
    for i in range(2):
        assert rel(port[f"pod/loss{i}"], ref[f"pod/loss{i}"]) < 1e-5
        assert rel(port[f"pod/grad_norm{i}"], ref[f"pod/grad_norm{i}"]) < 1e-4
    cfg = registry.get_smoke_config("qwen3_32b")
    want = {n: p.detach().float().numpy() for n, p in params_from_jax(
        cfg, _tree_of(ref, "pod/params/"), device="cpu").named_parameters()}
    got = side(port, "pod", "param")
    assert sorted(got) == sorted(want)
    assert normwise([(got[n], want[n]) for n in want]) < 1e-4


# ---------------------------------------------------------------------------
# (g): the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["-m", "repro_torch.launch.train", "--arch", "qwen3-32b", "--smoke",
          "--device", "cpu", "--batch", "4", "--seq", "32"]
RUNS = {"2x2": ["--steps", "12", "--fail-at", "11"],
        "2x1x2-compress-dcn": ["--steps", "3", "--compress-dcn"]}


@pytest.fixture(scope="module")
def launcher_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("launcher")
    procs = []
    for name, args in RUNS.items():
        mesh = name.split("-")[0]
        procs += [subprocess.Popen(
            [sys.executable, *LAUNCH, *args, "--mesh", mesh,
             "--init-method", f"file://{d}/rdzv_{name}",
             "--ckpt-dir", str(d / f"ckpt_{name}"),
             "--report", str(d / f"{name}.json")],
            env=_env(RANK=str(r), WORLD_SIZE="4"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(4)]
        procs.append(subprocess.Popen(
            [sys.executable, *LAUNCH, *[a for a in args
                                         if a != "--compress-dcn"],
             "--ckpt-dir", str(d / f"ckpt_{name}_one"),
             "--report", str(d / f"{name}_one.json")],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    _run_bounded(procs, TIMEOUT_S)
    return d, {n: (json.load(open(d / f"{n}.json")),
                   json.load(open(d / f"{n}_one.json"))) for n in RUNS}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_launcher_on_a_mesh_matches_one_process(launcher_runs, name):
    _, runs = launcher_runs
    sharded, one = runs[name]
    assert len(sharded["losses"]) == len(one["losses"]) > 1
    assert rel(sharded["losses"][0], one["losses"][0]) < 1e-5
    if "compress" not in name:        # int8 grads move the later steps
        for a, b in zip(sharded["losses"], one["losses"]):
            assert rel(a, b) < 1e-5


def test_launcher_on_a_mesh_needs_a_checkpoint_directory():
    """Each rank would make a temporary store of its own, and only rank 0's
    would hold the checkpoint: a mesh without ``ckpt_dir`` raises before
    it joins a process group."""
    import torch.distributed as dist
    from repro_torch.launch import train as launch_train
    with pytest.raises(ValueError, match="ckpt_dir"):
        launch_train.main(arch="qwen3-32b", smoke=True, steps=1, batch=2,
                          seq=8, device="cpu", mesh="2x2")
    assert not dist.is_initialized()


def test_launcher_restarts_from_the_sharded_checkpoint(launcher_runs):
    d, runs = launcher_runs
    sharded, one = runs["2x2"]
    assert sharded["restarts"] == one["restarts"] == 1
    assert sharded["checkpoints"] == [10]
    # rank 0 alone wrote it: one set of objects, readable by the store
    ckpt = d / "ckpt_2x2" / "step_00000010"
    meta = json.load(open(ckpt / "meta.json"))
    assert "0/stack.layers.0.attn.wq" in meta["leaves"]
    assert meta["leaves"]["0/stack.layers.0.attn.wq"]["shape"] == [128, 128]
    assert rel(sharded["losses"][-1], one["losses"][-1]) < 1e-5
