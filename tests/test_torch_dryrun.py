"""The port's dry run (`repro_torch.launch.dryrun`), its cost counter
(`repro_torch.distributed.op_cost`) and the kernel ops' fake
implementations and FLOP formulas, against the JAX package where it has a
counterpart.

Every cell here runs on a fake process group in this process (destroyed
after each test); the reference's side runs in a subprocess on fake host
devices, as tests/test_roofline.py runs it, killed at 240 s:

* (a) ``OpCost``'s collective bytes of an all-gather, a reduce-scatter, an
  all-reduce and an all-to-all over each axis of (2, 2) and (2, 1, 2)
  meshes equal ``hlo_cost.analyze_hlo_text``'s of the same collectives in
  a ``shard_map``, on-pod and cross-pod split included, exactly;
* (b) the per-rank argument bytes of the smoke configs' train, prefill and
  decode cells on a (2, 2) mesh equal XLA's ``memory_analysis()
  .argument_size_in_bytes`` of the reference's steps jitted with the same
  ``param_pspecs`` / ``input_pspecs`` / ``cache_pspecs`` shardings and
  ``keep_unused`` (every argument handed to the step counts, as in the
  port: XLA would otherwise drop the vision frontend's weights from a
  decode step), each leaf's block equal too (a leaf that differs is
  named);
* (c) the matmul FLOPs of a smoke prefill and train step equal a closed
  form of the config; on fake CUDA tensors each kernel op gives its
  outputs' shapes and its formula's FLOPs with no build and no launch;
* the depth extrapolation and the traced microbatch equal the whole trace;
* (e) ``dryrun.main`` end to end on smoke configs over small fake meshes;
* (f) full-size cells that trace in under a minute here: qwen3-moe-30b-a3b
  ``train_4k --multi-pod`` and zamba2-7b ``long_500k``, whose per-rank
  caches follow the reference's ``cache_pspecs``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig, padded_vocab
from repro_torch.distributed.op_cost import OpCost
from repro_torch.distributed.sharding import _ref_path, make_ctx
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hedm_reduce as hr
from repro_torch.kernels import mamba2_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_wkv as wk
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 240
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
ARG_ARCHS = ["qwen3_32b", "internvl2_2b", "hubert_xlarge", "zamba2_7b",
             "rwkv6_3b", "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"]
ARG_SHAPES = {"train": ShapeConfig("t", "train", 32, 8, 2, True),
              "prefill": ShapeConfig("p", "prefill", 32, 4),
              "decode": ShapeConfig("d", "decode", 64, 4)}


@pytest.fixture(autouse=True)
def _no_group_left():
    """Each test's fake default group is destroyed after it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **extra)


def _jax(code, *args, devices=4):
    return subprocess.Popen(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count="
                           f"{devices}", JAX_PLATFORMS="cpu"))


def _wait_json(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"the JAX side still ran after {TIMEOUT_S} s")
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# (a) collective bytes against hlo_cost
# ---------------------------------------------------------------------------

JAX_COLLECTIVES = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core.compat import shard_map
    from repro.distributed.hlo_cost import analyze_hlo_text
    from repro.launch.mesh import make_mesh
    MESHES = {"2x2": ((2, 2), ("data", "model")),
              "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
    out = {}
    for tag, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes)
        n_pods = mesh.shape.get("pod", 1)
        for axis in [a for a in axes if mesh.shape[a] > 1]:
            for kind in ("all-gather", "reduce-scatter", "all-reduce",
                         "all-to-all"):
                def body(x, kind=kind, axis=axis):
                    if kind == "all-gather":
                        return jax.lax.all_gather(x, axis, axis=0, tiled=True)
                    if kind == "reduce-scatter":
                        return jax.lax.psum_scatter(x, axis,
                                                    scatter_dimension=0,
                                                    tiled=True)
                    if kind == "all-reduce":
                        return jax.lax.psum(x, axis)
                    return jax.lax.all_to_all(x, axis, 0, 0, tiled=True)
                f = shard_map(body, mesh=mesh, in_specs=P(axes),
                              out_specs=P(axes), check_vma=False)
                x = jax.ShapeDtypeStruct((8 * mesh.size, 16), jnp.float32)
                txt = jax.jit(f).lower(x).compile().as_text()
                c = analyze_hlo_text(txt, mesh.size, n_pods=n_pods)
                out[f"{tag}/{axis}/{kind}"] = {
                    "on_pod": c.ici_collective_bytes,
                    "cross_pod": c.dcn_collective_bytes,
                    "collectives": dict(c.collective_breakdown)}
    print(json.dumps(out))
""")


def _port_collective(kind, axis, ctx):
    """One collective of a (8, 16) float32 block over ``axis``, as the
    port's ``ShardCtx`` issues it (the all-to-all through
    ``all_to_all_single``)."""
    x = torch.empty(8, 16)
    if kind == "all-gather":
        return ctx.gather(x, axis)
    if kind == "reduce-scatter":
        return ctx.reduce_scatter(x, 0, axis)
    if kind == "all-reduce":
        return ctx.psum(x, axis)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ctx.group(axis))
    return out


def test_collective_bytes_equal_hlo_cost():
    proc = _jax(JAX_COLLECTIVES)
    port = {}
    for tag, (shape, axes) in MESHES.items():
        dryrun.fake_group(4)
        ctx = make_ctx(make_mesh(shape, axes, "cpu"))
        for axis in [a for a in axes if ctx.shape[a] > 1]:
            for kind in KINDS:
                with FakeTensorMode():
                    with OpCost(n_pods=ctx.shape.get("pod", 1)) as cost:
                        _port_collective(kind, axis, ctx)
                port[f"{tag}/{axis}/{kind}"] = {
                    "on_pod": cost.on_pod_collective_bytes,
                    "cross_pod": cost.cross_pod_collective_bytes,
                    "collectives": dict(cost.collectives)}
        dist.destroy_process_group()
    ref = _wait_json(proc)
    assert sorted(port) == sorted(ref) and len(ref) == 16
    assert any(v["cross_pod"] for v in ref.values())
    for k, r in ref.items():
        assert port[k] == r, (k, port[k], r)


# ---------------------------------------------------------------------------
# (b) per-rank argument bytes against XLA's
# ---------------------------------------------------------------------------

JAX_ARGUMENTS = textwrap.dedent("""
    import functools, json, sys
    import jax, jax.numpy as jnp
    jax.devices()
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.distributed.sharding import (cache_pspecs, input_pspecs,
                                            make_ctx, param_pspecs)
    from repro.launch.dryrun import input_specs
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.serve import engine
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import make_train_step
    SHAPES = {"train": ShapeConfig("t", "train", 32, 8, 2, True),
              "prefill": ShapeConfig("p", "prefill", 32, 4),
              "decode": ShapeConfig("d", "decode", 64, 4)}
    mesh = make_mesh((2, 2), ("data", "model"))
    ctx = make_ctx(mesh)

    def sh(specs):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    def leaves(tree, shards, prefix, out):
        for (path, l), s in zip(
                jax.tree_util.tree_flatten_with_path(tree)[0],
                jax.tree.leaves(shards)):
            name = prefix + "/".join(
                str(getattr(p, "key", getattr(p, "name", getattr(
                    p, "idx", p)))) for p in path)
            n = 1
            for d in s.shard_shape(l.shape):
                n *= d
            out[name] = out.get(name, 0) + n * jnp.dtype(l.dtype).itemsize
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_smoke_config(arch)
        params = jax.eval_shape(functools.partial(M.init_model, cfg=cfg),
                                jax.random.PRNGKey(0))
        p_sh = sh(param_pspecs(cfg, params, ctx))
        for kind, shape in SHAPES.items():
            if kind == "decode" and not cfg.causal:
                continue
            ins = input_specs(cfg, shape)
            in_sh = sh(input_pspecs(cfg, shape, ctx))
            per = {}
            leaves(params, p_sh, "params/", per)
            if kind == "train":
                opt = jax.eval_shape(init_opt_state, params)
                o_sh = sh({"step": P(), "master": param_pspecs(
                    cfg, params, ctx), "m": param_pspecs(cfg, params, ctx),
                    "v": param_pspecs(cfg, params, ctx)})
                step = make_train_step(cfg, shape, OptConfig(), ctx=ctx)
                low = jax.jit(step, in_shardings=(p_sh, o_sh, in_sh),
                              donate_argnums=(0, 1), keep_unused=True).lower(
                    params, opt, ins)
                leaves(opt, o_sh, "opt_state/", per)
                leaves(ins, in_sh, "inputs/", per)
            elif kind == "prefill":
                def pf(p, i):
                    return engine.prefill_step(p, cfg, i,
                                               capacity=shape.seq_len,
                                               ctx=ctx)
                low = jax.jit(pf, in_shardings=(p_sh, in_sh),
                              keep_unused=True).lower(params, ins)
                leaves(ins, in_sh, "inputs/", per)
            else:
                caches = jax.eval_shape(functools.partial(
                    M.init_decode_state, cfg, shape.global_batch,
                    shape.seq_len))
                c_sh = sh(cache_pspecs(cfg, caches, ctx))

                def dc(p, t, c):
                    return M.decode_step(p, cfg, t, c)
                low = jax.jit(dc, in_shardings=(
                    p_sh, in_sh["tokens"], c_sh), donate_argnums=(2,),
                    keep_unused=True).lower(params, ins["tokens"], caches)
                leaves({"tokens": ins["tokens"]}, {"tokens": in_sh["tokens"]},
                       "inputs/", per)
                leaves(caches, c_sh, "caches/", per)
            mem = low.compile().memory_analysis()
            out[f"{arch}/{kind}"] = {
                "argument_bytes": int(mem.argument_size_in_bytes),
                "leaves": per}
    print(json.dumps(out))
""")


def _port_leaves(arch, kind):
    """The port's per-rank argument bytes of a smoke cell on (2, 2), by
    the reference's leaf (per-layer blocks summed into their stack)."""
    low, _ = dryrun.lower_cell(arch, kind, False, device="cpu", smoke=True,
                               mesh_shape=(2, 2), shape=ARG_SHAPES[kind])
    per = {}
    for path, n in dryrun.argument_leaves(low).items():
        head, _, rest = path.partition("/")
        if head == "opt_state" and "/" in rest:
            sub, _, rest = rest.partition("/")
            head = f"{head}/{sub}"
        name = f"{head}/{_ref_path(rest)[0]}"
        per[name] = per.get(name, 0) + n
    return per


@pytest.fixture(scope="module")
def jax_arguments():
    return _wait_json(_jax(JAX_ARGUMENTS, ",".join(ARG_ARCHS)))


@pytest.mark.parametrize("arch", ARG_ARCHS)
def test_argument_bytes_equal_xla(jax_arguments, arch):
    for kind in ARG_SHAPES:
        key = f"{arch}/{kind}"
        if key not in jax_arguments:
            continue
        ref = jax_arguments[key]
        port = _port_leaves(arch, kind)
        dist.destroy_process_group()
        differ = {k: (port.get(k), ref["leaves"].get(k))
                  for k in set(port) | set(ref["leaves"])
                  if port.get(k) != ref["leaves"].get(k)}
        assert not differ, (key, differ)
        assert sum(port.values()) == ref["argument_bytes"], key


# ---------------------------------------------------------------------------
# (c) FLOPs: closed forms and the kernel ops on fake CUDA tensors
# ---------------------------------------------------------------------------

def _dense_flops(cfg, B, S, kind):
    """Matmul FLOPs of the plain CPU program of a dense GQA config on one
    rank: the projections, the dense attention scores and values over all
    S x S pairs (the CPU paths' einsums), the SwiGLU MLP, and the logits
    (the last position in prefill, S - 1 positions in the train step's
    CE). The train step runs every block and CE chunk forward, again under
    remat, and backward (two products a product): 4 x its forward, less
    each block's last product (``w_down``), which the recompute of a
    non-reentrant checkpoint stops before (backward needs its input, not
    its output)."""
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    V = padded_vocab(cfg.vocab)
    per_token = 2 * D * (H + 2 * KV) * hd + 2 * H * hd * D + 6 * D * F
    attn = 4 * B * H * S * S * hd
    layers = cfg.n_layers * (B * S * per_token + attn)
    if kind == "prefill":
        return layers + 2 * B * D * V
    return 4 * (layers + 2 * B * (S - 1) * D * V) \
        - cfg.n_layers * 2 * B * S * F * D


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_matmul_flops_equal_closed_form(kind):
    cfg = registry.get_smoke_config("qwen3_32b")
    B, S = 4, 32
    shape = (ShapeConfig("t", "train", S, B, 2, True) if kind == "train"
             else ShapeConfig("p", "prefill", S, B))
    res = dryrun.run_cell("qwen3_32b", kind, False, save=False,
                          log=lambda s: None, device="cpu", smoke=True,
                          mesh_shape=(1, 1), shape=shape)
    assert res["op_cost"]["flops"] == _dense_flops(cfg, B, S, kind)
    assert set(res["flop_counter"]["Global"]) <= {"aten.mm", "aten.bmm"}


def test_kernel_ops_on_fake_cuda_tensors():
    """Each kernel op on fake CUDA tensors: its outputs' shapes and types,
    its formula's FLOPs under the flop counter, no build, no launch."""
    counts = (fa.flash_attention.launches, ms.mamba2_scan.launches,
              wk.rwkv6_wkv.launches, hr.hedm_reduce.launches)
    bf = torch.bfloat16
    with FakeTensorMode():
        dev = "cuda"
        q = torch.empty(1, 2048, 32, 112, dtype=bf, device=dev)
        x = torch.empty(1, 2048, 112, 64, dtype=bf, device=dev)
        dt = torch.empty(1, 2048, 112, device=dev)
        A = torch.empty(112, device=dev)
        Bm = torch.empty(1, 2048, 1, 64, dtype=bf, device=dev)
        r = torch.empty(1, 2048, 40, 64, dtype=bf, device=dev)
        w = torch.empty(1, 2048, 40, 64, device=dev)
        u = torch.empty(40, 64, device=dev)
        frames = torch.empty(4, 64, 64, device=dev)
        dark = torch.empty(64, 64, device=dev)
        with OpCost() as cost:
            o = ops.flash_attention(q, q, q)
            y, h = ops.mamba2_scan(x, dt, A, Bm, Bm)
            ow, s = ops.rwkv6_wkv(r, r, r, w, u)
            mask, n = ops.hedm_reduce(frames, dark)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, bf, "cuda")
    assert (y.shape, h.shape, h.dtype) == (x.shape, (1, 112, 64, 64),
                                           torch.float32)
    assert (ow.shape, s.shape, s.dtype) == (r.shape, (1, 40, 64, 64),
                                            torch.float32)
    assert (mask.shape, mask.dtype, n.shape, n.dtype) == (
        frames.shape, torch.uint8, (4,), torch.int32)
    by_op = cost.flops_by_op()
    assert by_op["repro_torch.flash_attention"] == 30_079_451_136
    assert by_op["repro_torch.flash_attention"] == fa.flops(1, 2048, 32, 112)
    assert by_op["repro_torch.mamba2_scan"] == ms.flops(1, 2048, 112, 64, 64)
    assert by_op["repro_torch.rwkv6_wkv"] == wk.flops(1, 2048, 40, 64)
    assert by_op["repro_torch.hedm_reduce"] == 39 * 4 * 64 * 64
    assert (fa.flash_attention.launches, ms.mamba2_scan.launches,
            wk.rwkv6_wkv.launches, hr.hedm_reduce.launches) == counts


def test_only_traced_kernel_calls_go_through_the_op():
    """``_build.traced``: a plain tensor with no dispatch mode is run (the
    wrappers launch directly, with no dispatcher op's cost); a fake tensor,
    or any dispatch mode active, is traced through the op."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import _build
    t = torch.zeros(2)
    assert not _build.traced(t, t)
    with FlopCounterMode(display=False):
        assert _build.traced(t)
    with OpCost():
        assert _build.traced(t)
    with FakeTensorMode():
        f = torch.zeros(2)
    assert _build.traced(t, f)


def test_meta_tensors_hold_and_move_nothing():
    """``OpCost`` counts no bytes and no storage for a meta tensor (the
    whole caches whose shapes the sharded prefill reads), and counts a
    real one's."""
    with FakeTensorMode():
        with OpCost() as cost:
            m = torch.zeros(1024, 1024, device="meta")
            assert (cost.bytes, cost.peak_bytes) == (0, 0)
            t = torch.zeros(1024, 1024)
        assert cost.bytes == t.numel() * 4 == cost.peak_bytes
    assert m.device.type == "meta"


@pytest.mark.parametrize("mesh,rows,partial,want", [
    ((2, 16, 16), 32, False, ("pod", "data")),
    ((2, 16, 16), 32, True, ("pod", "data")),
    ((2, 16, 16), 16, False, None),
    ((2, 16, 16), 16, True, ("data",)),
    ((2, 16, 16), 2, True, ("pod",)),
    ((2, 16, 16), 1, True, None),
    ((16, 16), 128, False, ("data",)),
    ((16, 16), 8, True, None)])
def test_row_axes_is_the_rule_of_steps_and_caches(mesh, rows, partial, want):
    """``row_axes``: the data axes a batch's rows split over, all or none
    for the serving steps and the decode caches' batch dim
    (``cache_pspecs``), the largest subset they divide for the train
    step's microbatches."""
    import types
    from repro_torch.distributed.sharding import cache_pspecs, row_axes
    from repro_torch.models.attention import init_kv_cache
    axes = ("pod", "data", "model")[3 - len(mesh):]
    ctx = make_ctx(types.SimpleNamespace(mesh_dim_names=axes, shape=mesh))
    assert row_axes(ctx, rows, partial) == want
    if not partial:
        cfg = registry.get_smoke_config("qwen3_32b")
        cache = {"layers": [init_kv_cache(cfg, rows, 64, "meta")]}
        b = cache_pspecs(cfg, cache, ctx)["layers"][0].k[0]
        assert ((b,) if isinstance(b, str) else b) == want


@pytest.mark.parametrize("S,causal,window", [
    (1, True, 0), (17, True, 0), (17, False, 0), (17, True, 5),
    (17, False, 5), (17, True, 40), (64, False, 16)])
def test_attention_pairs_count_the_mask(S, causal, window):
    q = torch.arange(S)[:, None]
    k = torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= k > q - window
    assert fa.attention_pairs(S, causal, window) == int(ok.sum())


# ---------------------------------------------------------------------------
# loops traced once, counted for all
# ---------------------------------------------------------------------------

def _counts(res):
    oc = res["op_cost"]
    return (oc["flops"], oc["bytes"], oc["on_pod_collective_bytes"],
            oc["cross_pod_collective_bytes"], oc["collectives"])


def test_one_traced_microbatch_doubled_equals_two_traced():
    """The step's 2 microbatches traced whole against one traced and
    counted twice (``OpCost.repeated``), outside the optimizer: the same
    FLOPs, bytes and collective bytes."""
    from repro_torch.train import train_step as T
    shape = ShapeConfig("t", "train", 32, 8, 2, True)
    low, _ = dryrun.lower_cell("qwen3_32b", "train", False, device="cpu",
                               smoke=True, mesh_shape=(2, 2), shape=shape)
    cfg = registry.get_smoke_config("qwen3_32b")
    params = low.arguments["params"]
    ctx = make_ctx(params.embed.table.device_mesh)
    seen = []

    def once(cost):
        def loop(mbs, body):
            seen.append(len(mbs))
            with cost.repeated(len(mbs)):
                body(mbs[0])
        return loop
    costs = []
    for make_loop in (lambda cost: None, once):
        with low.mode:
            cost = OpCost()
            with cost:
                T.grads_and_loss(params, cfg, low.inputs_whole, shape, ctx,
                                 make_loop(cost))
        costs.append(cost)
    whole, traced = costs
    assert seen == [2] and whole.flops > 0
    assert (whole.flops, whole.bytes, whole.on_pod_collective_bytes,
            dict(whole.collectives)) == (
        traced.flops, traced.bytes, traced.on_pod_collective_bytes,
        dict(traced.collectives))


@pytest.mark.parametrize("arch", ["qwen3_32b", "zamba2_7b",
                                  "deepseek_v2_lite_16b", "rwkv6_3b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_depth_extrapolation_equals_whole_trace(arch, kind):
    """The counts solved per kind of layer from shallow variants and
    extrapolated equal the whole stack's trace exactly."""
    shape = {"train": ShapeConfig("t", "train", 32, 8, 2, True),
             "prefill": ShapeConfig("p", "prefill", 16, 4),
             "decode": ShapeConfig("d", "decode", 32, 4)}[kind]
    kw = dict(save=False, log=lambda s: None, device="cpu", smoke=True,
              mesh_shape=(2, 1, 2), shape=shape)
    whole = dryrun.run_cell(arch, kind, True, full_depth=True, **kw)
    extra = dryrun.run_cell(arch, kind, True, **kw)
    assert _counts(extra) == pytest.approx(_counts(whole), rel=1e-12)
    assert extra["memory"]["argument_bytes"] == \
        whole["memory"]["argument_bytes"]
    # the peak is extrapolated, not counted: within a fifth of the trace's
    ratio = extra["memory"]["peak_bytes"] / whole["memory"]["peak_bytes"]
    assert 0.8 < ratio < 1.2, ratio
    assert whole["depth"] == extra["depth"] and not extra["full_depth"]


# ---------------------------------------------------------------------------
# (e) main end to end; (f) full-size cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3_32b", "--mesh", "2x2"],
    ["--arch", "qwen3-moe-30b-a3b", "--shape", "train_4k", "--mesh", "2x1x2",
     "--compress-dcn"],
    ["--arch", "deepseek-v2-lite-16b", "--shape", "decode_32k", "--mesh",
     "2x1x2"]])
def test_main_on_smoke_configs(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv + ["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    n = len(list(tmp_path.glob("*.json")))
    assert n >= 1 and f"{n} ok, 0 failed" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert (last["cells"], last["failed"]) == (n, 0)
    assert set(last["process"]) == {
        "allocated_bytes", "max_allocated_bytes", "hedm_reduce_launches",
        "flash_attention_launches", "mamba2_scan_launches",
        "rwkv6_wkv_launches"}
    assert not any(last["process"].values()), last
    for f in tmp_path.glob("*.json"):
        res = json.loads(f.read_text())
        assert {"arch", "shape", "kind", "multi_pod", "n_devices",
                "num_microbatches", "sequence_parallel", "compress_dcn",
                "memory", "op_cost", "flop_counter", "roofline"} <= set(res)
        assert res["op_cost"]["flops"] > 0
        assert res["roofline"]["bottleneck"] in ("compute", "memory",
                                                 "collective")
        assert f"=== {f.stem} ===" in out


def test_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen3_32b", "--smoke", "--mesh", "2x2"])


def test_qwen3_moe_train_on_two_pods_at_full_size():
    res = dryrun.run_cell("qwen3_moe_30b_a3b", "train_4k", True, save=False,
                          log=lambda s: None, device="cpu",
                          compress_dcn=True)
    assert res["n_devices"] == 512 and res["num_microbatches"] == 4
    oc = res["op_cost"]
    assert oc["cross_pod_collective_bytes"] > 0
    assert oc["on_pod_collective_bytes"] > oc["cross_pod_collective_bytes"]
    assert res["roofline"]["collective_s"] > 0
    assert 0 < res["memory"]["argument_bytes"] < res["memory"]["peak_bytes"]


def _reference_cache_bytes(arch, batch, capacity, mesh_shape):
    """Per-device bytes of the reference's decode caches under its
    ``cache_pspecs`` on a mesh of ``mesh_shape`` (shapes only)."""
    import functools
    import math
    import types

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_config
    from repro.distributed.sharding import cache_pspecs
    from repro.distributed.sharding import make_ctx as ref_ctx
    from repro.models import model as JM
    cfg = get_config(arch)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape=dict(zip(("data", "model"),
                                                mesh_shape)))
    caches = jax.eval_shape(functools.partial(JM.init_decode_state, cfg,
                                              batch, capacity))
    specs = cache_pspecs(cfg, caches, ref_ctx(mesh))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(caches), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P))):
        div = 1
        for entry in spec:
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                div *= mesh.shape[a]
        total += math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize \
            // div
    return total


def test_zamba2_long_500k_caches_follow_the_rule():
    """zamba2-7b long_500k on (16, 16): the shared block's caches split
    their positions over "model" (split-KV, capacity >= 131072), the SSM
    state its heads; the per-rank cache bytes equal the reference's rule's
    (5.70 GiB of the 91.14 GiB whole)."""
    low, meta = dryrun.lower_cell("zamba2_7b", "long_500k", False,
                                  device="cpu")
    leaves = dryrun.argument_leaves(low)
    cfg = registry.get_config("zamba2_7b")
    n_sites = cfg.n_layers // cfg.attn_every
    hd = cfg.resolved_head_dim
    kv = sum(n for p, n in leaves.items() if p.startswith("caches/shared_kv")
             and not p.endswith("length"))
    assert kv == n_sites * 2 * 524288 * cfg.n_kv_heads * hd * 2 // 16
    caches = sum(n for p, n in leaves.items() if p.startswith("caches/"))
    ref = _reference_cache_bytes("zamba2_7b", 1, 524288, (16, 16))
    assert caches == ref
    assert round(ref / 2**30, 2) == 5.70
    res = dryrun.analyze(low, meta)
    assert res["memory"]["argument_bytes"] == sum(leaves.values())
    assert res["op_cost"]["on_pod_collective_bytes"] > 0
