"""The port's sharded decode over a gloo group of 4 CPU ranks, against its
one-process decode and the reference's decode jitted with ``cache_pspecs``.

Every smoke config with a decode step (and internvl2-2b with one layer at
capacity 131072, where the rule splits the cache's positions over tp) is
prefilled in one process from the reference's weights (``params_from_jax``)
and prompt, and then decodes four steps of given tokens: on (2, 2) and
(2, 1, 2) meshes (4 ranks of tests/torch_sharded_worker.py, case
``decode``: the caches laid out by ``shard_caches``), in one process, and
in the reference's ``decode_step`` jitted on a (2, 2) mesh of 4 fake
devices with the caches sharded by its ``cache_pspecs`` (a subprocess).
All of them start together and are killed at 240 s. Compared as max
|diff| over max |reference|:

* the sharded logits of every step and the last caches within 1e-5 of the
  one-process decode's (the split-KV softmax, the MLA latent sums and the
  mamba2 / rwkv6 norms add in another order);
* every step's logits within 1e-4 of the reference's;
* each cache block a rank holds is the reference's shard of that leaf
  (its per-layer slice);
* a 2-slot ``ServeSession`` over the mesh (qwen3-32b and zamba2-7b)
  serves 4 requests with the one-process session's greedy tokens.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import registry as jax_registry
from repro.models import model as JM

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)

from torch_sharded_worker import (DECODE_CASES, DECODE_MESHES,  # noqa: E402
                                  DECODE_STEPS, SESSION_CASES)

ROOT = os.path.join(HERE, "..")
WORKER = os.path.join(HERE, "torch_sharded_worker.py")
TIMEOUT_S = 240
CASES = [c[0] for c in DECODE_CASES]

JAX_DECODE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.distributed.sharding import (cache_pspecs, input_pspecs,
                                            make_ctx, param_pspecs)
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.serve import engine
    d = sys.argv[1]
    data = dict(np.load(d + "/jax_in.npz"))
    mesh = make_mesh((2, 2), ("data", "model"))
    ctx = make_ctx(mesh)

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

    def sh(specs):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))
    out = {}
    for spec in sys.argv[2].split(","):
        case, arch, B, cap, layers = spec.split(":")
        cfg = get_smoke_config(arch)
        if layers != "-":
            cfg = dataclasses.replace(cfg, n_layers=int(layers))
        B, cap = int(B), int(cap)
        params = tree(case + "/params/")
        ins = tree(case + "/in/")
        _, caches = jax.jit(lambda p, i: engine.prefill_step(
            p, cfg, i, capacity=cap))(params, ins)
        p_sh = sh(param_pspecs(cfg, params, ctx))
        c_sh = sh(cache_pspecs(cfg, caches, ctx))
        t_sh = NamedSharding(mesh, input_pspecs(
            cfg, ShapeConfig("d", "decode", cap, B), ctx)["tokens"])
        params = jax.device_put(params, p_sh)
        caches = jax.device_put(caches, c_sh)
        step = jax.jit(lambda p, t, c: M.decode_step(p, cfg, t, c),
                       in_shardings=(p_sh, t_sh, c_sh),
                       out_shardings=(None, c_sh))
        for i, tok in enumerate(data[case + "/steps"]):
            logits, caches = step(params, jnp.asarray(tok), caches)
            out[f"{case}/logits{i}"] = np.asarray(logits)
        for (path, leaf), s in zip(
                jax.tree_util.tree_flatten_with_path(caches)[0],
                jax.tree.leaves(c_sh)):
            name = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                            for p in path)
            out[f"{case}/block/{name}"] = np.array(s.shard_shape(leaf.shape))
    np.savez(d + "/jax_decode.npz", **out)
""")


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", **extra)


def _run_bounded(procs, timeout):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_decode")
    data, specs = {}, []
    for case, arch, B, S, cap, layers in DECODE_CASES:
        cfg = jax_registry.get_smoke_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = jax.jit(JM.init_model, static_argnums=1)(
            jax.random.PRNGKey(0), cfg)
        _flat(jax.tree.map(np.asarray, params), case + "/params/", data)
        rng = np.random.default_rng(7)
        fe = cfg.frontend
        data[case + "/in/tokens"] = rng.integers(
            0, cfg.vocab, (B, S)).astype(np.int32)
        if fe.kind == "vision_patches":
            data[case + "/in/image_embeds"] = rng.standard_normal(
                (B, fe.num_prefix_tokens, fe.feature_dim)).astype(np.float32)
        data[case + "/steps"] = rng.integers(
            0, cfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
        specs.append(f"{case}:{arch}:{B}:{cap}:{layers or '-'}")
    np.savez(d / "jax_in.npz", **data)
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_DECODE, str(d), ",".join(specs)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, WORKER, str(r), "4", str(d / "rendezvous"), str(d),
         "decode"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    _run_bounded(procs, TIMEOUT_S)
    return dict(np.load(d / "port_decode.npz")), dict(
        np.load(d / "jax_decode.npz"))


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-30))


def side(res, key):
    pre = key + "/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@pytest.mark.parametrize("mesh", list(DECODE_MESHES))
@pytest.mark.parametrize("case", CASES)
def test_sharded_decode_matches_one_process(runs, case, mesh):
    port, _ = runs
    s, r = side(port, f"{case}/{mesh}"), side(port, f"{case}/ref")
    keys = [k for k in r if not k.startswith("block/")]
    assert len(keys) > DECODE_STEPS and all(k in s for k in keys)
    for k in keys:
        assert s[k].shape == r[k].shape, k
        assert rel(s[k], r[k]) < 1e-5 or not (r[k].any() or s[k].any()), k


@pytest.mark.parametrize("mesh", list(DECODE_MESHES))
@pytest.mark.parametrize("case", CASES)
def test_sharded_decode_matches_reference(runs, case, mesh):
    port, ref = runs
    for i in range(DECODE_STEPS):
        a = port[f"{case}/{mesh}/logits{i}"]
        b = ref[f"{case}/logits{i}"]
        assert a.shape == b.shape
        assert rel(a, b) < 1e-4, (i, rel(a, b))


@pytest.mark.parametrize("mesh", list(DECODE_MESHES))
@pytest.mark.parametrize("case", SESSION_CASES)
def test_sharded_session_matches_one_process(runs, case, mesh):
    """``ServeSession(ctx=...)``: 4 requests on 2 slots, each request's
    prefilled caches spliced into this rank's block of its slot, give the
    one-process session's greedy tokens."""
    port, _ = runs
    got, want = port[f"{case}/{mesh}/session"], port[f"{case}/ref/session"]
    assert want.shape == (4, 5) and np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_cache_blocks_are_the_reference_shards(runs, case):
    """Each cache block on (2, 2) is the reference's shard of its stacked
    leaf without the layer dim; on long contexts the positions split."""
    port, ref = runs
    blocks = side(port, f"{case}/2x2/block")
    ref_blocks = side(ref, f"{case}/block")
    assert blocks
    for k, shape in blocks.items():
        kind, _, field = k.split("/")
        assert tuple(shape) == tuple(ref_blocks[f"{kind}/{field}"][1:]), k
    if case.endswith("_long"):
        assert blocks["layers/0/k"][1] == 131072 // 2
