"""One rank of the port's sharded train step, expert-parallel MoE,
sharded prefill and sharded decode on a gloo group, for
tests/test_torch_sharded.py and tests/test_torch_sharded_decode.py.

    python tests/torch_sharded_worker.py RANK WORLD RENDEZVOUS OUT_DIR CASES

``CASES`` is a comma-separated list of ``steps`` (one train step of each
smoke config on a (2, 2) data x model mesh, and qwen3-32b and qwen3-moe
with sequence parallelism, and qwen3-32b in 2 and 4 microbatches, each
beside the one-process step from the same weights), ``pod`` (the compressed-DCN
pod branch on (4, 1, 1) and (2, 1, 2) beside its one-process arithmetic),
``prefill`` (the sharded prefill beside the unsharded one), ``jax``
(the steps, the MoE layer and the pod branch on weights and inputs the
reference package wrote to ``OUT_DIR/jax_in.npz``) and ``decode`` (the
sharded decode and a sharded ``ServeSession`` on (2, 2) and (2, 1, 2)
beside the one-process ones, on the reference's weights and tokens in
``OUT_DIR/jax_in.npz``). Rank 0 writes each case's results to
``OUT_DIR/port_<case>.npz``. Imports neither JAX nor the reference
package.
"""
import contextlib
import dataclasses
import os
import re
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

from torch_parity import int8_pod_hop, train_batch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import (make_ctx,  # noqa: E402
                                              shard_model)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import (Request,  # noqa: E402
                                      ServeSession, decode_step,
                                      prefill_step)
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import train_step as T  # noqa: E402

ARCHS = ["qwen3_32b", "internvl2_2b", "hubert_xlarge", "qwen3_moe_30b_a3b",
         "deepseek_v2_lite_16b", "zamba2_7b", "rwkv6_3b"]
JAX_ARCHS = ["qwen3_32b", "qwen3_moe_30b_a3b", "zamba2_7b"]
SP_ARCHS = ["qwen3_32b", "qwen3_moe_30b_a3b"]
OPT = O.OptConfig(total_steps=10, warmup_steps=2)


def _full(t):
    """A tensor whole on every rank (a DTensor gathered), as numpy."""
    if isinstance(t, torch.distributed.tensor.DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _batch(cfg, B, S, seed=0):
    return {k: torch.from_numpy(v) for k, v in
            train_batch(cfg, B, S, seed).items()}


def _ctx(shape, axes, sequence_parallel=False):
    return make_ctx(make_mesh(shape, axes, "cpu"), sequence_parallel)


@contextlib.contextmanager
def sharded_aux(n_shards):
    """``moe.route`` with the reference's sharded aux: the Switch loss of
    each of ``n_shards`` consecutive row blocks, averaged (the pmean of
    ``_moe_ffn_shardmap``); combine weights and ids as they are."""
    orig = moe_mod.route

    def route(router_w, x, moe):
        dense_w, ids, _ = orig(router_w, x, moe)
        auxes = [orig(router_w, xs, moe)[2] for xs in x.chunk(n_shards)]
        return dense_w, ids, torch.stack(auxes).mean()
    moe_mod.route = route
    try:
        yield
    finally:
        moe_mod.route = orig


def _step_result(params, opt_state, batch, step, prefix, out):
    params, opt_state, m = step(params, opt_state, batch)
    out[prefix + "loss"] = _full(m["loss"])
    out[prefix + "grad_norm"] = _full(m["grad_norm"])
    for n, p in params.named_parameters():
        out[f"{prefix}param/{n}"] = _full(p)
    return params, opt_state


def _grads(params, cfg, batch, shape, ctx, prefix, out):
    grads, loss, _ = T.grads_and_loss(params, cfg, batch, shape, ctx)
    for n, g in grads.items():
        if g is not None:
            out[f"{prefix}grad/{n}"] = _full(g)
    out[prefix + "grads_loss"] = _full(loss)


def case_steps(out):
    """(a) every smoke config on (2, 2), and qwen3-32b in 2 microbatches
    and in 4 (one row each, repeated over the data axis); (c) qwen3-32b and
    qwen3-moe with SP."""
    B, S = 4, 24
    runs = ([(a, False, 1) for a in ARCHS] + [(a, True, 1) for a in SP_ARCHS]
            + [("qwen3_32b", False, 2), ("qwen3_32b", False, 4)])
    for arch, sp, n_mb in runs:
        cfg = registry.get_smoke_config(arch)
        shape = ShapeConfig("s", "train", S, B, n_mb, True)
        batch = _batch(cfg, B, S)
        key = arch + ("_sp" if sp else "") + (f"_mb{n_mb}" if n_mb > 1
                                              else "") + "/"
        ctx = _ctx((2, 2), ("data", "model"), sp)
        gen = torch.Generator().manual_seed(0)
        params, opt_state = T.init_train_state(gen, cfg, OPT, ctx=ctx)
        _grads(params, cfg, batch, shape, ctx, key + "sharded/", out)
        _step_result(params, opt_state, batch,
                     T.make_train_step(cfg, shape, OPT, ctx), key + "sharded/",
                     out)
        if dist.get_rank() == 0:
            aux = sharded_aux(2) if cfg.moe else contextlib.nullcontext()
            with aux:
                gen = torch.Generator().manual_seed(0)
                ref, ref_state = T.init_train_state(gen, cfg, OPT)
                _grads(ref, cfg, batch, shape, None, key + "ref/", out)
                _step_result(ref, ref_state, batch,
                             T.make_train_step(cfg, shape, OPT), key + "ref/",
                             out)


def _stacked_leaf(name):
    """The reference's leaf of a port parameter: its name without the
    layer indices (the reference stacks the layers' leaves)."""
    return re.sub(r"\.\d+(?=\.|$)", "", name)


def _pod_reference(cfg, batch, shape, n_pod, steps, out, key):
    """The pod branch's one-process arithmetic: each pod's grads on its
    rows, the int8 hop as the reference's ``pod_body`` computes it (one
    quantization of each pod's whole stacked leaf, the payloads summed in
    pod order), the clip and AdamW."""
    gen = torch.Generator().manual_seed(0)
    params, state = T.init_train_state(gen, cfg, OPT)
    errs = [{n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.named_parameters()} for _ in range(n_pod)]
    for step in range(steps):
        b = batch[step]
        rows = [{k: v.chunk(n_pod)[i] for k, v in b.items()}
                for i in range(n_pod)]
        per_pod = [T.grads_and_loss(params, cfg, r, shape) for r in rows]
        grads = [{n: torch.zeros_like(p, dtype=torch.float32)
                  if g[n] is None else g[n]
                  for n, p in params.named_parameters()}
                 for g, _, _ in per_pod]
        red, errs = int8_pod_hop(grads, errs, _stacked_leaf)
        grads, gnorm = O.clip_by_global_norm(red, OPT.grad_clip)
        params, state, _ = O.adamw_update(params, grads, state, OPT)
        loss = per_pod[0][1]
        for _, l_, _ in per_pod[1:]:
            loss = loss + l_
        out[f"{key}ref/loss{step}"] = _full(loss / n_pod)
        out[f"{key}ref/grad_norm{step}"] = _full(gnorm)
    for n, p in params.named_parameters():
        out[f"{key}ref/param/{n}"] = _full(p)
        out[f"{key}ref/dcn_error/{n}"] = _full(errs[0][n])


def case_pod(out):
    """(e) the pod branch on (4, 1, 1) and (2, 1, 2)."""
    arch, B, S, steps = "qwen3_32b", 8, 16, 2
    cfg = registry.get_smoke_config(arch)
    shape = ShapeConfig("s", "train", S, B, 1, True)
    batches = [_batch(cfg, B, S, seed) for seed in range(steps)]
    for mesh in ((4, 1, 1), (2, 1, 2)):
        key = "x".join(map(str, mesh)) + "/"
        ctx = _ctx(mesh, ("pod", "data", "model"))
        gen = torch.Generator().manual_seed(0)
        params, state = T.init_train_state(gen, cfg, OPT, compress_dcn=True,
                                           ctx=ctx)
        step = T.make_train_step(cfg, shape, OPT, ctx, compress_dcn=True)
        for i in range(steps):
            params, state, m = step(params, state, batches[i])
            out[f"{key}sharded/loss{i}"] = _full(m["loss"])
            out[f"{key}sharded/grad_norm{i}"] = _full(m["grad_norm"])
        for n, p in params.named_parameters():
            out[f"{key}sharded/param/{n}"] = _full(p)
            out[f"{key}sharded/dcn_error/{n}"] = _full(state["dcn_error"][n])
        if dist.get_rank() == 0:
            _pod_reference(cfg, batches, shape, mesh[0], steps, out, key)


def case_prefill(out):
    """(f) the sharded prefill of qwen3-32b and zamba2 on (2, 2)."""
    for arch in ("qwen3_32b", "zamba2_7b"):
        cfg = registry.get_smoke_config(arch)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab, (2, 16)).astype(np.int64))
        ctx = _ctx((2, 2), ("data", "model"))
        model = T.M.init_model(torch.Generator().manual_seed(1), cfg)
        ref_logits, ref_caches = prefill_step(model, cfg, {"tokens": toks},
                                              32)
        shard_model(model, cfg, ctx)
        logits, caches = prefill_step(model, cfg, {"tokens": toks}, 32, ctx)
        out[f"{arch}/sharded/logits"] = _full(logits)
        out[f"{arch}/ref/logits"] = _full(ref_logits)
        for kind, layers in ref_caches.items():
            for i, (c, r) in enumerate(zip(caches[kind], layers)):
                for f, t, u in zip(r._fields, c, r):
                    out[f"{arch}/sharded/cache/{kind}/{i}/{f}"] = _full(t)
                    out[f"{arch}/ref/cache/{kind}/{i}/{f}"] = _full(u)
                    # this rank's block as the prefill hands it back, and
                    # the ranks the decode's layout splits the leaf over
                    splits = [n for n, pl in zip(
                        ctx.mesh.shape, t.placements) if pl.is_shard()]
                    out[f"{arch}/blocks/{kind}/{i}/{f}"] = np.array(
                        [t.to_local().numel(), u.numel(),
                         int(np.prod(splits))])


DECODE_ARCHS = ["qwen3_32b", "internvl2_2b", "h2o_danube3_4b",
                "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b", "zamba2_7b",
                "rwkv6_3b"]
#: (case, smoke arch, batch, prompt tokens, capacity, layers or None)
DECODE_CASES = [(a, a, 4, 14, 32, None) for a in DECODE_ARCHS] + [
    ("internvl2_2b_long", "internvl2_2b", 2, 14, 131072, 1)]
DECODE_MESHES = {"2x2": ((2, 2), ("data", "model")),
                 "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
DECODE_STEPS = 4


def decode_config(arch, layers):
    cfg = registry.get_smoke_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _decode_run(cfg, model, caches, steps, ctx, key, out):
    """The decode steps from ``caches`` (a prefill's, whole): over the mesh
    on the caches ``shard_caches`` lays out when ``ctx``, else in one
    process; each step's logits, the last caches (whole) and, over the
    mesh, the shape of each cache block this rank holds into ``out``."""
    caches = {k: [type(c)(*(t.clone() for t in c)) for c in layers]
              for k, layers in caches.items()}
    if ctx is not None:
        caches = T.M.shard_caches(caches, cfg, ctx)
    for i, tok in enumerate(steps):
        logits, caches = decode_step(model, cfg, torch.from_numpy(tok),
                                     caches, ctx)
        out[f"{key}/logits{i}"] = _full(logits)
    for kind, layers in caches.items():
        for i, c in enumerate(layers):
            for f, t in zip(c._fields, c):
                out[f"{key}/cache/{kind}/{i}/{f}"] = _full(t)
                if ctx is not None:
                    out[f"{key}/block/{kind}/{i}/{f}"] = np.array(
                        t.to_local().shape)


def case_decode(out, in_dir):
    """(d) the sharded decode of every smoke config with a decode step on
    (2, 2) and (2, 1, 2) beside the one-process decode, from the
    reference's weights, prompts and step tokens in ``OUT_DIR/jax_in.npz``
    and the one-process prefill; internvl2-2b (one layer) also at capacity
    131072, where the rule splits the cache's positions over tp
    (split-KV)."""
    data = dict(np.load(os.path.join(in_dir, "jax_in.npz")))
    for case, arch, B, S, cap, layers in DECODE_CASES:
        cfg = decode_config(arch, layers)

        def model():
            return params_from_jax(cfg, _unflatten(data, case + "/params/"),
                                   device="cpu")
        inputs = {k[len(case) + 4:]: torch.from_numpy(v)
                  for k, v in data.items() if k.startswith(case + "/in/")}
        steps = data[case + "/steps"].astype(np.int64)
        ref = model()
        _, caches = prefill_step(ref, cfg, inputs, cap)
        if dist.get_rank() == 0:
            _decode_run(cfg, ref, caches, steps, None, f"{case}/ref", out)
        if dist.get_rank() == 0 and case in SESSION_CASES:
            out[f"{case}/ref/session"] = _session(cfg, ref, None)
        for tag, (shape, axes) in DECODE_MESHES.items():
            ctx = _ctx(shape, axes)
            sharded = shard_model(model(), cfg, ctx)
            _decode_run(cfg, sharded, caches, steps, ctx, f"{case}/{tag}",
                        out)
            if case in SESSION_CASES:
                out[f"{case}/{tag}/session"] = _session(cfg, sharded, ctx)


SESSION_CASES = ("qwen3_32b", "zamba2_7b")


def _session(cfg, model, ctx):
    """The greedy tokens of 4 requests (prompts of 11, 5, 17 and 8 tokens,
    numpy seed 3, 5 new tokens each) through a 2-slot ``ServeSession``:
    slots are freed and reused, so every request's caches are spliced into
    a slot that held another's; with ``ctx`` the session prefills and
    decodes over the mesh on its sharded caches."""
    rng = np.random.default_rng(3)
    sess = ServeSession(model, cfg, batch_slots=2, capacity=32,
                        device="cpu", ctx=ctx)
    for i, n in enumerate((11, 5, 17, 8)):
        sess.submit(Request(i, rng.integers(0, cfg.vocab, n), 5))
    done = sess.run_to_completion(max_steps=100)
    return np.array([r.generated for r in sorted(
        done, key=lambda r: r.request_id)])


def _unflatten(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def case_jax(out, in_dir):
    """(b) the sharded step on the reference's weights; (d) the MoE layer;
    (e) the pod branch on the reference's weights."""
    data = dict(np.load(os.path.join(in_dir, "jax_in.npz")))
    ctx = _ctx((2, 2), ("data", "model"))
    for arch in JAX_ARCHS:
        cfg = registry.get_smoke_config(arch)
        params = params_from_jax(cfg, _unflatten(data, arch + "/params/"),
                                 device="cpu").requires_grad_(True)
        shard_model(params, cfg, ctx)
        state = O.init_opt_state(params)
        B, S = data[arch + "/tokens"].shape
        shape = ShapeConfig("s", "train", S, B, 1, True)
        batch = {"tokens": torch.from_numpy(data[arch + "/tokens"]),
                 "labels": torch.from_numpy(data[arch + "/labels"])}
        params, state, m = T.make_train_step(cfg, shape, OPT, ctx)(
            params, state, batch)
        out[arch + "/loss"] = _full(m["loss"])
        out[arch + "/grad_norm"] = _full(m["grad_norm"])
    cfg = registry.get_smoke_config("qwen3_moe_30b_a3b")
    moe = params_from_jax(cfg, _unflatten(data, "qwen3_moe_30b_a3b/params/"),
                          device="cpu").stack.layers[0]
    holder = torch.nn.Module()
    holder.moe = moe.moe
    shard_model(holder, cfg, ctx)
    for name in ("x_spread", "x_skewed"):
        x = ctx.constrain(torch.from_numpy(data["moe/" + name]), "data")
        y, aux = moe_mod.moe_ffn(holder.moe, cfg, x, ctx=ctx)
        out[f"moe/{name}/out"] = _full(ctx.gather(y, "data"))
        out[f"moe/{name}/aux"] = _full(aux)
    # the pod branch on (2, 1, 2), two steps on the reference's weights
    cfg = registry.get_smoke_config("qwen3_32b")
    ctx = _ctx((2, 1, 2), ("pod", "data", "model"))
    params = params_from_jax(cfg, _unflatten(data, "qwen3_32b/params/"),
                             device="cpu").requires_grad_(True)
    shard_model(params, cfg, ctx)
    state = O.init_opt_state(params)
    state["dcn_error"] = {n: torch.zeros_like(p, dtype=torch.float32)
                          for n, p in params.named_parameters()}
    B, S = data["pod/tokens0"].shape
    step = T.make_train_step(cfg, ShapeConfig("s", "train", S, B, 1, True),
                             OPT, ctx, compress_dcn=True)
    for i in range(2):
        batch = {"tokens": torch.from_numpy(data[f"pod/tokens{i}"]),
                 "labels": torch.from_numpy(data[f"pod/labels{i}"])}
        params, state, m = step(params, state, batch)
        out[f"pod/loss{i}"] = _full(m["loss"])
        out[f"pod/grad_norm{i}"] = _full(m["grad_norm"])
    for n, p in params.named_parameters():
        out[f"pod/param/{n}"] = _full(p)


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rdzv, out_dir, cases = sys.argv[3], sys.argv[4], sys.argv[5].split(",")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        for case in cases:
            out = {}
            if case == "jax":
                case_jax(out, out_dir)
            elif case == "decode":
                case_decode(out, out_dir)
            else:
                {"steps": case_steps, "pod": case_pod,
                 "prefill": case_prefill}[case](out)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"port_{case}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
