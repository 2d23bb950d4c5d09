"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks.

Counterpart of ``repro.launch.dryrun``, which AOT-lowers and compiles each
cell for 512 fake host devices. PyTorch has no ahead-of-time compiler for
a sharded eager program, so each cell here:

  1. initialises a fake process group (``FakeStore``, backend ``"fake"``)
     of the mesh's world size, 256 or 512, as rank 0: its collectives
     communicate nothing and return at once;
  2. builds the production mesh ((16, 16) or (2, 16, 16)) over it and its
     ``ShardCtx``;
  3. builds the model, the optimizer state (and ``dcn_error`` under
     ``--compress-dcn``), the inputs and the decode caches as fake tensors
     (``FakeTensorMode``: shapes, types and devices, no memory), the
     parameters laid out by ``param_pspecs`` (``shard_model``) and the
     caches by ``cache_pspecs`` (``shard_caches``);
  4. runs the port's real step once on rank 0's blocks (the train step,
     ``prefill_step`` or the sharded ``decode_step``) under
     `repro_torch.distributed.op_cost.OpCost`, which counts FLOPs (the
     kernels' through their registered formulas), bytes, collective bytes
     on and across pods and the live bytes of every storage. The train
     step runs its ``ARCH_MICROBATCH`` microbatches as one traced
     microbatch counted that many times (``OpCost.repeated``: the
     iterations run the same ops on rows of the same shape). The layer
     stack is the reference's scanned loop body too: a cell is traced at
     a few small depths (:func:`depth_variants`: two of each kind of
     layer, then more of one kind at a time) and its counts are solved
     for each kind's and extrapolated to the config's depth, exactly, as
     every layer of a kind runs the same ops. The peak bytes are
     extrapolated from the same traces, as the larger of the peak's and
     of the bytes live when the step returns (a layer's transient counted
     once, the outputs, such as a prefill's caches, once a layer);
     ``run_cell(full_depth=True)`` traces every layer;
  5. writes ``results/dryrun_torch/<cell>.json`` with the reference's tag
     and meta keys, ``memory`` (``argument_bytes``: the rank's parameters,
     optimizer state, caches and its block of the inputs under
     ``input_pspecs``; ``peak_bytes``: those and the most that the step's
     storages held at once; ``end_bytes``: those live when it returns),
     ``op_cost``, ``flop_counter`` and
     ``roofline`` (seconds at the H100 SXM's data-sheet rates of
     `repro_torch.launch.mesh`).

The last line ``main`` prints is one JSON object: the cells that ran and
failed, and ``process`` (:func:`process_report` after each cell, the most
any showed): the card's bytes allocated then and at most during the cell,
and the four kernels' launch counts, which a dry run leaves at 0. (Before
its first cell a process lets PyTorch's fake CUDA tensors initialise the
CUDA context, a 4-byte tensor allocated and freed at once: counting
starts after it.)

With ``--device cuda`` (the default) the fake tensors carry the card's
device, so the traced program is the card's, the kernels (K2-K4) included
through their fake implementations: nothing is allocated on the card and
no kernel is launched; without a card it raises, as every entry point of
the port does. ``--device cpu`` traces the CPU program, the kernels as
their plain versions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu --jobs 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke --mesh 2x2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import (ARCH_IDS, all_cells, canonical,
                                          get_config, get_smoke_config,
                                          supported_shapes)
from repro_torch.device import resolve_device
from repro_torch.distributed.op_cost import OpCost
from repro_torch.distributed.sharding import (ShardCtx, _block_of,
                                              _tree_paths, input_pspecs,
                                              make_ctx, placements,
                                              shard_model)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.serve import engine as serve_engine
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# grad-accumulation microbatches per arch for train_4k (the reference's)
ARCH_MICROBATCH = {
    "qwen2_72b": 16,
    "qwen3_32b": 8,
    "internlm2_20b": 4,
    "zamba2_7b": 4,
    "qwen3_moe_30b_a3b": 4,
    "deepseek_v2_lite_16b": 4,
    "h2o_danube3_4b": 2,
    "internvl2_2b": 2,
    "hubert_xlarge": 2,
    "rwkv6_3b": 4,
}


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, type) of every model input of this cell, as the reference's
    ``ShapeDtypeStruct`` stand-ins (token ids int32)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32)}
    specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    fe = cfg.frontend
    if fe.kind == "audio_frames":
        specs["features"] = ((B, S, fe.feature_dim), torch.bfloat16)
        specs["labels"] = ((B, S), i32)
        return specs
    if fe.kind == "vision_patches":
        specs["tokens"] = ((B, S - fe.num_prefix_tokens), i32)
        specs["image_embeds"] = ((B, fe.num_prefix_tokens, fe.feature_dim),
                                 torch.bfloat16)
        if shape.kind == "train":
            specs["labels"] = ((B, S - fe.num_prefix_tokens), i32)
        return specs
    specs["tokens"] = ((B, S), i32)
    if shape.kind == "train":
        specs["labels"] = ((B, S), i32)
    return specs


@dataclasses.dataclass
class Lowered:
    """A cell built on fake tensors: ``run(cost)`` runs its step once under
    ``cost``; ``arguments`` are the rank's blocks of what the step is
    handed (parameters, optimizer state, caches, inputs), ``inputs_whole``
    what the step is handed of the inputs beyond its block."""
    mode: FakeTensorMode
    run: Callable[[OpCost], Any]
    arguments: Dict[str, Any]
    inputs_whole: Any
    n_pods: int
    world: int


def fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process rank 0 (a group of another size is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]],
          device: torch.device):
    """The production mesh, or for tests a small one of ``mesh_shape``
    (axes ("data", "model"), or ("pod", "data", "model") for three dims),
    over a fake group of its size."""
    if mesh_shape is None:
        fake_group(512 if multi_pod else 256)
        return mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device_type=device.type)
    axes = ("pod", "data", "model")[3 - len(mesh_shape):]
    fake_group(math.prod(mesh_shape))
    return mesh_mod.make_mesh(tuple(mesh_shape), axes, device.type)


def _local_inputs(inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
                  shape: ShapeConfig, ctx: ShardCtx) -> Dict[str, Any]:
    """Rank 0's block of each input under ``input_pspecs``."""
    specs = input_pspecs(cfg, shape, ctx)
    out = {}
    for k, t in inputs.items():
        out[k] = _block_of(t, ctx.mesh, placements(specs[k], ctx.mesh))
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               sequence_parallel: bool = False, compress_dcn: bool = False,
               *, device: str = "cuda", smoke: bool = False,
               mesh_shape: Optional[Sequence[int]] = None,
               shape: Optional[ShapeConfig] = None,
               cfg: Optional[ModelConfig] = None) -> Tuple[Lowered, Dict]:
    """Build one cell on fake tensors. Returns (the built cell, meta).
    ``smoke`` takes the arch's smoke config, ``mesh_shape`` a small mesh
    instead of the production one, ``shape`` a cell shape and ``cfg`` a
    config of the caller's (tests, and the shallow variants)."""
    arch = canonical(arch)
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if shape is None:
        shape = SHAPES[shape_name]
        if shape.kind == "train":
            shape = ShapeConfig(shape.name, shape.kind, shape.seq_len,
                                shape.global_batch,
                                num_microbatches=ARCH_MICROBATCH.get(arch, 1),
                                remat=True)
    mesh = _mesh(multi_pod, mesh_shape, dev)
    ctx = make_ctx(mesh, sequence_parallel=sequence_parallel)
    n_pods = ctx.shape.get("pod", 1)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        params = M.Model(cfg, None, dev)
        inputs = {k: torch.zeros(s, dtype=t, device=dev)
                  for k, (s, t) in input_specs(cfg, shape).items()}
        if shape.kind == "train":
            params.requires_grad_(True)
        shard_model(params, cfg, ctx)
        local_in = _local_inputs(inputs, cfg, shape, ctx)
        args: Dict[str, Any] = {"params": params, "inputs": local_in}
        if shape.kind == "train":
            opt = OptConfig()
            opt_state = init_opt_state(params)
            if compress_dcn:
                opt_state["dcn_error"] = {
                    n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.named_parameters()}
            args["opt_state"] = opt_state

            def run(cost: OpCost):
                def loop(mbs, body):
                    with cost.repeated(len(mbs)):
                        body(mbs[0])
                step = make_train_step(cfg, shape, opt, ctx=ctx,
                                       compress_dcn=compress_dcn, loop=loop)
                return step(params, opt_state, inputs)
        elif shape.kind == "prefill":
            def run(cost: OpCost):
                return serve_engine.prefill_step(
                    params, cfg, inputs, capacity=shape.seq_len, ctx=ctx)
        else:
            caches = M.shard_caches(M.init_decode_state(
                cfg, shape.global_batch, shape.seq_len, dev), cfg, ctx)
            args["caches"] = caches
            tokens = local_in["tokens"]

            def run(cost: OpCost):
                return M.decode_step(params, cfg, tokens, caches, ctx)
    meta = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "multi_pod": multi_pod, "n_devices": math.prod(ctx.axis_sizes),
        "mesh": dict(ctx.shape),
        "num_microbatches": shape.num_microbatches,
        "traced_microbatches": 1 if shape.kind == "train" else None,
        "sequence_parallel": sequence_parallel,
        "compress_dcn": compress_dcn, "device": dev.type, "smoke": smoke,
        "depth": depth_units(cfg),
    }
    return Lowered(mode, run, args, inputs, n_pods,
                   math.prod(ctx.axis_sizes)), meta


def argument_leaves(lowered: Lowered) -> Dict[str, int]:
    """Bytes of each argument's block on rank 0, by its path (a
    ``DTensor``'s local block; parameters by name)."""
    out = {}
    for path, t in _tree_paths(lowered.arguments).items():
        local = getattr(t, "_local_tensor", t)
        if isinstance(local, torch.Tensor):
            out[path] = local.numel() * local.element_size()
    return out


def depth_units(cfg: ModelConfig) -> Dict[str, int]:
    """The config's layers by kind: ``layer`` (uniform), ``dense`` and
    ``moe`` (a MoE stack after its dense prefix), or ``mamba`` and
    ``site`` (zamba_hybrid: every Mamba2 block, and the shared block's
    call sites)."""
    if cfg.block_pattern == "zamba_hybrid":
        return {"mamba": cfg.n_layers,
                "site": cfg.n_layers // cfg.attn_every}
    if cfg.moe is not None:
        k = cfg.moe.first_k_dense
        return ({"dense": k} if k else {}) | {"moe": cfg.n_layers - k}
    return {"layer": cfg.n_layers}


def depth_variants(cfg: ModelConfig) -> List[Tuple[Dict[str, int],
                                                    ModelConfig]]:
    """The shallow configs a cell is traced at, with their layers by kind:
    two of each kind, then more layers of one kind at a time (each variant
    differs from the one before in one kind, so their differences are that
    kind's increments). Every variant holds at least two layers of each
    kind: what the first layer leaves live across the next (the
    embeddings' output beside the first layer's) is in each peak, and no
    increment counts it."""
    R = dataclasses.replace
    if cfg.block_pattern == "zamba_hybrid":
        return [({"mamba": 2, "site": 2}, R(cfg, n_layers=2, attn_every=1)),
                ({"mamba": 4, "site": 2}, R(cfg, n_layers=4, attn_every=2)),
                ({"mamba": 4, "site": 4}, R(cfg, n_layers=4, attn_every=1))]
    units = depth_units(cfg)
    if "dense" in units:
        def moe_cfg(k, m):
            return R(cfg, n_layers=k + m, moe=R(cfg.moe, first_k_dense=k))
        return [({"dense": 2, "moe": 2}, moe_cfg(2, 2)),
                ({"dense": 3, "moe": 2}, moe_cfg(3, 2)),
                ({"dense": 3, "moe": 3}, moe_cfg(3, 3))]
    (kind,) = units
    return [({kind: 2}, R(cfg, n_layers=2)), ({kind: 3}, R(cfg, n_layers=3))]


def _trace(lowered: Lowered) -> Dict[str, Any]:
    """Run the built cell once under ``OpCost``: its counts, its peak
    bytes and the bytes live when it returns (its outputs held)."""
    with lowered.mode:
        cost = OpCost(n_pods=lowered.n_pods, world=lowered.world)
        with cost:
            cost.hold(lowered.inputs_whole)
            held = cost.hold(lowered.arguments)
            out = lowered.run(cost)
            end = held + cost.live_bytes
            del out
    return {"op_cost": cost.summary(), "flops_by_op": cost.flops_by_op(),
            "peak_bytes": held + cost.peak_bytes, "end_bytes": end}


def _extrapolate(traces: List[Dict[str, Any]],
                 counts: List[Dict[str, int]],
                 full: Dict[str, int]) -> Dict[str, Any]:
    """Every number of the traces at the ``full`` counts: the first trace,
    plus for each kind its increment a layer (a variant less the one
    before it, which holds fewer layers of that kind alone, over the
    layers between them) times the layers of that kind beyond the first
    variant's."""
    def at(get):
        out = get(traces[0])
        for i in range(1, len(traces)):
            (kind,) = [k for k in counts[i] if counts[i][k]
                       != counts[i - 1][k]]
            step = counts[i][kind] - counts[i - 1][kind]
            delta = (full[kind] - counts[0][kind]) * (
                get(traces[i]) - get(traces[i - 1]))
            out = out + (delta // step if isinstance(delta, int)
                         and delta % step == 0 else delta / step)
        return out

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path

    def get_path(tree, path):
        for k in path:
            tree = tree.get(k, 0.0) if isinstance(tree, dict) else 0.0
        return tree

    paths = set()
    for tr in traces:
        paths.update(leaves(tr))
    out: Dict[str, Any] = {}
    for path in sorted(paths):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = at(lambda tr: get_path(tr, path))
    return out


def analyze(lowered: Lowered, meta: Dict,
            variants: Optional[List[Tuple[Dict[str, int], Lowered]]] = None
            ) -> Dict:
    """Trace the built cell under ``OpCost``: memory, op costs and
    collective bytes. With ``variants`` (shallow builds of the same cell
    and their layers by kind, :func:`depth_variants`) those are traced and
    the counts extrapolated to the cell's depth; ``lowered`` (the whole
    model) then only gives the argument bytes."""
    t0 = time.time()
    if variants is None:
        tr = _trace(lowered)
    else:
        tr = _extrapolate([_trace(v) for _, v in variants],
                          [c for c, _ in variants], meta["depth"])
    out = dict(meta)
    out.update({
        "trace_seconds": round(time.time() - t0, 1),
        "memory": {"argument_bytes": sum(argument_leaves(lowered).values()),
                   "peak_bytes": max(tr["peak_bytes"], tr["end_bytes"]),
                   "end_bytes": tr["end_bytes"]},
        "op_cost": tr["op_cost"],
        "flop_counter": {"Global": tr["flops_by_op"]},
    })
    return out


def roofline_terms(result: Dict) -> Dict:
    """The roofline terms (seconds) for one traced cell, at the H100 SXM's
    data-sheet rates: on-pod bytes over NVLink (a lower bound for a pod
    of hosts of 8 cards), cross-pod bytes over one NIC a card."""
    oc = result["op_cost"]
    compute = oc["flops"] / mesh_mod.PEAK_FLOPS_BF16
    memory = oc["bytes"] / mesh_mod.HBM_BW
    on_pod = oc["on_pod_collective_bytes"] / mesh_mod.NVLINK_BW
    cross_pod = oc["cross_pod_collective_bytes"] / mesh_mod.NET_BW_PER_GPU
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": on_pod + cross_pod, "on_pod_s": on_pod,
            "cross_pod_s": cross_pod,
            "bottleneck": max(
                [("compute", compute), ("memory", memory),
                 ("collective", on_pod + cross_pod)],
                key=lambda kv: kv[1])[0]}


def cell_tag(arch: str, shape_name: str, multi_pod: bool, **kw) -> str:
    mesh = "multipod" if multi_pod else "pod"
    tag = f"{canonical(arch)}.{shape_name}.{mesh}"
    for flag in ("sequence_parallel", "compress_dcn"):
        if kw.get(flag):
            tag += f".{flag}"
    if kw.get("smoke"):
        tag += ".smoke"
    if kw.get("mesh_shape"):
        tag += "." + "x".join(map(str, kw["mesh_shape"]))
    return tag


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, log: Callable[[str], None] = print,
             full_depth: bool = False, **kw) -> Dict:
    tag = cell_tag(arch, shape_name, multi_pod, **kw)
    log(f"=== {tag} ===")
    t0 = time.time()
    lowered, meta = lower_cell(arch, shape_name, multi_pod, **kw)
    variants = None
    if not full_depth:
        base = kw.get("cfg") or (get_smoke_config(arch) if kw.get("smoke")
                                 else get_config(arch))
        variants = [(c, lower_cell(arch, shape_name, multi_pod,
                                   **dict(kw, cfg=v))[0])
                    for c, v in depth_variants(base)]
    meta["full_depth"] = full_depth
    log(f"  built in {time.time() - t0:.1f}s")
    result = analyze(lowered, meta, variants)
    result["roofline"] = roofline_terms(result)
    mem_gb = result["memory"]["peak_bytes"] / 2**30
    r = result["roofline"]
    log(f"  traced in {result['trace_seconds']}s | "
        f"mem/device={mem_gb:.2f} GiB | "
        f"compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms "
        f"collective={r['collective_s']*1e3:.2f}ms (on-pod "
        f"{r['on_pod_s']*1e3:.2f} + cross-pod {r['cross_pod_s']*1e3:.2f}) "
        f"-> {r['bottleneck']}")
    if result["memory"]["peak_bytes"] > mesh_mod.HBM_PER_CHIP:
        log(f"  WARNING: exceeds {mesh_mod.HBM_PER_CHIP / 1e9:.0f} GB HBM")
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(os.path.join(RESULTS_DIR, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def process_report() -> Dict[str, int]:
    """This process's use of the card: the bytes the caching allocator
    holds for tensors now and held at most, and the launches each
    kernel's wrapper counted (0 without a card)."""
    from repro_torch.kernels import ops
    out = {"allocated_bytes": torch.cuda.memory_allocated(),
           "max_allocated_bytes": torch.cuda.max_memory_allocated()}
    for name in ("hedm_reduce", "flash_attention", "mamba2_scan",
                 "rwkv6_wkv"):
        out[f"{name}_launches"] = getattr(ops, name).launches
    return out


def _fake_cuda_context(device: torch.device) -> None:
    """Let PyTorch's fake CUDA tensors initialise the CUDA context, which
    they do once a process and device name by allocating one 4-byte
    tensor and freeing it at once, then zero the peak: what
    :func:`process_report` reads after a cell is the cell's own."""
    if device.type != "cuda":
        return
    with FakeTensorMode():
        for d in (device, torch.device("cuda", torch.cuda.current_device())):
            torch.empty(0, device=d)
    torch.cuda.reset_peak_memory_stats()


def _run_logged(arch: str, shape_name: str, multi_pod: bool, kw: Dict
                ) -> Tuple[List[str], Optional[str], Dict[str, int]]:
    """One cell in a worker process: (its printed lines, the failure or
    None, :func:`process_report` after it)."""
    lines: List[str] = []
    err = None
    _fake_cuda_context(resolve_device(kw["device"]))
    try:
        run_cell(arch, shape_name, multi_pod, log=lines.append, **kw)
    except Exception as e:          # a failed cell is reported, not fatal
        lines.append(f"  FAILED: {e}")
        lines.append(traceback.format_exc())
        err = repr(e)
    return lines, err, process_report()


def _trace_order(cell: Tuple[str, str, bool]) -> Tuple[bool, bool]:
    """Sort key starting the cells that take longest to trace first: the
    train cells, and among them those of recurrent mixers (RWKV6, Mamba2:
    a chunked scan dispatches its ops once a chunk of every layer)."""
    arch, shape_name, _ = cell
    cfg = get_config(arch)
    return (SHAPES[shape_name].kind != "train",
            cfg.rwkv is None and cfg.ssm is None)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--sequence-parallel", action="store_true")
    ap.add_argument("--compress-dcn", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the card's "
                         "program; needs a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs")
    ap.add_argument("--mesh", default=None,
                    help="a small mesh instead of the production one, "
                         "e.g. 2x2 or 2x1x2 (pod x data x model)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    mesh_shape = (tuple(int(n) for n in args.mesh.split("x"))
                  if args.mesh else None)
    if mesh_shape is not None:
        meshes = [len(mesh_shape) == 3]

    if args.all:
        cells = all_cells()
    else:
        arch = args.arch or ARCH_IDS[0]
        shapes = [args.shape] if args.shape else supported_shapes(
            get_config(arch))
        cells = [(arch, s) for s in shapes]

    kw = dict(sequence_parallel=args.sequence_parallel,
              compress_dcn=args.compress_dcn, device=args.device,
              smoke=args.smoke, mesh_shape=mesh_shape)
    todo = [(arch, s, mp) for arch, s in cells for mp in meshes]
    failures = []
    process = process_report()

    def done(cell, result) -> None:
        lines, err, report = result
        print("\n".join(lines), flush=True)
        if err is not None:
            failures.append(cell + (err,))
        for k, v in report.items():
            process[k] = max(process[k], v)
    if args.jobs > 1:
        import multiprocessing
        with ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            futures = {cell: pool.submit(_run_logged, *cell, kw)
                       for cell in sorted(todo, key=_trace_order)}
            for cell in todo:
                done(cell, futures[cell].result())
    else:
        for cell in todo:
            done(cell, _run_logged(*cell, kw))
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"\n{len(todo) - len(failures)} ok, {len(failures)} failed")
    for f in failures:
        print("  FAIL:", f)
    print(json.dumps({"cells": len(todo), "failed": len(failures),
                      "process": process}), flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
