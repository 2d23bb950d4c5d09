"""Sharding rules: FSDP x TP x EP (+ optional SP) over the production mesh.

Counterpart of ``repro.distributed.sharding``; the rules and the spec
builders are the reference's, verbatim where they are pure Python.

Strategy (MaxText-flavored, adapted per architecture):
  * TP ("model" axis): attention heads / FFN hidden / experts / vocab.
  * FSDP ("data" axis): the complementary dim of every large matrix
    (ZeRO-3-style). Required to fit 72B optimizer state.
  * DP: batch over ("pod","data") — the "pod" axis carries only gradient
    all-reduce traffic (bulk data stays on-pod: the paper's locality
    principle applied across pods).
  * GQA with n_kv_heads < tp: KV projections REPLICATED over tp (Megatron
    convention); q heads sharded.
  * RWKV6 time-mix: r/k/w replicated over tp; v / state / output sharded on
    the VALUE dim (the recurrence is independent across value channels).
  * Uneven dims (vocab 92553, hubert 504) fall back to replicated.

A spec is a :class:`P`, a tuple whose entries are an axis name, a tuple of
axis names or ``None``, one per tensor dim (trailing dims left out are
unsharded), as JAX's ``PartitionSpec``. :func:`placements` maps it onto a
``torch.distributed`` ``DeviceMesh`` as DTensor placements.

The reference stacks its layers along a leading dim (``stack/layers/attn/
wq`` is (L, D, H*hd)) and prepends ``None`` to such a leaf's spec. The port
keeps per-layer modules (``stack.layers.3.attn.wq``, and the ``groups``,
``loras``, ``tail`` and ``prefix`` lists; ``models/convert.py``), so a
port name maps onto the reference's path by dropping its layer index and
joining with ``/``, and its spec is the reference's without that leading
``None``. MoE experts stay stacked in both packages, so their rules apply
unchanged. :func:`param_pspecs` reads only names and shapes: a model built
on the meta device (``Model(cfg, None, "meta")``) costs no memory at full
size.

Inside the model (the sharded train step and prefill), a :class:`ShardCtx`
made from a ``DeviceMesh`` carries the mesh. The parameters are laid onto
it by :func:`shard_model` as ``nn.Parameter(DTensor)`` with the rule's
placements (storage FSDP x TP). The model computes on plain local tensors:
:func:`fsdp_gather` gives each weight of a block with its fsdp axis
gathered (the reference's ZeRO-3 prefetch; the gather's backward is the
grads' reduce-scatter), and the mixers run on their tp shard with the
collectives written out (:meth:`ShardCtx.psum` after a row-parallel
product, :meth:`ShardCtx.gather` and :meth:`ShardCtx.constrain` where the
reference constrains an activation). Each collective is an autograd
function whose backward is its transpose, as in the reference's
``shard_map``: an all-gather's backward reduce-scatters, a psum's backward
is a psum. So every rank's cotangent of a replicated value is its part of
the sum, a rank weights its loss by 1 / (ranks the grads are summed over),
and the grad of a parameter replicated over an axis is summed over that
axis after backward (`repro_torch.train.train_step`). A context without a
mesh (the namespace the spec functions take) raises on every collective;
nothing falls back to one rank.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig, ShapeConfig

NO_MESH = ("this ShardCtx has no DeviceMesh (it names axes only, as the "
           "spec functions take it): make it with make_ctx of a "
           "torch.distributed DeviceMesh to compute over the mesh")


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), None)``,
    ``P()`` (replicated). A tuple of one axis name is that name, as in
    JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (``None`` -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class ShardCtx:
    """The mesh's axis names and sizes, the roles of its axes, and the
    ``DeviceMesh`` itself (None for a context that only names axes)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp_axis: Optional[str] = "data"
    tp_axis: Optional[str] = "model"
    sequence_parallel: bool = False
    mesh: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def tp_size(self) -> int:
        return self.shape[self.tp_axis] if self.tp_axis else 1

    @property
    def dp_size(self) -> int:
        size = 1
        for a in self.dp_axes:
            size *= self.shape[a]
        return size

    # -- this rank on the mesh ----------------------------------------------
    def _mesh(self):
        if self.mesh is None:
            raise RuntimeError(NO_MESH)
        return self.mesh

    def size(self, axes) -> int:
        """Ranks along ``axes`` (a name, a tuple of names or None)."""
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's flat coordinate along ``axes``, the first axis
        outermost (the order in which a dim sharded over several axes is
        split)."""
        mesh = self._mesh()
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + mesh.get_local_rank(a)
        return i

    @property
    def tp_rank(self) -> int:
        return self.index(self.tp_axis) if self.tp_axis else 0

    def group(self, axis: str):
        return self._mesh().get_group(axis)

    # -- activations ----------------------------------------------------------
    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """This rank's block of ``x`` under ``spec``: each dim whose entry
        names axes is cut into as many blocks and this rank's is kept (the
        dim must hold its full extent; its backward pads with zeros). The
        counterpart of the reference's ``with_sharding_constraint`` at the
        points where an activation goes from replicated to sharded."""
        self._mesh()
        for d, entry in enumerate(spec):
            n = self.size(entry)
            if n > 1:
                if x.shape[d] % n:
                    raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                     f"split over {entry!r} ({n} ranks)")
                x = x.chunk(n, dim=d)[self.index(entry)]
        return x

    def gather(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The inverse of :meth:`constrain`: each dim whose entry names axes
        all-gathered over them (backward: the reduce-scatter)."""
        self._mesh()
        for d, entry in enumerate(spec):
            for a in reversed(_axes(entry)):
                x = all_gather(x, d, self, a)
        return x

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over the ranks along ``axes`` (backward: the same sum)."""
        self._mesh()
        for a in _axes(axes):
            x = psum(x, self, a)
        return x

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.psum(x, axes) / self.size(axes)

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
        """Sum over ``axis`` and keep this rank's block of ``dim``
        (backward: the all-gather)."""
        self._mesh()
        if self.shape[axis] == 1:
            return x
        return _ReduceScatter.apply(x, dim, self.group(axis),
                                    self.shape[axis])


# ---------------------------------------------------------------------------
# collectives with their transposes as backward
# ---------------------------------------------------------------------------

def _gather_fwd(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter_fwd(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _sum_fwd(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, x, dim, group, n):
        fn_ctx.args = (dim, group, n)
        return _gather_fwd(x, dim, group, n)

    @staticmethod
    def backward(fn_ctx, g):
        return _scatter_fwd(g, *fn_ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, x, dim, group, n):
        fn_ctx.args = (dim, group, n)
        return _scatter_fwd(x, dim, group, n)

    @staticmethod
    def backward(fn_ctx, g):
        return _gather_fwd(g, *fn_ctx.args), None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, x, group):
        fn_ctx.group = group
        return _sum_fwd(x, group)

    @staticmethod
    def backward(fn_ctx, g):
        return _sum_fwd(g, fn_ctx.group), None


def all_gather(x: torch.Tensor, dim: int, ctx: ShardCtx,
               axis: str) -> torch.Tensor:
    """``x`` concatenated along ``dim`` over the ranks of ``axis`` (x itself
    on an axis of one rank)."""
    n = ctx.shape[axis]
    return x if n == 1 else _AllGather.apply(x, dim, ctx.group(axis), n)


def psum(x: torch.Tensor, ctx: ShardCtx, axis: str) -> torch.Tensor:
    n = ctx.shape[axis]
    return x if n == 1 else _PSum.apply(x, ctx.group(axis))


def tp_part(ctx: Optional[ShardCtx], w: torch.Tensor, dim: int,
            full: int) -> torch.Tensor:
    """This tp rank's block of ``w`` along ``dim`` (``full`` entries long in
    the model): ``w`` itself when it is already the block (its rule put it
    on the tp axis), else the block cut from the whole (a replicated
    weight; its grad is then summed over tp after backward)."""
    if ctx is None or ctx.tp_size == 1:
        return w
    if w.shape[dim] == full:
        return ctx.constrain(w, *((None,) * dim + (ctx.tp_axis,)))
    if w.shape[dim] * ctx.tp_size == full:
        return w
    raise ValueError(f"dim {dim} of {tuple(w.shape)} is neither {full} nor "
                     f"its block over {ctx.tp_size} tp ranks")


def tp_whole(ctx: Optional[ShardCtx], w: torch.Tensor, dim: int,
             full: int) -> torch.Tensor:
    """``w`` whole along ``dim``: gathered over tp when its rule put it
    there."""
    if ctx is None or w.shape[dim] == full:
        return w
    return ctx.gather(w, *((None,) * dim + (ctx.tp_axis,)))


# a rule: (path regex, spec builder). Spec entries are logical axis names
# resolved against the ctx; "tp*" means "tp if divisible else None".
Rule = Tuple[str, Tuple[Optional[str], ...]]

RULES: Sequence[Rule] = (
    (r"embed/table$",                ("tp*", None)),
    (r"^head$",                      ("fsdp*", "tp*")),
    (r"frontend/(fc1|fc2|proj)$",    ("fsdp*", "tp*")),
    # --- attention (GQA) ---
    (r"attn/wq$",                    ("fsdp*", "tp*")),
    (r"attn/w[kv]$",                 ("fsdp*", "kv*")),
    (r"attn/wo$",                    ("tp*", "fsdp*")),
    (r"attn/bq$",                    ("tp*",)),
    (r"attn/b[kv]$",                 ("kv*",)),
    # --- MLA ---
    (r"attn/w_dkv$",                 ("fsdp*", None)),
    (r"attn/w_u[kv]$",               ("fsdp*", "tp*")),
    # --- dense mlp ---
    (r"mlp/w_(gate|up)$",            ("fsdp*", "tp*")),
    (r"mlp/w_down$",                 ("tp*", "fsdp*")),
    # --- moe ---
    (r"moe/router$",                 ("fsdp*", None)),
    (r"moe/w_(gate|up)$",            ("tp*", "fsdp*", None)),
    (r"moe/w_down$",                 ("tp*", None, "fsdp*")),
    (r"moe/shared/w_(gate|up)$",     ("fsdp*", "tp*")),
    (r"moe/shared/w_down$",          ("tp*", "fsdp*")),
    # --- mamba2 (split projections; see models/mamba2.py) ---
    (r"mixer/in_[zx]$",              ("fsdp*", "tp*")),
    (r"mixer/in_[BC]$",              ("fsdp*", None)),
    (r"mixer/in_dt$",                ("fsdp*", "tp*")),
    (r"mixer/conv_x$",               (None, "tp*")),
    (r"mixer/conv_bx$",              ("tp*",)),
    (r"mixer/conv_[BC]$",            (None, None)),
    (r"mixer/(dt_bias|A_log|D)$",    ("tp*",)),
    (r"mixer/norm/scale$",           ("tp*",)),
    (r"mixer/out_proj$",             ("tp*", "fsdp*")),
    # --- rwkv6 ---
    (r"mixer/w[vg]$",                ("fsdp*", "tp*")),
    (r"mixer/w[rk]$",                ("fsdp*", None)),
    (r"mixer/wo$",                   ("tp*", "fsdp*")),
    (r"mixer/(decay_a|mix_a|cm_r)$", ("fsdp*", None)),
    (r"mixer/cm_k$",                 ("fsdp*", "tp*")),
    (r"mixer/cm_v$",                 ("tp*", "fsdp*")),
    # --- zamba site loras ---
    (r"loras/a_[qk]$",               ("fsdp*", None)),
    (r"loras/b_[qk]$",               (None, "tp*")),
)


def _ref_path(name: str) -> Tuple[str, bool]:
    """The reference's path of a port name (``stack.layers.3.attn.wq`` ->
    ``stack/layers/attn/wq``, also for ``/``-joined names), and whether
    the name had a layer index."""
    parts = name.replace(".", "/").split("/")
    kept = [p for p in parts if not p.isdigit()]
    return "/".join(kept), len(kept) < len(parts)


def _tree_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten dicts, NamedTuples and lists (their items keyed by index)
    to path->leaf; a module flattens to its named parameters, and a
    :class:`P` is a leaf."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            v = getattr(tree, k)
            out.update(_tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            out.update(_tree_paths(v, f"{prefix}/{i}" if prefix else str(i)))
    else:
        out[prefix] = tree
    return out


def _rebuild(tree: Any, specs: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with the leaf at each path replaced by
    ``specs[path]``; a module becomes a dict of its parameter names."""
    if isinstance(tree, nn.Module):
        return {n: specs[n] for n, _ in tree.named_parameters()}
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, specs, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), specs,
                                     f"{prefix}/{k}" if prefix else str(k))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, specs,
                                   f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return specs[prefix]


def _resolve(axis: Optional[str], dim: int, cfg: ModelConfig,
             ctx: ShardCtx) -> Optional[str | Tuple[str, ...]]:
    if axis is None:
        return None
    starred = axis.endswith("*")
    base = axis.rstrip("*")
    if base == "kv":
        # GQA kv projections: shard only if kv heads divide tp
        name = ctx.tp_axis
        if name is None:
            return None
        if cfg.n_kv_heads % ctx.tp_size != 0:
            return None
        base, starred = "tp", True
    name = {"tp": ctx.tp_axis, "fsdp": ctx.fsdp_axis}.get(base, base)
    if name is None:
        return None
    size = ctx.shape[name]
    if starred and dim % size != 0:
        return None             # uneven dim -> replicate
    return name


def spec_for_path(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                  ctx: ShardCtx) -> P:
    for pattern, logical in RULES:
        if re.search(pattern, path):
            n_extra = len(shape) - len(logical)
            resolved = tuple(
                _resolve(a, shape[n_extra + i], cfg, ctx)
                for i, a in enumerate(logical))
            return P(*((None,) * n_extra + resolved))
    return P()                   # norms, scalars, biases: replicated


def param_pspecs(cfg: ModelConfig, params: Any, ctx: ShardCtx) -> Any:
    """Specs matching ``params``: a model (a dict of its parameter names
    comes back) or a tree of tensors; only names and shapes are read. A
    per-layer leaf gets the reference's spec of its stacked path, without
    the layer dim (the rules apply to trailing dims)."""
    flat = _tree_paths(params)
    specs = {p: spec_for_path(_ref_path(p)[0], tuple(v.shape), cfg, ctx)
             for p, v in flat.items()}
    return _rebuild(params, specs)


# ---------------------------------------------------------------------------
# input/output specs per shape kind
# ---------------------------------------------------------------------------

def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardCtx
                 ) -> Dict[str, P]:
    """PartitionSpecs for the input dict (batch over all dp axes)."""
    b = ctx.dp_axes if shape.global_batch % ctx.dp_size == 0 else (
        ctx.dp_axes[0] if shape.global_batch % ctx.shape[ctx.dp_axes[0]] == 0
        else None)
    specs: Dict[str, P] = {}
    if cfg.frontend.kind == "audio_frames":
        specs["features"] = P(b, None, None)
        specs["labels"] = P(b, None)
        return specs
    specs["tokens"] = P(b, None)
    if shape.kind == "train":
        specs["labels"] = P(b, None)
    if cfg.frontend.kind == "vision_patches":
        specs["image_embeds"] = P(b, None, None)
    return specs


def cache_pspecs(cfg: ModelConfig, caches: Any, ctx: ShardCtx) -> Any:
    """Decode caches: batch dim over dp; kv-heads/value dims over tp where
    divisible. The reference's rule is written for stacked caches (leading
    layer dim, batch next); the port's are per layer, so each per-layer
    leaf gets the rule's spec of a stack of one, without the layer dim.
    batch=1 (long_500k) leaves the batch dim unsharded — state/cap dims
    carry the parallelism instead."""
    def leaf_spec(path: str, shp: Tuple[int, ...]) -> P:
        if path.endswith("length"):
            return P(*((None,) * len(shp)))
        # stacked leading layer dim + batch next
        b_axes = ctx.dp_axes if shp[1] % ctx.dp_size == 0 else None
        spec: list = [None, b_axes]
        rest = len(shp) - 2
        trailing: list = [None] * rest
        if ctx.tp_axis is not None and rest >= 1:
            tp = ctx.shape[ctx.tp_axis]
            if "shared_kv" in path or "/k" in path or "/v" in path:
                # KV cache (layers, B, cap, n_kv, hd): shard kv heads when
                # divisible, else split-KV (cap dim) — bounds per-device
                # cache bytes AND parallelizes decode attention over tp.
                # Very long contexts (>=128k) ALWAYS split-KV: the cap dim is
                # the memory, and cap/tp beats heads/tp when batch is tiny
                # (zamba2 long_500k: 12.2 -> 0.8 GiB/device).
                long_ctx = rest >= 2 and shp[2] >= 131072
                if rest >= 2 and shp[3] % tp == 0 and not long_ctx:
                    trailing[1] = ctx.tp_axis
                elif shp[2] % tp == 0:
                    trailing[0] = ctx.tp_axis
            elif path.endswith("/h"):
                # ssm state (layers,B,G,HG,P,N): shard HG
                if shp[3] % tp == 0:
                    trailing[1] = ctx.tp_axis
            elif path.endswith("/s"):
                # rwkv state (layers,B,H,Nk,Nv): shard value dim
                if shp[-1] % tp == 0:
                    trailing[-1] = ctx.tp_axis
            elif path.endswith("/conv"):
                if shp[-1] % tp == 0:
                    trailing[-1] = ctx.tp_axis
        return P(*(spec + trailing))

    specs = {}
    for p, leaf in _tree_paths(caches).items():
        path, per_layer = _ref_path(p)
        shp = tuple(leaf.shape)
        specs[p] = (P(*leaf_spec(path, (1,) + shp)[1:]) if per_layer
                    else leaf_spec(path, shp))
    return _rebuild(caches, specs)


def make_ctx(mesh, sequence_parallel: bool = False) -> ShardCtx:
    """The context of a ``DeviceMesh``, which it carries; or, with no mesh,
    of anything with its ``mesh_dim_names`` and ``shape`` (axes only: the
    spec functions take it, every collective raises)."""
    axes = tuple(mesh.mesh_dim_names)
    if "pod" in axes:
        dp = ("pod", "data")
    else:
        dp = ("data",)
    return ShardCtx(axis_names=axes, axis_sizes=tuple(mesh.shape),
                    dp_axes=dp, fsdp_axis="data",
                    tp_axis="model" if "model" in axes else None,
                    sequence_parallel=sequence_parallel,
                    mesh=mesh if hasattr(mesh, "get_group") else None)


# ---------------------------------------------------------------------------
# specs onto a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d`` names, ``Replicate()`` on the others. A dim
    sharded over several axes (``("pod", "data")``) must name them in the
    mesh's order, the order in which DTensor splits it."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or any(out[i] != Replicate() for i in idx):
            raise ValueError(f"spec {spec!r}: axes {axes} out of the mesh's "
                             f"order {names} or used twice")
        for i in idx:
            out[i] = Shard(d)
    return out


def distribute_params(params: Any, specs: Any, mesh) -> Any:
    """Every tensor of ``params`` (a model, or a tree of tensors) as a
    ``DTensor`` on ``mesh`` with the placements of its spec in ``specs``
    (the tree :func:`param_pspecs` gives), in ``params``' structure (a
    dict of parameter names for a model)."""
    spec_flat = _tree_paths(specs)
    placed = {p: distribute_tensor(t.detach(), mesh,
                                   placements(spec_flat[p], mesh))
              for p, t in _tree_paths(params).items()}
    return _rebuild(params, placed)


def _block_of(full: torch.Tensor, mesh, places: Sequence) -> torch.Tensor:
    """This rank's block of ``full`` under DTensor ``places`` on ``mesh``:
    cut along each ``Shard`` dim, mesh dims in order."""
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            full = full.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return full.clone()


@torch.no_grad()
def shard_model(model: nn.Module, cfg: ModelConfig,
                ctx: ShardCtx) -> nn.Module:
    """Lay ``model``'s parameters onto ``ctx``'s mesh in place: each one
    becomes an ``nn.Parameter`` holding a ``DTensor`` with the placements
    of its rule (:func:`param_pspecs`), its local block cut from the
    parameter this rank holds (every rank must hold the same values: the
    same seed, or a checkpoint), with no communication. Returns ``model``."""
    mesh = ctx._mesh()
    specs = param_pspecs(cfg, model, ctx)
    for mod_name, mod in model.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full_name = f"{mod_name}.{name}" if mod_name else name
            places = placements(specs[full_name], mesh)
            local = _block_of(p.detach(), mesh, places)
            setattr(mod, name, nn.Parameter(
                DTensor.from_local(local, mesh, places, run_check=False),
                requires_grad=p.requires_grad))
    return model


# ---------------------------------------------------------------------------
# explicit FSDP weight prefetch
# ---------------------------------------------------------------------------

def _gathered(t: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """A parameter as a plain local tensor with its fsdp axis gathered: a
    ``DTensor``'s local block (differentiable) all-gathered over the fsdp
    axis along the dim placed there; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    names = tuple(t.device_mesh.mesh_dim_names)
    for i, pl in enumerate(t.placements):
        if names[i] == ctx.fsdp_axis and isinstance(pl, Shard):
            local = all_gather(local, pl.dim, ctx, ctx.fsdp_axis)
    return local


def fsdp_gather(subtree: Any, cfg: ModelConfig,
                ctx: Optional[ShardCtx]) -> Any:
    """Every weight of ``subtree`` (a module, a dict or list of them, or a
    tensor) with its fsdp axis removed: the reference constrains each to
    its rule spec without the fsdp axis (ZeRO-3 prefetch inside the model);
    here each ``DTensor`` parameter becomes its local block all-gathered
    over the fsdp axis, so it arrives at the point of use and its grad is
    reduce-scattered back. Modules come back as dicts of their parameters
    and children, lists as lists; a plain tensor (an unsharded model, or a
    weight already gathered) passes through. Without a context it returns
    ``subtree``; a context without a mesh raises."""
    if ctx is None:
        return subtree
    ctx._mesh()

    def walk(tree):
        if isinstance(tree, nn.ModuleList):
            return [walk(m) for m in tree]
        if isinstance(tree, nn.Module):
            out = {n: walk(p) for n, p in tree.named_parameters(
                recurse=False)}
            out.update((n, walk(m)) for n, m in tree.named_children())
            return out
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return _gathered(tree, ctx)
    return walk(subtree)
