"""Per-rank cost of a program as PyTorch dispatches it.

Counterpart of ``repro.distributed.hlo_cost``, which parses the compiled
(post-SPMD) HLO text of one partition. The port runs eagerly: there is no
HLO to parse, and each rank's program already holds its local shards, as
a partition's HLO does. So :class:`OpCost` is a ``TorchDispatchMode``
that counts every aten op, kernel op and collective as it is dispatched
(on fake tensors for a dry run: `repro_torch.launch.dryrun`):

  flops        ``torch.utils.flop_counter.FlopCounterMode``'s total: mm,
               bmm, addmm, baddbmm, convolution and the kernel ops'
               registered formulas (`repro_torch.kernels`); its counts by
               op are kept too (the models are functions of their
               parameters, so every count lands in its ``Global`` entry).
               Elementwise and reduction ops count no FLOPs, as the
               flop counter counts them.
  bytes        operand plus result bytes of every op that moves data (views
               and allocations without a write move none): the HBM-traffic
               proxy of ``hlo_cost``. Eager PyTorch fuses nothing, so every
               op counts; ``hlo_cost`` counts a fusion once.
  collectives  the ring model of ``hlo_cost`` on the c10d ops that
               `repro_torch.distributed.sharding` issues and on those of
               DTensor's redistributions, P the ranks of the op's group:
                 all-gather      (P-1)/P * result bytes
                 reduce-scatter  (P-1)/P * operand bytes
                 all-reduce      2(P-1)/P * result bytes
                 all-to-all      (P-1)/P * operand bytes
                 any other       operand bytes
               split by whether the group's ranks lie in more than one pod
               (``cross_pod_collective_bytes``) or in one
               (``on_pod_collective_bytes``); ranks are laid out pod-major,
               as ``init_device_mesh`` lays a ("pod", ...) mesh.

``hlo_cost`` multiplies a ``while`` body by its trip count; eager dispatch
runs every layer and every microbatch, so nothing needs scaling, unless the
caller traces one iteration of a loop for all of them
(:meth:`OpCost.repeated`).

The mode also tracks memory: the bytes of every storage an op creates,
while some tensor holds it (a weak reference a storage), over the storages
the caller declares live beforehand (:meth:`OpCost.hold`). ``peak_bytes``
is the most held at once.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_PG_TYPE = "__torch__.torch.classes.c10d.ProcessGroup"

# (kind, which bytes the ring model reads: "result" or "operand") by op name
_KINDS = {
    "_allgather_base_": ("all-gather", "result"),
    "allgather_": ("all-gather", "result"),
    "allgather_into_tensor_coalesced_": ("all-gather", "result"),
    "all_gather_into_tensor": ("all-gather", "result"),
    "all_gather_into_tensor_out": ("all-gather", "result"),
    "_reduce_scatter_base_": ("reduce-scatter", "operand"),
    "reduce_scatter_": ("reduce-scatter", "operand"),
    "reduce_scatter_tensor": ("reduce-scatter", "operand"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "operand"),
    "allreduce_": ("all-reduce", "result"),
    "allreduce_coalesced_": ("all-reduce", "result"),
    "all_reduce": ("all-reduce", "result"),
    "all_reduce_": ("all-reduce", "result"),
    "alltoall_base_": ("all-to-all", "operand"),
    "alltoall_": ("all-to-all", "operand"),
    "all_to_all_single": ("all-to-all", "operand"),
}
# ops whose first tensor argument is the result they write into
_WRITES_FIRST = {"_allgather_base_", "allgather_", "alltoall_base_",
                 "alltoall_", "_reduce_scatter_base_", "reduce_scatter_",
                 "allgather_into_tensor_coalesced_",
                 "reduce_scatter_tensor_coalesced_"}
# ops that move no data: fresh allocations (no write) and aliases
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view", "wait_tensor", "_local_scalar_dense"}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` that hold data: a meta tensor (shapes only,
    such as the whole caches whose shapes the sharded prefill reads) holds
    and moves nothing."""
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.device.type != "meta"]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_ranks(args, kwargs) -> Optional[List[int]]:
    """The global ranks of the process group a collective names: a boxed
    ``ProcessGroup`` (the c10d ops) or a group name (the functional ops)."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name() == _PG_TYPE:
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
        if isinstance(a, str):
            try:
                pg = dist.distributed_c10d._resolve_process_group(a)
            except (KeyError, ValueError, RuntimeError):
                continue
            return dist.get_process_group_ranks(pg)
    return None


class OpCost(TorchDispatchMode):
    """Counts what is dispatched under it (see the module's docstring).
    ``world`` ranks laid out pod-major over ``n_pods`` pods (the default
    group's size unless given). Enter it inside the ``FakeTensorMode`` of
    a dry run; read :meth:`summary` after."""

    def __init__(self, n_pods: int = 1, world: Optional[int] = None):
        super().__init__()
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        self.pod_size = max(1, world // max(1, n_pods))
        self.flop_counter = FlopCounterMode(display=False)
        self.bytes = 0.0
        self.on_pod_collective_bytes = 0.0
        self.cross_pod_collective_bytes = 0.0
        self.collectives: Dict[str, float] = defaultdict(float)
        self._extra_flops: Dict[str, float] = defaultdict(float)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()     # storage -> its bytes
        self._stack = contextlib.ExitStack()

    # -- entering ------------------------------------------------------------
    def __enter__(self):
        self._stack.enter_context(self.flop_counter)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        return out

    # -- memory --------------------------------------------------------------
    def hold(self, tree: Any) -> int:
        """Declare the tensors of ``tree`` live before the program (its
        arguments): their storages are not counted again when an op writes
        them or views them. Returns their bytes, each storage once."""
        total = 0
        for t in _tensors(tree):
            st = _storage(t)
            if st is not None and st not in self._seen:
                self._seen[st] = st.nbytes()
                total += st.nbytes()
        return total

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = _storage(t)
            if st is None or st in self._seen:
                continue
            n = self._seen[st] = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    # -- counting ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self._collective(name, args, kwargs, out)
        elif not func.is_view and name not in _NO_TRAFFIC:
            outs = _tensors(out)
            if outs:
                self.bytes += _nbytes(_tensors((args, kwargs))) + \
                    _nbytes(outs)
        self._track(out)
        return out

    def _collective(self, name: str, args, kwargs, out) -> None:
        if name == "wait_tensor" or name == "barrier":
            return
        kind, reads = _KINDS.get(name, (name, "operand"))
        ts = _tensors((args, kwargs))
        if name in _WRITES_FIRST:
            result = _tensors(args[0])
            operand = _tensors(args[1])
        elif name in ("allreduce_", "allreduce_coalesced_", "all_reduce_"):
            result = operand = _tensors(args[0])
        else:                                   # functional: input -> output
            operand = ts
            result = _tensors(out)
        ranks = _group_ranks(args, kwargs) or [0]
        P = len(ranks)
        n = _nbytes(result if reads == "result" else operand)
        if kind == "all-reduce":
            wire = 2.0 * n * (P - 1) / P
        elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
            wire = n * (P - 1) / P
        else:
            wire = float(n)
        if len({r // self.pod_size for r in ranks}) > 1:
            self.cross_pod_collective_bytes += wire
        else:
            self.on_pod_collective_bytes += wire
        self.collectives[kind] += wire
        self.bytes += _nbytes(result) + _nbytes(operand)

    # -- loops ---------------------------------------------------------------
    @contextlib.contextmanager
    def repeated(self, n: int) -> Iterator[None]:
        """Count what runs inside ``n`` times: the body of a loop of ``n``
        identical iterations traced once (memory is not scaled: the
        iterations run one after another)."""
        before = self._totals()
        yield
        after = self._totals()
        self.bytes += (n - 1) * (after["bytes"] - before["bytes"])
        self.on_pod_collective_bytes += (n - 1) * (
            after["on_pod"] - before["on_pod"])
        self.cross_pod_collective_bytes += (n - 1) * (
            after["cross_pod"] - before["cross_pod"])
        for k in set(after["coll"]) | set(before["coll"]):
            self.collectives[k] += (n - 1) * (
                after["coll"].get(k, 0.0) - before["coll"].get(k, 0.0))
        for k in set(after["flops"]) | set(before["flops"]):
            self._extra_flops[k] += (n - 1) * (
                after["flops"].get(k, 0) - before["flops"].get(k, 0))

    def _totals(self) -> Dict[str, Any]:
        return {"bytes": self.bytes, "on_pod": self.on_pod_collective_bytes,
                "cross_pod": self.cross_pod_collective_bytes,
                "coll": dict(self.collectives), "flops": self._raw_flops()}

    def _raw_flops(self) -> Dict[str, int]:
        counts = self.flop_counter.get_flop_counts().get("Global", {})
        return {str(k): v for k, v in counts.items()}

    # -- results -------------------------------------------------------------
    def flops_by_op(self) -> Dict[str, float]:
        out = dict(self._raw_flops())
        for k, v in self._extra_flops.items():
            out[k] = out.get(k, 0) + v
        return out

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_op().values()))

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "on_pod_collective_bytes": self.on_pod_collective_bytes,
                "cross_pod_collective_bytes":
                    self.cross_pod_collective_bytes,
                "collectives": dict(self.collectives)}


def _storage(t: torch.Tensor):
    """The untyped storage holding ``t``'s data (a DTensor's local
    block's); None for a tensor without one."""
    local = getattr(t, "_local_tensor", None)
    t = t if local is None else local
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
