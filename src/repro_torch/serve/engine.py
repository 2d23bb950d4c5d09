"""Serving: prefill and decode steps and a continuous-batching session.

Counterpart of ``repro.serve.engine``. The decode batch has fixed slots;
each slot carries its own cache position (per-slot lengths in every cache),
so requests at different depths decode together. A new request is prefilled
on its own (batch 1) and spliced into a free slot; a finished request frees
its slot. PyTorch runs eagerly, so the steps are called as they are, with
no compiled counterpart of the reference's ``jax.jit``.

``prefill_step`` and the session take a mesh context (``ctx``), as the
reference's do: the prefill then runs over the mesh (each rank its block
of the prompt rows where they split over the data-parallel axes, its block
of heads, the kernels on plain local tensors) and gives back the logits
whole and the caches laid out by ``cache_pspecs`` (``model.shard_caches``),
each rank its blocks, as they come out of the layers: nothing is
gathered. ``decode_step`` with a context keeps the caches so from one
step to the next, each mixer on its shard, as the reference's decode is
partitioned over those layouts; the session's caches are laid out so and
take each prefilled request's blocks.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import fsdp_gather, local, row_axes
from repro_torch.models import kda as kda_mod
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dt, rmsnorm


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_step(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
                 capacity: int, ctx=None
                 ) -> Tuple[torch.Tensor, Dict[str, List[Any]]]:
    """Prefill: inputs -> (last-token logits (B,V) fp32, populated caches).
    Runs under ``torch.no_grad()``, as :func:`decode_step` does (through
    ``model.decode_step``): a trainable model served builds no graph. Over
    a mesh (``ctx``) every rank passes the whole inputs and gets the whole
    logits back, and the caches as ``model.shard_caches`` lays them out
    for :func:`decode_step`; rows that do not split over the
    data-parallel axes (a batch of one) run on every rank."""
    rows = None
    if ctx is not None:
        ctx = dataclasses.replace(ctx, sequence_parallel=False)
        batch = next(iter(inputs.values())).shape[0]
        rows = row_axes(ctx, batch)
        inputs = {k: ctx.constrain(v, rows) for k, v in inputs.items()}
    x = M.apply_frontend(params, cfg, inputs, ctx).to(dt(cfg.compute_dtype))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    place = None
    if ctx is not None:
        whole = M.init_decode_state(cfg, batch, capacity,
                                    torch.device("meta"))

        def place(kind: str, i: int, c):
            """A layer's cache in the decode's layout: only the lengths
            gathered (the layout keeps every row's on every rank)."""
            if rows is not None:
                c = c._replace(length=ctx.gather(c.length, rows))
            return M.shard_caches({kind: [c]}, cfg, ctx,
                                  whole={kind: [whole[kind][i]]})[kind][0]
    x, caches = tf.stack_prefill(params["stack"], cfg, x, positions,
                                 capacity, ctx, place)
    final_norm = params["final_norm"]
    if ctx is not None:
        final_norm = fsdp_gather(final_norm, cfg, ctx)
    x = rmsnorm(final_norm, x[:, -1], cfg.norm_eps)
    logits = M.logits(params, cfg, x, ctx)
    if rows is not None:
        logits = ctx.gather(logits, rows)
    return logits, caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches,
                ctx=None):
    """One token for every slot: (B,1) -> (logits (B,V), caches). Over a
    mesh (``ctx``) every rank passes the whole tokens and gets the whole
    logits back, and ``caches`` are ``model.shard_caches``' (each rank its
    blocks), which it returns advanced."""
    if ctx is None:
        return M.decode_step(params, cfg, tokens, caches)
    rows = row_axes(ctx, tokens.shape[0])
    logits, caches = M.decode_step(params, cfg, ctx.constrain(tokens, rows),
                                   caches, ctx)
    return ctx.gather(logits, rows), caches


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# continuous batching session (host-side orchestration)
# ---------------------------------------------------------------------------

@dataclass
class Request:
    request_id: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False


class ServeSession:
    """Fixed-slot continuous batching over a single decode batch, on
    ``device`` (where ``params`` must live).

    ``timings`` holds host seconds, each taken after the step's result has
    come back to the host (which waits for the device): ``"prefill"`` is a
    list of ``(request_id, prompt tokens, seconds)``, the time to the first
    token; ``"decode"`` a list of ``(active slots, seconds)`` per step.
    ``nonfinite_logits`` counts the logits, over every prefill and decode
    step, that were not finite.

    Into the tracer that `repro_torch.core.telemetry.recording` made
    current, on ``time.perf_counter()`` and track ``host``, each step
    records ``serve.step``, with a ``serve.prefill`` a request it admits
    (``request``, ``tokens``) and one ``serve.decode`` (``active`` slots,
    ``device_s`` between CUDA events on a card) whose children are the
    stack's spans a layer (`repro_torch.models.transformer.stack_decode`);
    and the counters ``serve.tokens`` (tokens returned, first tokens
    included), ``serve.prefill_tokens``, ``serve.kda_state_bytes`` (a
    decode step's KDA state, read and written once a slot and layer, and
    the KDA weights once) and ``serve.latent_positions`` (the positions
    the MLA layers' decode attended, over the active slots). Without a
    recording it reads no extra clock and makes no event. With ``ctx`` every prefill runs over its
    mesh (:func:`prefill_step`) and so does every decode step, on caches
    laid out by ``model.shard_caches`` (:func:`decode_step`); ``params``
    are plain tensors, whole on every rank, or the model laid out by
    ``shard_model``."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 capacity: int, device: DeviceLike = "cuda", ctx=None):
        self.device = resolve_device(device)
        on = {p.device.type for p in params.parameters()}
        if on != {self.device.type}:
            raise ValueError(f"params on {sorted(on)}, session on "
                             f"{self.device}")
        if ctx is not None and cfg.kda is not None:
            raise ValueError("a model with KDA layers is not served over a "
                             "mesh")
        self.params = params
        self.cfg = cfg
        self.ctx = ctx
        self.B = batch_slots
        self.capacity = capacity
        self.caches = M.init_decode_state(cfg, batch_slots, capacity,
                                          self.device)
        if ctx is not None:
            self.caches = M.shard_caches(self.caches, cfg, ctx)
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.timings: Dict[str, list] = {"prefill": [], "decode": []}
        self.nonfinite_logits = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _splice(self, slot: int, caches_new, token: int) -> None:
        """Copy a prefilled single-request cache into batch slot ``slot``:
        every field of every per-layer cache (KVCache k, v, length; KDAState
        s and the three conv tails, so a reused slot starts from the
        request's own state; SSMState h, the three conv tails, length;
        RWKVState s, x_tm, x_cm, length) has the batch first. Over a mesh both are ``DTensor``s laid out
        alike along every dim but the batch (the request's one row on
        every rank): this rank's block of the request's row goes into its
        row, where the slot is among this rank's rows."""
        for kind, layers in caches_new.items():
            for dst, src in zip(self.caches[kind], layers):
                for d, s in zip(dst, src):
                    if isinstance(d, DTensor):
                        _splice_block(d, s, slot)
                    else:
                        d[slot].copy_(s[0])
        self.tokens[slot, 0] = token

    def step(self) -> int:
        """One engine step: admit pending requests, then decode all active
        slots. Returns the number of active requests."""
        tr = telemetry.current()
        if not tr.enabled:
            return self._step(None)
        since = len(tr.spans)
        with tr.region("serve.step", time.perf_counter(), track="host") as sp:
            n = self._step(tr)
            sp.t_end = time.perf_counter()
        telemetry.settle_device_s(tr, since)
        return n

    def _step(self, tr) -> int:
        while self.queue and self._free_slot() is not None:
            req = self.queue.pop(0)
            slot = self._free_slot()
            t0 = time.perf_counter()
            tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                     device=self.device)
            logits, caches_new = prefill_step(
                self.params, self.cfg, {"tokens": tokens}, self.capacity,
                self.ctx)
            first = int(greedy_sample(logits)[0])
            self.nonfinite_logits += int((~torch.isfinite(logits)).sum())
            t1 = time.perf_counter()
            self.timings["prefill"].append(
                (req.request_id, len(req.prompt), t1 - t0))
            if tr is not None:
                tr.span("serve.prefill", t0, t1, request=req.request_id,
                        tokens=len(req.prompt))
                tr.metrics.counter("serve.prefill_tokens").inc(
                    len(req.prompt))
                tr.metrics.counter("serve.tokens").inc(1)
            req.generated.append(first)
            req.slot = slot
            self.slots[slot] = req
            self._splice(slot, caches_new, first)
        if not any(self.slots):
            return 0
        t0 = time.perf_counter()
        active = sum(r is not None for r in self.slots)
        if tr is None:
            nxt, logits, _ = self._decode(False)
        else:
            ev0 = telemetry.device_event(self.device)
            with tr.region("serve.decode", t0, active=active) as sp:
                nxt, logits, ev1 = self._decode(True)
                sp.t_end = time.perf_counter()
            sp.attrs["device_s"] = (ev0, ev1) if ev0 is not None else None
            self._count_decode(tr, active)
        self.nonfinite_logits += int((~torch.isfinite(logits)).sum())
        self.timings["decode"].append((active, time.perf_counter() - t0))
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.generated.append(tok)
            self.tokens[i, 0] = tok
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
        return sum(r is not None for r in self.slots)

    def _decode(self, event: bool):
        """One decode step of every slot: (the greedy tokens on the host,
        the logits, and with ``event`` a CUDA event recorded after them or
        None); the caches advanced."""
        tokens = torch.as_tensor(self.tokens, dtype=torch.long,
                                 device=self.device)
        logits, self.caches = decode_step(self.params, self.cfg, tokens,
                                          self.caches, self.ctx)
        ev = telemetry.device_event(self.device) if event else None
        return greedy_sample(logits).cpu().numpy(), logits, ev

    def _count_decode(self, tr, active: int) -> None:
        """The counters of a recorded decode step (see the class)."""
        tr.metrics.counter("serve.tokens").inc(active)
        mixers = [tf._mixer(self.cfg, i) for i in range(self.cfg.n_layers)]
        if self.cfg.kda is not None:
            weights = sum(p.numel() * p.element_size() for n, p in
                          self.params.named_parameters() if ".kda." in n)
            tr.metrics.counter("serve.kda_state_bytes").inc(
                2 * mixers.count("kda") * self.B
                * kda_mod.state_bytes(self.cfg) + weights)
        if self.cfg.attention == "mla":
            # the token fed to slot i sits at position prompt + generated - 1
            seen = sum(len(r.prompt) + len(r.generated) for r in self.slots
                       if r is not None)
            tr.metrics.counter("serve.latent_positions").inc(
                mixers.count("attn") * seen)

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished


def _splice_block(dst: DTensor, src: torch.Tensor, slot: int) -> None:
    """Write the request's row of ``src`` (this rank's block of it) into
    batch row ``slot`` of the ``DTensor`` leaf ``dst``, when this rank's
    block of rows holds ``slot``."""
    mesh, block = dst.device_mesh, dst.to_local()
    row0 = 0
    for i, pl in enumerate(dst.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            row0 = row0 * mesh.size(i) + mesh.get_local_rank(i)
    row0 *= block.shape[0]
    if row0 <= slot < row0 + block.shape[0]:
        block[slot - row0].copy_(local(src)[0])
