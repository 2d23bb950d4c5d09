"""Serving: prefill and decode steps and a continuous-batching session.

Counterpart of ``repro.serve.engine``. The decode batch has fixed slots;
each slot carries its own cache position (per-slot lengths in every cache),
so requests at different depths decode together. A new request is prefilled
on its own (batch 1) and spliced into a free slot; a finished request frees
its slot. PyTorch runs eagerly, so the steps are called as they are, with
no compiled counterpart of the reference's ``jax.jit``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dt, rmsnorm


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_step(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
                 capacity: int) -> Tuple[torch.Tensor, Dict[str, List[Any]]]:
    """Prefill: inputs -> (last-token logits (B,V) fp32, populated caches).
    Runs under ``torch.no_grad()``, as :func:`decode_step` does (through
    ``model.decode_step``): a trainable model served builds no graph."""
    x = M.apply_frontend(params, cfg, inputs).to(dt(cfg.compute_dtype))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, caches = tf.stack_prefill(params["stack"], cfg, x, positions,
                                 capacity)
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return M.logits(params, cfg, x), caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches):
    """One token for every slot: (B,1) -> (logits (B,V), caches)."""
    return M.decode_step(params, cfg, tokens, caches)


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
    step, that were not finite."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 capacity: int, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        on = {p.device.type for p in params.parameters()}
        if on != {self.device.type}:
            raise ValueError(f"params on {sorted(on)}, session on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.capacity = capacity
        self.caches = M.init_decode_state(cfg, batch_slots, capacity,
                                          self.device)
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
        every field of every per-layer cache (KVCache k, v, length; SSMState
        h, the three conv tails, length; RWKVState s, x_tm, x_cm, length)
        has the batch first."""
        for kind, layers in caches_new.items():
            for dst, src in zip(self.caches[kind], layers):
                for d, s in zip(dst, src):
                    d[slot].copy_(s[0])
        self.tokens[slot, 0] = token

    def step(self) -> int:
        """One engine step: admit pending requests, then decode all active
        slots. Returns the number of active requests."""
        while self.queue and self._free_slot() is not None:
            req = self.queue.pop(0)
            slot = self._free_slot()
            t0 = time.perf_counter()
            tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                     device=self.device)
            logits, caches_new = prefill_step(
                self.params, self.cfg, {"tokens": tokens}, self.capacity)
            first = int(greedy_sample(logits)[0])
            self.nonfinite_logits += int((~torch.isfinite(logits)).sum())
            self.timings["prefill"].append(
                (req.request_id, len(req.prompt), time.perf_counter() - t0))
            req.generated.append(first)
            req.slot = slot
            self.slots[slot] = req
            self._splice(slot, caches_new, first)
        if not any(self.slots):
            return 0
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self.tokens, dtype=torch.long,
                                 device=self.device)
        logits, self.caches = decode_step(self.params, self.cfg, tokens,
                                          self.caches)
        nxt = greedy_sample(logits).cpu().numpy()
        self.nonfinite_logits += int((~torch.isfinite(logits)).sum())
        active = sum(r is not None for r in self.slots)
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

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
