"""Closed loop of clients over one serving session: each client sends its
next request when its last is answered, and every engine step is one
request of the harness (``step``), whose items are the tokens it returned
to the host.

Set-up draws the weights on the device (``gen/lm.py``), builds the
program's session on them, serves one prompt of the mix's longest length
(two tokens), then submits every client's first request, each with only
its share (``first``) of its answer left to serve, and runs one step, which
prefills them all: the window opens on a full batch in its steady state.

Mix parameters: ``clients``, ``requests_per_client`` (each client's list,
served in turn and again from its start when it runs out),
``batch_slots``, ``capacity``, ``prompt_tokens`` and ``answer_tokens``
(``[lo, hi]``), ``judged`` (requests compared with the reference).
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import judge_lm
from portbench.gen import lm as gen_lm


@dataclass
class Serving:
    config: Dict
    mix: Dict
    seed: int
    device: torch.device
    weights: Optional[List[Dict]]
    clients: List[List]
    first: np.ndarray
    session: Any = None
    control: bool = False
    inflight: Dict[int, Any] = field(default_factory=dict)  # client -> req
    served: Dict[int, int] = field(default_factory=dict)    # id -> tokens
    turn: List[int] = field(default_factory=list)           # client -> next
    finished: List[Any] = field(default_factory=list)       # in the window
    stalled: int = 0
    next_id: int = 0


def prepare(config, mix, seed: int, device: torch.device) -> Serving:
    clients, first = gen_lm.requests(config, mix, seed)
    return Serving(config, mix, seed, device,
                   gen_lm.model(config, seed, device), clients, first,
                   turn=[0] * len(clients))


def _request(st: Serving, prompt: np.ndarray, tokens: int):
    from portbench.program import serve_request
    req = serve_request(st.next_id, prompt, tokens)
    st.next_id += 1
    st.served[req.request_id] = 0
    return req


def _send(st: Serving, client: int, share: float = 1.0) -> None:
    reqs = st.clients[client]
    prompt, answer = reqs[st.turn[client] % len(reqs)]
    st.turn[client] += 1
    req = _request(st, prompt, max(1, math.ceil(answer * share)))
    st.inflight[client] = req
    st.session.submit(req)


def warmup(st: Serving, program) -> None:
    st.control = bool(getattr(program, "lm_control", False))
    st.session = program.serve_session(st.config, st.weights,
                                       int(st.mix["batch_slots"]),
                                       int(st.mix["capacity"]))
    st.weights = None                    # the session holds them now
    st.session.submit(_request(
        st, gen_lm.warmup_prompt(st.config, st.mix, st.seed), 2))
    st.session.step()
    for c in range(len(st.clients)):
        _send(st, c, float(st.first[c]))
    st.session.step()
    _account(st, None)


def _account(st: Serving, meta: Optional[Dict]) -> int:
    """After a step: the tokens each request in flight got (and, into
    ``meta``, the tokens the step processed and the positions they
    attended over), a stall for each that got none, and the next request
    of each client whose last one is done. Returns the tokens returned."""
    returned = processed = attended = 0
    for c, req in list(st.inflight.items()):
        k0, k1 = st.served[req.request_id], len(req.generated)
        st.served[req.request_id] = k1
        if k1 == k0:
            st.stalled += meta is not None
            continue
        returned += k1 - k0
        S = len(req.prompt)
        if k0 == 0:                      # the prefill: S tokens, causal
            processed += S
            attended += S * (S + 1) // 2
            k0 = 1
        # served token k is computed from token k-1 at position S+k-1
        processed += k1 - k0
        attended += sum(S + k for k in range(k0, k1))
        if req.done:
            if meta is not None:
                st.finished.append(req)
            _send(st, c)
    if meta is not None:
        meta.update(processed=processed, attended=attended)
    return returned


def window(sess, st: Serving) -> None:
    timings = sess.run.timings
    n_prefill = len(st.session.timings["prefill"])
    sess.start()
    while True:
        sess.request("step", st.session.step, items=0, key=None)
        req = sess.run.requests[-1]
        if req.ok:
            req.items = _account(st, req.meta)
        if sess.over():
            break
    if timings is not None:
        timings["prefill"] = sum(
            s for _, _, s in st.session.timings["prefill"][n_prefill:])


def judge(st: Serving, answers, requests, device) -> Dict[str, float]:
    nonfinite = st.session.nonfinite_logits
    st.session = None                    # the program's state goes first
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = judge_lm.served(st.finished, list(st.inflight.values()),
                              st.stalled, nonfinite, st.config, st.seed,
                              int(st.mix["judged"]), device,
                              control=st.control)
    print(f"[portbench] the check: {len(st.finished)} requests finished in "
          f"the window; the reference took {time.perf_counter() - t!r} s",
          file=sys.stderr)
    return numbers
