"""``serve_closed``'s closed loop over one serving session, for
Kimi-Linear: the weights from ``gen/kimi_linear.py``, the session from
``program_kimi_linear.py`` (or the program's own ``serve_kimi_linear``,
which the tests give a broken program), the check against
``reference/kimi_linear.py``, with what the first KDA layer and the
first MLA layer keep of two requests in flight (state, latent cache)
copied off the session before it is freed. The window, its accounting
and the mix's parameters are ``serve_closed``'s.

Each client's first request starts with ``first`` (the generator's
shares, a permutation of 1/n, 2/n, ..., 1) times the mix's mean answer
left to serve, or its whole answer where that is shorter: the steady
state of a closed loop leaves a client's request ``r`` tokens from its end
with a density of 1 / (mean answer) for every ``r`` below the shortest
answer, so the requests that finish in the window, and the prefills that
follow them, are as many in every seed (``serve_closed`` takes ``first``
of each request's own answer, so their number varies with the seed's
pairing of answers and shares, and with it the rate).

A ``--trace 1`` run makes a recording of the port's tracing current over
the window and copies into ``run.timings`` what the readers need: the
device seconds of the ``serve.decode`` spans (``decode_device_s``) and of
their ``serve.decode.kda`` children (``kda_device_s``), the decode steps
recorded (``decode_steps``) and the ``serve.kda_state_bytes`` counter
(``kda_state_bytes``).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch

from portbench import judge_kimi_linear
from portbench import program_kimi_linear as program_kl
from portbench.gen import kimi_linear as gen_kl
from portbench.loops import serve_closed
from portbench.loops.serve_closed import Serving, _account, _request, _send


def prepare(config, mix, seed: int, device: torch.device) -> Serving:
    clients, first = gen_kl.requests(config, mix, seed)
    return Serving(config, mix, seed, device,
                   gen_kl.model(config, seed, device), clients, first,
                   turn=[0] * len(clients))


def warmup(st: Serving, program) -> None:
    st.control = bool(getattr(program, "lm_control", False))
    build = getattr(program, "serve_kimi_linear", None)
    args = (st.config, st.weights, int(st.mix["batch_slots"]),
            int(st.mix["capacity"]))
    st.session = (build(*args) if build is not None
                  else program_kl.serve_session(*args, st.device))
    st.weights = None                    # the session holds them now
    st.session.submit(_request(
        st, gen_kl.warmup_prompt(st.config, st.mix, st.seed), 2))
    st.session.step()
    mean = np.mean([a for reqs in st.clients for _, a in reqs])
    for c in range(len(st.clients)):
        _send(st, c, min(1.0, float(st.first[c]) * mean
                         / st.clients[c][0][1]))
    st.session.step()
    _account(st, None)


def window(sess, st: Serving) -> None:
    if sess.run.timings is None:         # not a --trace 1 run
        serve_closed.window(sess, st)
        return
    tr = program_kl.tracer()
    with program_kl.recording(tr):
        serve_closed.window(sess, st)

    def device_s(name):
        return sum(s.attrs.get("device_s") or 0.0 for s in tr.spans
                   if s.name == name)
    counters = tr.metrics.snapshot()["counters"]
    sess.run.timings.update(
        decode_device_s=device_s("serve.decode"),
        kda_device_s=device_s("serve.decode.kda"),
        decode_steps=sum(s.name == "serve.decode" for s in tr.spans),
        kda_state_bytes=counters.get("serve.kda_state_bytes", 0.0))


def judge(st: Serving, answers, requests, device) -> Dict[str, float]:
    nonfinite = st.session.nonfinite_logits
    inflight = list(st.inflight.values())
    kept = []
    for r in judge_kimi_linear.state_sample(inflight):
        toks = judge_kimi_linear.state_tokens(r)
        kept.append((toks,
                     program_kl.first_kda_state(st.session, r.slot).cpu(),
                     program_kl.first_mla_latent(st.session, r.slot,
                                                 len(toks)).cpu()))
    st.session = None                    # the program's state goes first
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = judge_kimi_linear.served(
        st.finished, inflight, st.stalled, nonfinite, st.config, st.seed,
        int(st.mix["judged"]), device, control=st.control, kept=kept)
    print(f"[portbench] the check: {len(st.finished)} requests finished in "
          f"the window; the reference took {time.perf_counter() - t!r} s",
          file=sys.stderr)
    return numbers
