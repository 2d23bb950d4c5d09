"""The comparison that decides ``correct`` for a served language model:
the tokens the window served against the plain reference
(``reference/lm.py``), once the window has closed and the program's state
is freed.

A sample of the requests finished in the window, drawn from the seed, with
the one that served the most tokens in it, is run through the reference
teacher-forced (prompt, then the served tokens); at each served position
the served token's logit should be the reference's largest, or lie below
it by no more than rounding moves a near tie. Where fewer requests than
the sample's size finished (a short window), requests still in flight
fill it with the tokens they have served.

- ``missing``: steps in which a request in flight got no token, and
  sampled finished requests that do not hold the tokens they asked for,
  or sampled requests that hold one outside the vocabulary;
- ``nonfinite_logits``: logits the session counted NaN or infinite;
- ``logit_gap_max``: over every served position of the sample, the
  widest gap by which the served token's logit lies below the reference's
  largest (with ``control``, the gap of the token that the reference on
  float8 weights puts first);
- ``logit_gap_mean``: the same gaps' mean over the sample's served
  positions.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import lm as ref_lm


def sample(finished: List, inflight: List, seed: int, k: int) -> List:
    """The finished request with the most served tokens (the earliest of
    equals), and ``k - 1`` others drawn from ``seed``: finished ones, or
    where too few finished, all of them and requests in flight."""
    pool = finished if len(finished) >= k else finished + inflight
    if not pool:
        return []
    longest = max(range(len(pool)),
                  key=lambda i: (len(pool[i].generated), -i))
    rest = [i for i in range(len(pool)) if i != longest]
    rng = np.random.default_rng((seed % 2 ** 64, 2))
    picked = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
    return [pool[longest]] + [pool[rest[i]] for i in sorted(picked)]


def served(finished: List, inflight: List, stalled: int, nonfinite: int,
           config, seed: int, k: int, device: torch.device,
           control: bool = False) -> Dict[str, float]:
    vocab = config["vocab_size"]
    missing = stalled
    seqs = []
    for req in sample(finished, inflight, seed, k):
        toks = list(req.generated)
        if not all(0 <= t < vocab for t in toks) or (
                req.done and len(toks) != req.max_new_tokens):
            missing += 1
        elif toks:
            seqs.append((np.asarray(req.prompt), toks))
    gaps = np.zeros(1)
    if seqs:
        gaps = np.nan_to_num(np.concatenate(ref_lm.served_gaps(
            config, seed, seqs, device, control)), nan=np.inf)
    return {"missing": missing, "nonfinite_logits": nonfinite,
            "logit_gap_max": float(gaps.max()),
            "logit_gap_mean": float(gaps.mean())}
