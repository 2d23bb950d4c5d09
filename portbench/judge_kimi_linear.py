"""The comparison that decides ``correct`` for the served Kimi-Linear:
``judge_lm.py``'s sample (``judge_lm.sample``) run through
``reference/kimi_linear.py`` teacher-forced, and what the first KDA layer
and the first MLA layer keep of requests still in flight when the window
closed (their slot's state, their latent cache) set beside the
reference's.

- ``missing`` and ``nonfinite_logits``: as ``judge_lm.py``'s;
- ``logit_gap_mean``: over every served position of the sample, the mean
  gap by which the served token's logit lies below the reference's
  largest (with ``control``, the gap of the token that the reference on
  float8 weights puts first);
- ``kda_state_gap``: over the requests of :func:`state_sample`, the
  largest relative distance ``|S - S_ref| / |S_ref|`` (Frobenius norms)
  between the state (H, K, V) the program's first layer holds in the
  request's slot and the reference's after the same tokens (with
  ``control``, the float8 reference's state in the program's place). The
  first layer reads the embeddings alone, so its state is the KDA state's
  own precision and the slot's history, without the rounding of the 26
  layers before the logits;
- ``mla_latent_gap``: the same of what the first MLA layer (layer 4)
  cached at every position of those requests, ``[c_kv, k_rope]`` (S, 576),
  against the reference's after its own first three layers: the
  positions' treatment (NoPE), three layers from the embeddings.

The widest single gap is not compared: at 27 layers of the cell's weights
it saturates near 2 in the program and in the control alike.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.judge_lm import sample
from portbench.reference import kimi_linear as ref_kl


def state_sample(inflight: List) -> List:
    """The requests whose slot state the check reads: of those in flight
    that hold a slot, the one that has served the most tokens (the
    earliest of equals) and the one admitted last, whose slot an earlier
    request held wherever a request has finished."""
    live = [r for r in inflight if r.generated and not r.done]
    if not live:
        return []
    longest = max(live, key=lambda r: (len(r.generated), -r.request_id))
    newest = max(live, key=lambda r: r.request_id)
    return [longest] if newest is longest else [longest, newest]


def state_tokens(req) -> np.ndarray:
    """The tokens a slot's state has taken in: the prompt and every served
    token but the last, which no step has fed back yet."""
    return np.concatenate([np.asarray(req.prompt, np.int64),
                           np.asarray(req.generated[:-1], np.int64)])


def kept_gaps(config, seed: int,
              kept: Sequence[Tuple[np.ndarray, torch.Tensor, torch.Tensor]],
              device: torch.device, control: bool = False
              ) -> Tuple[List[float], List[float]]:
    """``|X - X_ref| / |X_ref|`` of the state and of the latent cache, for
    each ``(tokens, state, latent)``."""
    toks = [t for t, _, _ in kept]

    def gaps(of, got):
        refs = of(config, seed, toks, device)
        if control:
            got = of(config, seed, toks, device, control=True)
        return [float((g.to(device).float() - r).norm() / r.norm())
                for g, r in zip(got, refs)]
    if not kept:
        return [], []
    return (gaps(ref_kl.kda_states, [s for _, s, _ in kept]),
            gaps(ref_kl.mla_latents, [c for _, _, c in kept]))


def served(finished: List, inflight: List, stalled: int, nonfinite: int,
           config, seed: int, k: int, device: torch.device,
           control: bool = False,
           kept: Sequence[Tuple[np.ndarray, torch.Tensor, torch.Tensor]] = ()
           ) -> Dict[str, float]:
    """The check's numbers; ``kept`` are the ``(tokens, state, latent)``
    of :func:`state_sample`'s requests, read before the program was
    freed."""
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
        gaps = np.nan_to_num(np.concatenate(ref_kl.served_gaps(
            config, seed, seqs, device, control)), nan=np.inf)
    state, latent = (np.nan_to_num(g, nan=np.inf) for g in kept_gaps(
        config, seed, kept, device, control))
    return {"missing": missing, "nonfinite_logits": nonfinite,
            "logit_gap_mean": float(gaps.mean()),
            "kda_state_gap": float(np.max(state, initial=0.0)),
            "mla_latent_gap": float(np.max(latent, initial=0.0))}
