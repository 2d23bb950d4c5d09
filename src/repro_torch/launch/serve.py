"""Serving launcher: continuous batching driven by a request stream.

Counterpart of ``repro.launch.serve``. By default it serves zamba2-7b at
full width and depth on the card, from random weights made from ``--seed``:
8 requests with prompts of 256 to 2048 tokens (drawn with numpy from the
seed), 32 new tokens each, on 4 slots of a 4096-token cache. ``--arch
rwkv6-3b`` serves rwkv6-3b the same way; its state per slot is O(1), so
the capacity does not bound it. ``--arch qwen3-moe-30b-a3b`` serves the
MoE model (48 layers, 128 experts of 768, top 8; 30.5 B parameters, 61.1
GB in bf16) the same way; one 80 GB card holds it whole. ``--arch
deepseek-v2-lite-16b`` serves MLA attention (16 heads, q and k 192 wide, a
latent cache of 512 + 64 per token) over 64 experts of 1408, top 6, with 2
shared experts and a dense first layer (27 layers; 15.7 B parameters, 31.4
GB in bf16). ``--arch kimi-linear-48b-a3b --held-experts 64`` serves
Kimi-Linear (20 KDA and 7 NoPE MLA layers) as one card of a four-card
expert-parallel deployment: it holds experts 0-63 of 256 and computes
their part (13.8 B parameters, 27.6 GB in bf16; all 256 would not fit).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --device cpu --prompt-len 8 24 --max-new 4 --capacity 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --smoke --device cpu --prompt-len 8 24 --max-new 4 --capacity 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --smoke --device cpu --prompt-len 8 24 \
        --max-new 4 --capacity 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --smoke --device cpu --prompt-len 8 24 \
        --max-new 4 --capacity 64
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.registry import (canonical, get_config,
                                          get_smoke_config)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeSession


def draw_prompts(vocab: int, requests: int = 8,
                 prompt_len: Union[int, Sequence[int]] = (256, 2048),
                 seed: int = 0) -> List[np.ndarray]:
    """The prompts :func:`main` serves: ``requests`` int32 arrays whose
    lengths are ``prompt_len`` or drawn uniformly in the ``(lo, hi)`` range,
    ends included, then their tokens, all from numpy's generator at
    ``seed``."""
    lo, hi = (prompt_len, prompt_len) if isinstance(prompt_len, int) \
        else prompt_len
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, requests)
    return [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lengths]


def main(arch: str = "zamba2-7b", smoke: bool = False, requests: int = 8,
         slots: int = 4,
         prompt_len: Union[int, Sequence[int]] = (256, 2048),
         max_new: int = 32, capacity: int = 4096, seed: int = 0,
         device: DeviceLike = "cuda", verbose: bool = True,
         held_experts: Optional[int] = None) -> Dict:
    """Serve the ``requests`` prompts of :func:`draw_prompts` once and
    return ``finished`` (the requests, in order of completion), ``cfg``,
    ``session`` (the drained :class:`ServeSession`, its weights and caches
    still on the device) and ``phases``: ``init_s`` (making the weights),
    ``serve_s`` (the whole session), ``prefill`` (per request: id, prompt
    tokens, seconds to the first token, prompt tokens/s), ``decode_steps``,
    ``decode_tokens``
    (tokens over all slots), ``decode_s``, ``decode_tokens_per_s`` and
    ``nonfinite_logits`` (count over every logit the session computed).
    Host seconds, each ending with the device done. ``held_experts``
    holds that many routed experts, from the first, of a MoE model."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    cfg = get_smoke_config(canonical(arch)) if smoke \
        else get_config(canonical(arch))
    if held_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, held_experts=held_experts, held_from=0))

    def sync() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync()
    params = M.init_model(torch.Generator(device=dev).manual_seed(seed), cfg)
    init_s = sync() - t0
    n_params = sum(p.numel() for p in params.parameters())
    say(f"[serve] {cfg.name}{' (smoke)' if smoke else ''} on {dev}: "
        f"{n_params / 1e9:.3f} B parameters, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.param_dtype}; init {init_s:.2f}s")

    sess = ServeSession(params, cfg, batch_slots=slots, capacity=capacity,
                        device=dev)
    for rid, prompt in enumerate(draw_prompts(cfg.vocab, requests,
                                              prompt_len, seed)):
        sess.submit(Request(request_id=rid, prompt=prompt,
                            max_new_tokens=max_new))
    t0 = sync()
    finished = sess.run_to_completion()
    serve_s = sync() - t0

    decode = sess.timings["decode"]
    decode_s = sum(s for _, s in decode)
    decode_tokens = sum(n for n, _ in decode)
    phases = {
        "init_s": init_s, "serve_s": serve_s,
        "prefill": [{"request": rid, "tokens": n, "s": s,
                     "tokens_per_s": n / s}
                    for rid, n, s in sess.timings["prefill"]],
        "decode_steps": len(decode), "decode_tokens": decode_tokens,
        "decode_s": decode_s,
        "decode_tokens_per_s": decode_tokens / decode_s if decode_s else 0.0,
        "nonfinite_logits": sess.nonfinite_logits,
    }
    for p in phases["prefill"]:
        say(f"[serve] request {p['request']}: prefill {p['tokens']} tokens "
            f"in {p['s']:.4f}s ({p['tokens_per_s']:.1f} tokens/s)")
    say(f"[serve] {len(finished)} requests, "
        f"{sum(len(r.generated) for r in finished)} tokens in {serve_s:.2f}s; "
        f"decode {len(decode)} steps, {decode_tokens} tokens over {slots} "
        f"slots in {decode_s:.2f}s ({phases['decode_tokens_per_s']:.1f} "
        f"tokens/s)")
    return {"finished": finished, "cfg": cfg, "session": sess,
            "phases": phases}


def cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-7b",
                    help="zamba2-7b, rwkv6-3b, qwen3-moe-30b-a3b, "
                         "deepseek-v2-lite-16b, or another ported dense-GQA "
                         "config")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, nargs="+", default=[256, 2048],
                    help="a length, or LO HI for lengths drawn in [LO, HI]")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--held-experts", type=int, default=None,
                    help="routed experts this card holds, from the first")
    a = ap.parse_args()
    if len(a.prompt_len) not in (1, 2):
        ap.error("--prompt-len takes one length or LO HI")
    out = main(arch=a.arch, smoke=a.smoke, requests=a.requests,
               slots=a.slots,
               prompt_len=(a.prompt_len[0], a.prompt_len[-1]),
               max_new=a.max_new, capacity=a.capacity, seed=a.seed,
               device=a.device, held_experts=a.held_experts)
    for r in sorted(out["finished"], key=lambda r: r.request_id)[:4]:
        print(f"  req {r.request_id}: {r.generated}")


if __name__ == "__main__":
    cli()
