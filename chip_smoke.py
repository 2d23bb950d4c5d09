#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a, one
   nvcc per source, all started together; then one ``[ptxas]`` line per
   kernel function from the build logs (registers, spills, stack) and the
   dynamic shared memory of the tensor-core kernels' blocks.
3. Kernels vs their plain versions on the card. ``hedm_reduce`` at the test
   shapes (float32 and uint16), ragged shapes (widths 1, 3, 131 and 1027,
   heights 1, 5 and 67, uint16 with an odd width) and at (8, 2048, 2048):
   masks and counts equal (``torch.equal``). ``flash_attention`` at the shapes of
   tests/test_kernels.py in float32 and bfloat16, at ragged S (100, 200),
   at the zamba2 prefill shape (1, 2048, 32 heads, 32 kv, hd 112) and a
   danube3-like GQA shape with a window (1, 2048, 32, 8, 120, window
   1024). ``mamba2_scan`` at the shapes of tests/test_kernels.py, a ragged
   L (100) and the zamba2 prefill shape (1, 2048, 112 heads, P 64, G 1,
   N 64). Both also at the path's widths and every prompt length the LM
   main path (phase 8) draws, in bfloat16: each of those prefills has a
   ragged last tile and chunk; and at the tensor-core kernels' tile edges
   in bfloat16 (attention S = 127, 128, 129, 255; the scan L = 127, 129).
   bfloat16 runs on the tensor-core kernels, float32 on the CUDA-core
   ones (the wrappers' dispatch rule). Float32 within 3e-5 (attention) and
   2e-4 (scan) of the plain version; bfloat16 against the plain version run in
   float32 on the same bf16 inputs, within 1e-3 (attention) or 2e-2 (scan)
   plus one bf16 rounding step, 2^-7 |ref|, of each output value. Then
   the NF-HEDM path's stages on a small scan against the CPU: stage 1 bit
   for bit, stage 2 within 1e-4. ``rwkv6_wkv`` at the shapes of
   tests/test_kernels.py, a prime L (97), a strong decay (w in [1e-4,
   0.1], where a kernel that split the exponent would give inf) and the
   rwkv6-3b prefill widths (1, L, 40, 64) with a decay like the model's
   (~0.98): float32 and bfloat16 at L = 2048, bfloat16 at every prompt
   length of the main path and at the tensor-core kernel's chunk edges
   (L = 1, 15, 16, 17, 33, 97 at chunks 16, 32 and 64); bfloat16 runs on
   ``wkv6_tc``, float32 and N = 8 on ``wkv6``. Output in float32 within
   2e-4 (test shapes) or 2e-4 + 1e-5 |ref| (path widths), in bfloat16
   within 1e-3 + 2^-7 |ref|; the float32 state within 2e-4 + 1e-5 |ref| in
   every case. ``flash_attention`` also at qwen3-moe-30b-a3b's prefill
   widths, (1, S, 32 heads, 4 kv heads, hd 128) bf16 causal, at each of the
   eight prompt lengths and at S = 2048, each call on ``flash_fwd_tc``; and
   at deepseek-v2-lite-16b's MLA prefill widths, (1, S, 16, 16, hd 192)
   causal with v zero-padded from 128 as the model pads it, in bf16 at the
   eight lengths, 2048 and the tile edges 127, 128 and 129, each on
   ``flash_fwd_tc`` (1e-3 + 2^-7 |ref|), and in float32 on ``flash_fwd`` at
   127, 129 and 1024 (3e-5). ``flash_attention`` also at internvl2-2b's
   prefill widths, (1, S, 16 heads, 8 kv heads, hd 128) bf16 causal, at
   256 image tokens + each of the eight served text lengths, at 256 + 1024
   (phase 10's prefill) and at 2048;
   and at hubert-xlarge's encoder widths, (1, S, 16, 16, hd 80)
   non-causal, bf16 at 127, 128, 129, 1024 and 2048, each bf16 call on
   ``flash_fwd_tc`` (1e-3 + 2^-7 |ref|), and float32 at 2048 on
   ``flash_fwd`` (3e-5).
4. The NF-HEDM main path: ``repro_torch.hedm.interactive.main`` at the
   paper's size, 736 frames of 2048x2048 and 100,000 grid points.
   4b. The streamed and multi-session drivers at 2048x2048:
   ``repro_torch.hedm.streaming.main`` over 64 frames (1.07 GB of float32,
   reduce windows of 8, a node cache of 16), the streamed output equal to
   the batch output bit for bit; ``repro_torch.hedm.service.main`` over 3
   scans of 16 frames under a budget of 2 scans, every session's output
   equal to direct reduction byte for byte. Each driver's ``hedm_reduce``
   launches are counted from 0 and must be one per reduce window and one
   per batch or direct reduction; its simulated turnaround, wall seconds
   and device time (``torch.profiler``) are printed.
5. Timing of ``hedm_reduce`` at (736, 2048, 2048) float32 (CUDA events,
   median of 20 launches after warm-up) beside its HBM bound and its plain
   version, which is first held equal to the kernel on all 736 frames;
   from that one time, the port's ``nf_reduction`` row
   (benchmarks/paper_figures.py:91-108): microseconds a frame and the
   736-frame time beside the paper's 106 s on 320 cores.
6. Serving on the card against the CPU at smoke size: zamba2-7b,
   h2o-danube3-4b, rwkv6-3b, qwen3-moe-30b-a3b and deepseek-v2-lite-16b
   smoke configs in float32, the same seed-made weights on both devices;
   prefill logits and
   one decode step within 1e-4 relative, and a 4-request ``ServeSession``
   with identical token ids. Then internvl2-2b's and hubert-xlarge's smoke
   configs (the vision and audio frontends) forward, logits within 1e-4;
   and two ``make_train_step`` steps of qwen3-32b's smoke config (2
   microbatches, remat): the losses, AdamW's m and v (element-wise) and
   every updated parameter (normwise) within 1e-4 relative of the CPU run.
7. Prefill + decode == forward (``inference=True``, the MoE capacity of
   prefill and decode) at full width, float32 on the card, S=1024:
   zamba2-7b at d_model 3584 with 12 layers (2 shared-attention sites),
   rwkv6-3b at d_model 2560 (40 heads of 64) with 4 layers, qwen3-moe at
   d_model 2048 (128 experts of 768, 32/4 heads of 128) with 4 layers,
   deepseek-v2-lite at d_model 2048 (16 MLA heads, latent 512 + rope 64,
   64 experts of 1408) with 4 layers (1 dense, 3 MoE): the MLA prefill on
   ``flash_fwd`` at hd 192; internvl2-2b at d_model 2048 with 4 layers,
   256 image + 768 text tokens; relative error < 5e-3 (tests/test_serve.py's
   bound), MoE configs where nothing is dropped.
8. The LM main path: ``repro_torch.launch.serve.main``, zamba2-7b at full
   width and depth (81 layers), bf16, random weights from seed 0; 8
   requests with prompts of 256..2048 tokens (numpy seed 0), 32 new tokens
   each, 4 slots, capacity 4096. Every logit finite; ``flash_attention``
   launched 8 x 13 and ``mamba2_scan`` 8 x 81 times, every launch on the
   tensor-core kernel (``launches_tc``). Then the drained
   session serves its first four prompts again under ``torch.profiler``:
   the step that admits them (4 prefills, 1 decode step) and the 4 decode
   steps after it give the card's busy share (kernel time over wall time).
   8b. The same for rwkv6-3b at full width and depth (32 layers, d_model
   2560), once the zamba2 session is freed: the same prompts, ``rwkv6_wkv``
   launched 8 x 32 times, every launch on the tensor-core kernel, and no
   other kernel.
   8c. The same for qwen3-moe-30b-a3b at full width and depth (48 layers,
   128 experts of 768, top 8; 30.5 B parameters in bf16), once the rwkv6
   session is freed: ``flash_attention`` launched 8 x 48 times, every
   launch on ``flash_fwd_tc``, and no other kernel; peak device memory.
   8d. The same for deepseek-v2-lite-16b at full width and depth (27
   layers, MLA, 64 experts of 1408, top 6, 2 shared; 15.7 B parameters
   in bf16), once the qwen3-moe session is freed: ``flash_attention``
   launched 8 x 27 times at hd 192, every launch on ``flash_fwd_tc``, and
   no other kernel.
9. Timing of ``flash_attention``, ``mamba2_scan`` and ``rwkv6_wkv`` at the
   paths' shapes (S = L = 2048, bf16; the decay float32; attention at
   zamba2's (32, 32, 112), qwen3-moe's (32, 4, 128) and deepseek's (16,
   16, 192, v padded from 128)), median of 20
   launches by CUDA events after warm-up (the card kept busy while the
   host enqueues, so host launch time is not counted), beside each one's
   bound, its plain version, for attention
   ``torch.nn.functional.scaled_dot_product_attention`` (with
   ``enable_gqa=True`` at qwen3-moe's shape, on the unpadded q/k (192) and
   v (128) at deepseek's, naming the backend it picked; the port never
   calls it),
   and for each the CUDA-core kernel on the same bf16 inputs
   (the earlier design). ``rwkv6_wkv`` prints two bounds: its products at
   the tensor-core rate (as the scan's), its ``bound_ms``, and every
   operation at the fp32 rate, the earlier design's bound, in the
   ``[time]`` line only; and the device time of each of its three launches
   (``torch.profiler``). K2 also at internvl2-2b's (1, 2048, 16, 8, 128)
   causal (SDPA with ``enable_gqa``) and hubert-xlarge's (1, 2048, 16, 16,
   80) non-causal (SDPA naming its backend).
10. The frontends' inference on K2 at full width and depth, bf16, random
   weights from seed 0: internvl2-2b ``prefill_step`` of 256 image + 1024
   text tokens then 16 greedy decode steps (TTFT, decode tokens/s), then
   hubert-xlarge ``forward`` on (1, 2048, 512) features, once the first
   model is freed; 24 and 48 K2 launches, all on ``flash_fwd_tc``, no other
   kernel, every logit finite, peak device memory.
11. Training at full width and depth in bf16 on the plain mixers (the
   kernels have no backward): internvl2-2b, then hubert-xlarge once the
   first is freed; a batch of 4 (internvl2: 256 image embeddings from a
   numpy seed and 768 text tokens from a ``StagedLoader`` over token shards
   staged collectively on the simulator, its staging report printed;
   hubert: 1024 frames of 512 features, labels from 504 clusters),
   microbatches 2, remat on, the reference launcher's ``OptConfig`` (peak
   1e-3, warmup 2), 8 steps on the repeated batch: the loss falls, every
   loss and grad norm finite, no K2, K3 or K4 launch. Step seconds,
   tokens/s, peak memory and 6 N tokens / step time (N without the token
   table, a lookup) as a share of 989 TFLOP/s; one more step traced by
   ``torch.profiler`` (busy share, top five kernels).
   11b. ``repro_torch.launch.train.main`` on the card: smoke qwen3-32b, 20
   steps, checkpoints every 10, a failure injected before step 15: one
   restart, the state restored at step 10 equal byte for byte to the one
   saved, no kernel launched.

Each main path (4, 4b, 8, 8b, 8c, 8d, 10, 11 and 11b) runs with every
launch count set to 0 just before and read just after. The last three lines of standard
output are the card's ``nvidia-smi`` line, the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.
"""
import argparse
import ctypes
import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
# fp32 operations per pixel: subtract, clamp, the median from sorted columns
# at strips of 8 (12 column sorts of 6 and 10 medians of 12 min/max for 8
# pixels: 24), Laplacian (7 adds, 1 mul, 1 sub), two compares, one and, one
# count add
HEDM_OPS_PER_PIXEL = 39
FRAMES, SIZE = 736, 2048           # the paper's NF-HEDM layer
GRID_POINTS = 100_000
CHUNK = 8                          # frames per plain-version call


#: hedm_reduce's ragged shapes (F, H, W, frame type): widths 1, 3, 131 and
#: 1027, heights 1, 5 and 67, and uint16 with an odd width (the strips'
#: scalar path and the border copies of the median)
RAGGED_HEDM = [(2, 1, 7, "float32"), (2, 5, 1, "float32"),
               (1, 1, 1, "float32"), (2, 67, 131, "float32"),
               (1, 5, 1027, "float32"), (2, 5, 3, "float32"),
               (2, 67, 131, "uint16"), (1, 5, 1027, "uint16")]


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_cases(np):
    """(name, frames, dark, threshold) cases of the port's tests."""
    cases = []
    rng = np.random.default_rng(0)
    f = rng.integers(0, 40, (4, 64, 64)).astype(np.float32)
    f[1, 10:13, 40:43] += 3000
    cases.append(("spot", f, np.full((64, 64), 8.0, np.float32), 150.0))
    for H, W in [(64, 64), (72, 48), (40, 56), (21, 24)]:
        rng = np.random.default_rng(3)
        f = rng.integers(0, 40, (2, H, W)).astype(np.float32)
        f[0, H // 2:H // 2 + 3, W // 2:W // 2 + 3] += 3000
        f[1, 0:3, 0:3] += 3000
        cases.append((f"tiled-{H}x{W}", f, np.full((H, W), 8.0, np.float32),
                      150.0))
    for seed in range(5):
        for H, W in [(24, 24), (20, 16), (21, 24)]:
            f = np.random.default_rng(seed).integers(0, 400, (2, H, W))
            cases.append((f"noisy-s{seed}-{H}x{W}", f.astype(np.float32),
                          np.zeros((H, W), np.float32), 150.0))
    f = np.random.default_rng(1).integers(0, 30, (2, 96, 96))
    cases.append(("pure-noise", f.astype(np.float32),
                  np.full((96, 96), 10.0, np.float32), 500.0))
    cases += [(f"u16-{n}", f.astype(np.uint16), d, t)
              for n, f, d, t in cases[:]]
    rng = np.random.default_rng(11)
    cases.append(("u16-full-range",
                  rng.integers(0, 65536, (2, 33, 40)).astype(np.uint16),
                  rng.uniform(0, 30000, (33, 40)).astype(np.float32), 5000.0))
    for F, H, W, dtype in RAGGED_HEDM:
        f = np.random.default_rng(H * W).integers(0, 400, (F, H, W))
        cases.append((f"ragged-{H}x{W}-{np.dtype(dtype).name}",
                      f.astype(dtype), np.full((H, W), 8.0, np.float32),
                      150.0))
    return cases


def ptxas_summary(log):
    """One line per kernel function of a build log (``-Xptxas=-v``): its
    demangled-enough name, registers, spills, stack and static shared
    memory, and any compiler warning about it."""
    import re
    if not log.exists():
        return ["no build log (library built earlier)"]
    out, name, stack = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            for short in ("flash_fwd_tc", "flash_fwd", "ssd_scan_tc",
                          "ssd_scan", "wkv6_tc_decay", "wkv6_tc_walk",
                          "wkv6_tc_out",
                          "wkv6", "hedm_reduce_kernel"):
                if short in name:
                    tmpl = re.search(r"I((?:13__nv_bfloat16|Li\d+E|f|t)+)E",
                                     name)
                    args = re.findall(r"13__nv_bfloat16|Li\d+E|f|t",
                                      tmpl.group(1)) if tmpl else []
                    arg = ",".join({"13__nv_bfloat16": "bf16", "f": "f32",
                                    "t": "u16"}.get(a, a[2:-1])
                                   for a in args)
                    name = f"{short}<{arg}>" if arg else short
                    break
        elif "stack frame" in line:
            stack = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {stack}")
            name = None
        elif "warning" in line.lower() or "Performance Loss" in line:
            out.append(line.strip())
    return out


def time_ms(torch, fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events).
    Before each run the card spins for ~1 ms (``torch.cuda._sleep``) while
    the host enqueues ``fn``, so the events time the device's work and not
    the host's launch latency (PR 15's times included it)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)

# flash_attention checks: (B, S, H, KV, hd, causal, window), types
BOTH = ("float32", "bfloat16")
FLASH_CHECKS = [
    *[(shape, BOTH) for shape in [            # tests/test_kernels.py:17-23
        (2, 256, 8, 4, 64, True, 0), (1, 256, 4, 4, 128, True, 64),
        (2, 128, 8, 2, 32, False, 0), (1, 512, 8, 8, 64, True, 0),
        (1, 256, 16, 4, 64, True, 128)]],
    ((1, 100, 4, 2, 112, True, 0), BOTH),     # ragged S
    ((1, 200, 8, 2, 120, True, 48), BOTH),
    ((1, 2048, 32, 32, 112, True, 0), ("bfloat16",)),   # zamba2 prefill
    ((1, 2048, 32, 8, 120, True, 1024), ("bfloat16",)),  # danube3-like GQA
    # the tensor-core kernel's tile edges (128 query rows, 64 keys a tile)
    *[((1, S, 32, 32, 112, True, 0), ("bfloat16",)) for S in (127, 128, 129,
                                                             255)],
]
# mamba2_scan checks: (B, L, H, P, G, N, chunk), types
SCAN_CHECKS = [
    *[(shape, BOTH) for shape in [            # tests/test_kernels.py:59-63
        (2, 128, 4, 16, 2, 8, 32), (1, 64, 2, 32, 1, 16, 16),
        (1, 256, 8, 16, 8, 8, 64)]],
    ((1, 100, 4, 16, 2, 8, 32), BOTH),        # ragged L
    ((1, 2048, 112, 64, 1, 64, 128), ("bfloat16",)),    # zamba2 prefill
    # the tensor-core kernel's chunk edge (128 steps)
    *[((1, L, 112, 64, 1, 64, 128), ("bfloat16",)) for L in (127, 129)],
]
# rwkv6_wkv checks: (B, L, H, N, chunk), types, decay ("test" is 0.45 +
# 0.5 sigmoid(normal), "strong" uniform in [1e-4, 0.1], "path" about 0.98)
WKV_CHECKS = [
    *[(shape, BOTH, "test") for shape in [    # tests/test_kernels.py:78-84
        (2, 96, 3, 8, 32), (1, 64, 2, 16, 16), (1, 128, 4, 32, 32)]],
    ((1, 97, 3, 16, 32), BOTH, "test"),       # prime L
    ((1, 97, 2, 64, 32), BOTH, "strong"),
    ((1, 2048, 40, 64, 32), BOTH, "path"),    # rwkv6-3b prefill
    # the tensor-core kernel's chunk edges (16-row tiles, chunks 16-64)
    *[((1, L, 4, 64, c), ("bfloat16",), "test")
      for L in (1, 15, 16, 17, 33, 97) for c in (16, 32, 64)],
]
PATH_FLASH = (1, 2048, 32, 32, 112, True, 0)
QWEN_FLASH = (1, 2048, 32, 4, 128, True, 0)      # qwen3-moe-30b-a3b prefill
DEEPSEEK_FLASH = (1, 2048, 16, 16, 192, True, 0)  # deepseek-v2-lite MLA
MLA_V = 128                    # deepseek's v width, zero-padded to 192
INTERNVL_FLASH = (1, 2048, 16, 8, 128, True, 0)   # internvl2-2b prefill
HUBERT_FLASH = (1, 2048, 16, 16, 80, False, 0)    # hubert-xlarge encoder
IMAGE_TOKENS = 256             # internvl2-2b's image prefix
PREFILL_TEXT = 1024            # phase 10's internvl2-2b text tokens
#: K2's timed shapes beside zamba2's, as keys of the kernels line
FLASH_SHAPES_TIMED = ("qwen3_moe", "deepseek_v2_lite", "internvl2", "hubert")
#: hubert's K2 checks (S, type): the 128-row tile's edges, 1024, 2048
HUBERT_CHECKS = [(127, "bfloat16"), (128, "bfloat16"), (129, "bfloat16"),
                 (1024, "bfloat16"), (2048, "bfloat16"), (2048, "float32")]
PATH_SCAN = (1, 2048, 112, 64, 1, 64, 128)
PATH_WKV = (1, 2048, 40, 64, 32)
FLASH_ATOL = {"float32": 3e-5, "bfloat16": 1e-3}
SCAN_ATOL = {"float32": 2e-4, "bfloat16": 2e-2}
WKV_ATOL = {"float32": 2e-4, "bfloat16": 1e-3}
BF16_STEP = 2.0 ** -7          # one rounding step of a bf16 output, relative
STATE_RTOL = 1e-5              # of |ref|: float32 at the path's widths


def path_checks(lengths):
    """The LM main paths' kernel shapes at each of their prompt lengths;
    qwen3-moe's and deepseek's attention also at S = 2048, deepseek's also
    at the 128-row tile's edges."""
    *fw, causal, win = PATH_FLASH
    *qw, _, _ = QWEN_FLASH
    *dw, _, _ = DEEPSEEK_FLASH
    B, _, H, P, G, N, chunk = PATH_SCAN
    Bw, _, Hw, Nw, cw = PATH_WKV
    return ([((fw[0], n, *fw[2:], causal, win), ("bfloat16",))
             for n in lengths],
            [(qw[0], n, *qw[2:], causal, win)
             for n in list(lengths) + [QWEN_FLASH[1]]],
            [(dw[0], n, *dw[2:], causal, win)
             for n in list(lengths) + [DEEPSEEK_FLASH[1], 127, 128, 129]],
            [((B, n, H, P, G, N, chunk), ("bfloat16",)) for n in lengths],
            [((Bw, n, Hw, Nw, cw), ("bfloat16",), "path") for n in lengths])


def flash_inputs(np, torch, shape, dtype, dev, seed=0):
    B, S, H, KV, hd = shape[:5]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev).to(getattr(torch, dtype))
            for s in [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]]


def mla_flash_inputs(np, torch, shape, dtype, dev, seed=0):
    """q, k, v at deepseek's MLA width with v zero-padded from ``MLA_V``
    columns, as ``models/attention.py::mla_flash`` pads it."""
    q, k, v = flash_inputs(np, torch, shape, dtype, dev, seed=seed)
    v[..., MLA_V:] = 0
    return q, k, v


def scan_inputs(np, torch, shape, dtype, dev, seed=0):
    """The distributions of tests/test_kernels.py: x, B, C normal, dt =
    softplus(normal), A = -exp(normal); x, B, C in ``dtype``."""
    B, L, H, P, G, N = shape[:6]
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = f(rng.standard_normal((B, L, H, P))).to(getattr(torch, dtype))
    dt = f(np.log1p(np.exp(rng.standard_normal((B, L, H)))))
    A = f(-np.exp(rng.standard_normal(H)))
    Bm, Cm = (f(rng.standard_normal((B, L, G, N))).to(getattr(torch, dtype))
              for _ in range(2))
    return x, dt, A, Bm, Cm


def wkv_inputs(np, torch, shape, dtype, decay, dev, seed=0):
    """r, k, v, u standard normal (r, k, v in ``dtype``); w float32 from
    the ``decay`` of WKV_CHECKS."""
    B, L, H, N = shape[:4]
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    low = getattr(torch, dtype)
    r, k, v = (f(rng.standard_normal((B, L, H, N))).to(low) for _ in range(3))
    z = rng.standard_normal((B, L, H, N))
    w = {"test": lambda: 0.45 + 0.5 / (1 + np.exp(-z)),
         "strong": lambda: rng.uniform(1e-4, 0.1, z.shape),
         "path": lambda: np.exp(-np.exp(-4 + 0.5 * z))}[decay]()
    return r, k, v, f(w), f(rng.standard_normal((H, N)))


def wkv_err(torch, wk, r, k, v, w, u, chunk, path):
    """max |kernel - plain| over out and s, the plain version in fp32 on
    the same inputs; raises past the tolerance of r's type (bf16 also gets
    one rounding step of each output value, float32 at the path's widths
    1e-5 of it; the state 2e-4 + 1e-5 |ref|)."""
    out, s = wk.rwkv6_wkv(r, k, v, w, u, chunk=chunk)
    o_ref, s_ref = wk.reference(r.float(), k.float(), v.float(), w, u,
                                chunk=chunk)
    torch.cuda.synchronize()
    name = str(r.dtype).split(".")[-1]
    rtol = BF16_STEP if name == "bfloat16" else (STATE_RTOL if path else 0.0)
    do, ds = (out.float() - o_ref).abs(), (s - s_ref).abs()
    ok = bool((do <= WKV_ATOL[name] + rtol * o_ref.abs()).all()
              and (ds <= 2e-4 + STATE_RTOL * s_ref.abs()).all()
              and torch.isfinite(out).all() and torch.isfinite(s).all())
    err = max(float(do.max()), float(ds.max()))
    if not ok:
        raise AssertionError(f"rwkv6_wkv != plain version at "
                             f"{tuple(r.shape)} {name}: max |diff| {err} "
                             f"(atol {WKV_ATOL[name]}, rtol {rtol} on out; "
                             f"2e-4 + {STATE_RTOL} |ref| on s)")
    return err


def flash_err(torch, fa, q, k, v, causal, window, tc=False):
    """max |kernel - plain| with the plain version in fp32 on the same
    inputs; raises past the tolerance of q's type (bf16 also gets one
    rounding step of each output value), and with ``tc`` unless the call
    took the tensor-core kernel ``flash_fwd_tc``."""
    before = fa.flash_attention.launches_tc
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    if tc and fa.flash_attention.launches_tc != before + 1:
        raise AssertionError(f"flash_attention at {tuple(q.shape)} kv "
                             f"{k.shape[2]} did not take flash_fwd_tc")
    ref = fa.reference(q.float(), k.float(), v.float(), causal=causal,
                       window=window)
    torch.cuda.synchronize()
    name = str(q.dtype).split(".")[-1]
    rtol = BF16_STEP if name == "bfloat16" else 0.0
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    if not (torch.isfinite(out).all()
            and (diff <= FLASH_ATOL[name] + rtol * ref.abs()).all()):
        raise AssertionError(f"flash_attention != plain version at "
                             f"{tuple(q.shape)} kv {k.shape[2]} {name} causal "
                             f"{causal} window {window}: max |diff| {err} "
                             f"(atol {FLASH_ATOL[name]}, rtol {rtol})")
    return err


def scan_err(torch, ms, x, dt, A, Bm, Cm, chunk):
    """max |kernel - plain| over y and h, the plain version in fp32 on the
    same inputs; raises past the tolerance of x's type (bf16 y also gets
    one rounding step of its own value)."""
    y, h = ms.mamba2_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y_ref, h_ref = ms.reference(x.float(), dt, A, Bm.float(), Cm.float(),
                                chunk=chunk)
    torch.cuda.synchronize()
    name = str(x.dtype).split(".")[-1]
    rtol = BF16_STEP if name == "bfloat16" else 0.0
    dy = (y.float() - y_ref).abs()
    ok = bool((dy <= SCAN_ATOL[name] + rtol * y_ref.abs()).all()
              and ((h - h_ref).abs() <= SCAN_ATOL[name]).all()
              and torch.isfinite(y).all() and torch.isfinite(h).all())
    err = max(float(dy.max()), float((h - h_ref).abs().max()))
    if not ok:
        raise AssertionError(f"mamba2_scan != plain version at "
                             f"{tuple(x.shape)} G {Bm.shape[2]} N "
                             f"{Bm.shape[3]} {name}: max |diff| {err} (atol "
                             f"{SCAN_ATOL[name]}, rtol {rtol} on y)")
    return err


def check_lm_kernels(np, torch, dev, lengths):
    """Phase 3 for flash_attention, mamba2_scan and rwkv6_wkv, with the
    main paths' shapes at their prompt ``lengths``; returns their max
    |kernel - plain| over all cases."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.kernels import rwkv6_wkv as wk
    flash_path, qwen_path, mla_path, scan_path, wkv_path = path_checks(
        lengths)
    errs = {"flash_attention": 0.0, "mamba2_scan": 0.0, "rwkv6_wkv": 0.0}
    n = 0
    for (*shape, causal, win), dtypes in FLASH_CHECKS + flash_path:
        for name in dtypes:
            q, k, v = flash_inputs(np, torch, shape, name, dev, seed=n)
            errs["flash_attention"] = max(errs["flash_attention"], flash_err(
                torch, fa, q, k, v, causal, win))
            n += 1
    print(f"[check] flash_attention == plain version on {n} inputs "
          f"(max |diff| {errs['flash_attention']:.3g})", flush=True)
    qerr = 0.0
    for n, (*shape, causal, win) in enumerate(qwen_path):
        q, k, v = flash_inputs(np, torch, shape, "bfloat16", dev, seed=500 + n)
        qerr = max(qerr, flash_err(torch, fa, q, k, v, causal, win, tc=True))
    errs["flash_attention"] = max(errs["flash_attention"], qerr)
    print(f"[check] flash_attention at qwen3-moe's widths (1, S, 32, 4, 128) "
          f"bf16 causal, S = {', '.join(str(s[1]) for s in qwen_path)}: "
          f"each on flash_fwd_tc, == plain version within 1e-3 + 2^-7 |ref| "
          f"(max |diff| {qerr:.3g})", flush=True)
    derr = 0.0
    for n, (*shape, causal, win) in enumerate(mla_path):
        q, k, v = mla_flash_inputs(np, torch, shape, "bfloat16", dev,
                                   seed=600 + n)
        derr = max(derr, flash_err(torch, fa, q, k, v, causal, win, tc=True))
    ferr = 0.0
    for n, S in enumerate((127, 129, 1024)):
        shape = (1, S, *DEEPSEEK_FLASH[2:5])
        q, k, v = mla_flash_inputs(np, torch, shape, "float32", dev,
                                   seed=700 + n)
        before = fa.flash_attention.launches_tc
        ferr = max(ferr, flash_err(torch, fa, q, k, v, True, 0))
        if fa.flash_attention.launches_tc != before:
            raise AssertionError("float32 at hd 192 took flash_fwd_tc")
    errs["flash_attention"] = max(errs["flash_attention"], derr, ferr)
    print(f"[check] flash_attention at deepseek-v2-lite's MLA widths (1, S, "
          f"16, 16, 192) causal, v zero-padded from {MLA_V}: bf16 at S = "
          f"{', '.join(str(s[1]) for s in mla_path)}, each on flash_fwd_tc, "
          f"within 1e-3 + 2^-7 |ref| (max |diff| {derr:.3g}); float32 at S = "
          f"127, 129, 1024 on flash_fwd within 3e-5 (max |diff| {ferr:.3g})",
          flush=True)
    # internvl2-2b: the image prefix ahead of each served text length
    ierr = 0.0
    internvl = ([IMAGE_TOKENS + n for n in lengths]
                + [IMAGE_TOKENS + PREFILL_TEXT, INTERNVL_FLASH[1]])
    for n, S in enumerate(internvl):
        q, k, v = flash_inputs(np, torch, (1, S, *INTERNVL_FLASH[2:5]),
                               "bfloat16", dev, seed=800 + n)
        ierr = max(ierr, flash_err(torch, fa, q, k, v, True, 0, tc=True))
    # hubert-xlarge: bidirectional, hd 80; float32 on flash_fwd
    herr = {"bfloat16": 0.0, "float32": 0.0}
    for n, (S, name) in enumerate(HUBERT_CHECKS):
        q, k, v = flash_inputs(np, torch, (1, S, *HUBERT_FLASH[2:5]), name,
                               dev, seed=900 + n)
        before = fa.flash_attention.launches_tc
        herr[name] = max(herr[name], flash_err(
            torch, fa, q, k, v, False, 0, tc=name == "bfloat16"))
        if name == "float32" and fa.flash_attention.launches_tc != before:
            raise AssertionError("float32 at hd 80 took flash_fwd_tc")
    errs["flash_attention"] = max(errs["flash_attention"], ierr,
                                  *herr.values())
    print(f"[check] flash_attention at internvl2-2b's widths (1, S, 16, 8, "
          f"128) bf16 causal, S = {IMAGE_TOKENS} image + the served text "
          f"lengths, phase 10's {IMAGE_TOKENS + PREFILL_TEXT} and 2048 "
          f"({', '.join(map(str, internvl))}): each on "
          f"flash_fwd_tc within 1e-3 + 2^-7 |ref| (max |diff| {ierr:.3g}); "
          f"at hubert-xlarge's (1, S, 16, 16, 80) non-causal: bf16 at S = "
          f"127, 128, 129, 1024, 2048 on flash_fwd_tc (max |diff| "
          f"{herr['bfloat16']:.3g}), float32 at 2048 on flash_fwd within "
          f"3e-5 (max |diff| {herr['float32']:.3g})", flush=True)
    n = 0
    for shape, dtypes in SCAN_CHECKS + scan_path:
        for name in dtypes:
            x, dt, A, Bm, Cm = scan_inputs(np, torch, shape, name, dev, seed=n)
            errs["mamba2_scan"] = max(errs["mamba2_scan"], scan_err(
                torch, ms, x, dt, A, Bm, Cm, shape[6]))
            n += 1
    print(f"[check] mamba2_scan == plain version on {n} inputs "
          f"(max |diff| {errs['mamba2_scan']:.3g})", flush=True)
    n = 0
    for shape, dtypes, decay in WKV_CHECKS + wkv_path:
        for name in dtypes:
            r, k, v, w, u = wkv_inputs(np, torch, shape, name, decay, dev,
                                       seed=n)
            errs["rwkv6_wkv"] = max(errs["rwkv6_wkv"], wkv_err(
                torch, wk, r, k, v, w, u, shape[4], decay == "path"))
            n += 1
    print(f"[check] rwkv6_wkv == plain version on {n} inputs "
          f"(max |diff| {errs['rwkv6_wkv']:.3g})", flush=True)
    return errs


def device_time(torch, fn):
    """``fn()``'s result and, from ``torch.profiler``, the device seconds
    of all its CUDA activity and of its ``hedm_reduce`` kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return out, (sum(e.self_device_time_total for e in ev) / 1e6,
                 sum(e.self_device_time_total for e in ev
                     if "hedm_reduce" in e.key) / 1e6)


def check_hedm_drivers(torch, dev, hr, zero_counts):
    """Phase 4b: the streamed and the multi-session drivers at 2048x2048,
    each with its launch counts set to 0 just before and read just after.
    Returns {driver: hedm_reduce launches}."""
    from repro_torch.hedm import service, streaming
    runs = {
        "streaming": (lambda: streaming.main(
            device=dev, n_frames=64, frame_size=SIZE, verbose=False),
            1 + -(-64 // 8)),                # the batch pass, 8 windows
        "service": (lambda: service.main(
            device=dev, n_frames=16, frame_size=SIZE, verbose=False),
            4 * 3 + 3)}                      # 4 sessions x 3 scans, direct
    launches = {}
    for name, (run, want) in runs.items():
        zero_counts()
        t0 = time.perf_counter()
        out, (busy_s, kernel_s) = device_time(torch, run)
        wall = time.perf_counter() - t0
        launches[name] = hr.hedm_reduce.launches
        if launches[name] != want:
            raise AssertionError(f"the {name} driver launched hedm_reduce "
                                 f"{launches[name]} times, expected {want}")
        phases = json.dumps({k: round(v, 4) for k, v in out["wall"].items()})
        card = (f"card: {busy_s:.4f}s of device activity, hedm_reduce "
                f"{kernel_s * 1e3:.3f} ms (torch.profiler)")
        if name == "streaming":
            st = out["stream"]
            print(f"[hedm-drivers] streaming, 64 frames of {SIZE}x{SIZE} "
                  f"(1.07 GB float32), window 8, cache 16: online == batch "
                  f"bit for bit; hedm_reduce launches {launches[name]} (1 "
                  f"batch + 8 windows); simulated turnaround batch "
                  f"{out['batch_turnaround_s']:.4f}s, online "
                  f"{out['online_turnaround_s']:.4f}s (first results at "
                  f"{out['first_result_s']:.4f}s); stream peak resident "
                  f"{st.peak_resident_bytes / 1e6:.1f} MB, {st.evictions} "
                  f"evictions, stall {st.stall_time:.4f}s; wall "
                  f"{wall:.2f}s {phases}; {card}", flush=True)
        else:
            st = out["stats"]
            print(f"[hedm-drivers] service, 3 scans of 16 frames of "
                  f"{SIZE}x{SIZE}, budget 2 scans, 4 sessions + 1 late: "
                  f"{out['n_outputs']} outputs == direct reduction byte for "
                  f"byte; hedm_reduce launches {launches[name]} (12 session "
                  f"+ 3 direct); {st.stages} stages ({st.restages} "
                  f"re-stages), {st.evictions} evictions; simulated "
                  f"turnaround {out['turnaround_s']:.4f}s, late lease "
                  f"{'hit' if out['late']['hit'] else 're-stage'}; wall "
                  f"{wall:.2f}s {phases}; {card}", flush=True)
        del out
        gc.collect()
    return launches


def rel_err(a, ref):
    return float((a - ref).abs().max() / (ref.abs().max() + 1e-30))


def check_serving_against_cpu(np, torch, dev):
    """Phase 6: the smoke configs on the card and on the CPU."""
    import copy
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeSession, prefill_step
    for arch in ("zamba2_7b", "h2o_danube3_4b", "rwkv6_3b",
                 "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"):
        cfg = get_smoke_config(arch)
        on = {"cpu": M.init_model(torch.Generator().manual_seed(0), cfg)}
        on["cuda"] = copy.deepcopy(on["cpu"]).to(dev)
        toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
        pre, dec, served = {}, {}, {}
        for where, params in on.items():
            t = torch.from_numpy(toks).to(params.embed.table.device)
            logits, caches = prefill_step(params, cfg, {"tokens": t[:, :39]},
                                          capacity=48)
            pre[where] = logits[:, :cfg.vocab].cpu()
            d, _ = M.decode_step(params, cfg, t[:, 39:], caches)
            dec[where] = d[:, :cfg.vocab].cpu()
            sess = ServeSession(params, cfg, batch_slots=2, capacity=48,
                                device=where)
            rng = np.random.default_rng(3)
            for i, n in enumerate((11, 5, 17, 8)):
                sess.submit(Request(i, rng.integers(0, cfg.vocab, n,
                                                    dtype=np.int32), 6))
            served[where] = {r.request_id: r.generated
                             for r in sess.run_to_completion()}
        e_pre = rel_err(pre["cuda"], pre["cpu"])
        e_dec = rel_err(dec["cuda"], dec["cpu"])
        if not (e_pre < 1e-4 and e_dec < 1e-4):
            raise AssertionError(f"{arch} smoke: card vs CPU prefill rel "
                                 f"{e_pre}, decode rel {e_dec} (< 1e-4)")
        if served["cuda"] != served["cpu"] or len(served["cuda"]) != 4:
            raise AssertionError(f"{arch} smoke: session tokens differ: card "
                                 f"{served['cuda']} CPU {served['cpu']}")
        print(f"[check] {cfg.name} smoke, card vs CPU: prefill logits rel "
              f"{e_pre:.3g}, decode rel {e_dec:.3g} (< 1e-4); 4-request "
              f"session tokens identical", flush=True)


def moe_drop_log(moe):
    """Instrument ``moe.moe_ffn`` (restored by calling the returned
    ``restore``): each call appends (capacity, tokens of the busiest expert,
    whether the sequence's last token was dropped at one of its experts)
    to ``log``."""
    real = moe.moe_ffn
    log = []

    def spy(params, cfg, x, ctx=None, inference=False):
        C = moe.expert_capacity(x.shape[1], cfg.moe,
                                moe.INFERENCE_CAPACITY_FACTOR if inference
                                else None)
        routed = moe.route(params["router"], x, cfg.moe)[0] > 0   # (B,S,E)
        earlier = routed[:, :-1].sum(dim=1)
        log.append((C, int(routed.sum(dim=1).max()),
                    bool((routed[:, -1] & (earlier >= C)).any())))
        return real(params, cfg, x, ctx, inference)

    def restore():
        moe.moe_ffn = real
    moe.moe_ffn = spy
    return log, restore


def check_full_width_prefill_decode(np, torch, dev, arch, n_layers):
    """Phase 7: prefill + decode == forward (with the MoE capacity of
    prefill and decode), ``arch`` at full width and ``n_layers`` deep.

    A MoE config is held to it where no token is dropped, as
    tests/test_serve.py holds the smoke configs, whose inference capacity
    is the whole sequence: with the capacity factor raised to E / top_k
    every expert can take every token. At the served factor, 4.0, random
    weights route most tokens to a few experts; the forward over S + 1
    tokens then drops the last token at the experts past capacity, which
    the one-token decode never does. That run is printed with its drops,
    and held only where the forward dropped nothing of the last token."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve.engine import prefill_step
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              param_dtype="float32", compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    S = 1024
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, S + 1))).to(dev)
    image = {}
    if cfg.frontend.kind == "vision_patches":
        # the image's P positions come first: S - P text tokens + 1
        P, feat = cfg.frontend.num_prefix_tokens, cfg.frontend.feature_dim
        toks = toks[:, P:]
        image = {"image_embeds": torch.from_numpy(np.random.default_rng(
            3).standard_normal((2, P, feat)).astype(np.float32)).to(dev)}

    def prefill_decode_vs_forward():
        ref = M.logits(params, cfg, M.forward(
            params, cfg, {"tokens": toks, **image}, inference=True)[0][:, -1])
        _, caches = prefill_step(params, cfg, {"tokens": toks[:, :-1],
                                               **image}, capacity=S + 8)
        dec, _ = M.decode_step(params, cfg, toks[:, -1:], caches)
        if not torch.isfinite(dec).all():
            raise AssertionError(f"{cfg.name}: non-finite decode logits")
        return rel_err(dec[:, :cfg.vocab], ref[:, :cfg.vocab])

    note = ""
    if cfg.moe is not None:
        served = moe.INFERENCE_CAPACITY_FACTOR
        log, restore = moe_drop_log(moe)
        try:
            served_err = prefill_decode_vs_forward()
        finally:
            restore()
        n_moe = n_layers - cfg.moe.first_k_dense   # layers that log
        forward = log[:n_moe]                  # the forward's layers first
        dropped = sum(d for _, _, d in forward)
        if not (served_err < 5e-3 or dropped):
            raise AssertionError(f"{cfg.name}: prefill + decode vs forward "
                                 f"rel {served_err} (< 5e-3) with the last "
                                 f"token dropped in no layer")
        note = (f"; at the served capacity factor {served}: rel "
                f"{served_err:.3g}, the forward's busiest expert took "
                f"{max(n for _, n, _ in forward)} of {S + 1} tokens (C = "
                f"{forward[0][0]}) and the last token was dropped in "
                f"{dropped} of {n_moe} MoE layers, so not held there")
        moe.INFERENCE_CAPACITY_FACTOR = cfg.moe.num_experts / cfg.moe.top_k
        try:
            err = prefill_decode_vs_forward()
        finally:
            moe.INFERENCE_CAPACITY_FACTOR = served
        note = (f" with the capacity factor E / top_k = "
                f"{cfg.moe.num_experts // cfg.moe.top_k} (C = S, nothing "
                f"dropped)" + note)
    else:
        err = prefill_decode_vs_forward()
    if not err < 5e-3:
        raise AssertionError(f"full-width prefill + decode vs forward: rel "
                             f"{err} (< 5e-3)")
    what = (f"{P} image + {S - P} text tokens" if image else f"S={S}")
    print(f"[check] {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"float32, {what}: prefill + decode vs forward rel {err:.3g} "
          f"(< 5e-3){note}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del params


def profile_serving(torch, sess, prompts):
    """Phases 8, 8b and 8c: the card's busy share while serving a model at
    full size, from ``torch.profiler`` traces of the main path's drained
    session serving its first prompts again: the kernels' summed device
    time over the window's host wall time, and the five kernels that took
    most of it, for the step that admits a prompt to every slot (the
    prefills, then one decode step) and for the 4 decode steps after it. The profiler adds host time of its own, so each share
    is a lower bound; the kernel time per step is the number to compare
    with the main path's step times."""
    from repro_torch.serve.engine import Request
    for i, prompt in enumerate(prompts[:sess.B]):
        sess.submit(Request(i, prompt, max_new_tokens=6))

    def window(steps):
        def run():
            for _ in range(steps):
                sess.step()
        return trace(torch, run)

    lens = "+".join(str(len(p)) for p in prompts[:sess.B])
    out = {f"admit_{lens}": window(1), "decode_4_steps": window(4)}
    for name, r in out.items():
        print_trace(name, r)
    return out


def trace(torch, fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity): host wall
    seconds, the kernels' summed device seconds, their share of the wall
    time (busy), the launch count and the five kernels that took most
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ks = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ks) / 1e6
    top = sorted(ks, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_s": wall, "kernel_s": busy, "busy": busy / wall,
            "kernels": sum(e.count for e in ks),
            "top": [(e.key[:48], e.self_device_time_total / 1e3, e.count)
                    for e in top]}


def print_trace(name, r):
    print(f"[trace] {name}: wall {r['wall_s'] * 1e3:.1f} ms, kernels "
          f"{r['kernel_s'] * 1e3:.1f} ms in {r['kernels']} launches, "
          f"busy {r['busy'] * 100:.1f}% (profiled); most time: "
          + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in r["top"]),
          flush=True)


def wkv_ops(B, L, H, N, chunk):
    """Operations of the WKV at chunk ``chunk``, each exp one, as (tensor,
    fp32): per chunk of qc steps and head, the tensor-core work is the
    carried term and the state update (two (N,N) contractions a step) and
    the scores' product with v; the fp32 work is the scores of the qc(qc-1)/2
    pairs (a subtraction, an exp, a product and a multiply-add a channel),
    the bonus (3 a channel a step), the state's decay, and log, cumsum and
    the decay factors of r and k (7 a channel a step)."""
    tensor = fp32 = 0
    for c0 in range(0, L, chunk):
        qc = min(chunk, L - c0)
        pairs = qc * (qc - 1) // 2
        tensor += B * H * (4 * N * N * qc + 2 * N * (pairs + qc))
        fp32 += B * H * (5 * N * pairs + 3 * N * qc + 2 * N * N
                         + 7 * N * qc)
    return tensor, fp32


def cuda_core_kernel(torch, mod, *args):
    """``mod``'s CUDA-core kernel on bf16 inputs that the wrapper sends to
    the tensor cores: the earlier design, timed beside the new one. ``args``
    as the C function takes them after the input pointers; returns a
    launcher."""
    fn = mod._function(mod._SYMBOLS[torch.bfloat16])

    def launch(*ptrs):
        err = fn(*ptrs, *args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{mod.__name__} CUDA-core launch: error "
                               f"{err}")
    return launch


def kernel_times(torch, fn, prefix, calls=10):
    """{kernel name: mean device ms a call} of the kernels whose names hold
    ``prefix`` over ``calls`` calls of ``fn`` (torch.profiler)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(prefix + r"\w*", e.key)
        if m and e.device_type == DeviceType.CUDA:
            out[m.group(0)] = e.self_device_time_total / calls / 1e3
    return out


def sdpa_backend(torch, *args, **kwargs):
    """The backend ``scaled_dot_product_attention`` picks for these
    arguments, by the dispatcher's own rule (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend
    names = {int(m.value): n for n, m in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(*args, **kwargs)),
                     "unknown")


def time_lm_kernels(np, torch, dev):
    """Phase 9: each kernel at the path's shape, beside its bound, its plain
    version and (attention) the library call. Returns {name: fields}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.kernels import rwkv6_wkv as wk
    out = {}
    *shape, causal, win = PATH_FLASH
    B, S, H, KV, hd = shape
    q, k, v = flash_inputs(np, torch, shape, "bfloat16", dev, seed=99)
    err = flash_err(torch, fa, q, k, v, causal, win)
    ms_k = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=20)
    plain = time_ms(torch, lambda: fa.reference(q, k, v), reps=5)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True), reps=20)
    o = torch.empty_like(q)
    core = cuda_core_kernel(torch, fa, B, S, H, KV, hd, hd ** -0.5, 1, 0)
    core_ms = time_ms(torch, lambda: core(q.data_ptr(), k.data_ptr(),
                                          v.data_ptr(), o.data_ptr()),
                      reps=20)
    pairs = S * (S + 1) // 2                    # causal (query, key) pairs
    ops = 4 * hd * H * B * pairs                # q.k and p.v, 2 each
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    out["flash_attention"] = dict(err=err, ms=ms_k, plain_ms=plain,
                                  library_ms=lib, ops=ops, bytes=n_bytes,
                                  ops_ms=ops / BF16_OPS_PER_S * 1e3,
                                  rate="989 TFLOP/s", cuda_core_ms=core_ms)
    del q, k, v, o
    # qwen3-moe's prefill shape: 8 query heads a kv head, hd 128
    *shape, causal, win = QWEN_FLASH
    B, S, H, KV, hd = shape
    q, k, v = flash_inputs(np, torch, shape, "bfloat16", dev, seed=98)
    err = flash_err(torch, fa, q, k, v, causal, win, tc=True)
    ms_k = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=20)
    plain = time_ms(torch, lambda: fa.reference(q, k, v), reps=5)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True), reps=20)
    o = torch.empty_like(q)
    core = cuda_core_kernel(torch, fa, B, S, H, KV, hd, hd ** -0.5, 1, 0)
    core_ms = time_ms(torch, lambda: core(q.data_ptr(), k.data_ptr(),
                                          v.data_ptr(), o.data_ptr()),
                      reps=20)
    ops = 4 * hd * H * B * S * (S + 1) // 2
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    out["flash_attention_qwen3_moe"] = dict(
        err=err, ms=ms_k, plain_ms=plain, library_ms=lib, ops=ops,
        bytes=n_bytes, ops_ms=ops / BF16_OPS_PER_S * 1e3, rate="989 TFLOP/s",
        cuda_core_ms=core_ms, gqa=True)
    del q, k, v, o
    # deepseek-v2-lite's MLA prefill shape: q and k 192 wide, v padded from
    # 128 as the model pads it; SDPA on the unpadded v
    *shape, causal, win = DEEPSEEK_FLASH
    B, S, H, KV, hd = shape
    q, k, v = mla_flash_inputs(np, torch, shape, "bfloat16", dev, seed=97)
    err = flash_err(torch, fa, q, k, v, causal, win, tc=True)
    ms_k = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=20)
    plain = time_ms(torch, lambda: fa.reference(q, k, v), reps=5)
    qt, kt = q.transpose(1, 2), k.transpose(1, 2)
    vt = v[..., :MLA_V].transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib = time_ms(torch, sdpa, reps=20)
    backend = sdpa_backend(torch, qt, kt, vt, is_causal=True)
    o = torch.empty_like(q)
    core = cuda_core_kernel(torch, fa, B, S, H, KV, hd, hd ** -0.5, 1, 0)
    core_ms = time_ms(torch, lambda: core(q.data_ptr(), k.data_ptr(),
                                          v.data_ptr(), o.data_ptr()),
                      reps=20)
    # the algorithm's work: q.k over 192 and p.v over v's own 128, 2 each
    # (not the padded columns or the P_lo pass); q, k, v and o read or
    # written once, v and o at 128
    ops = 2 * (hd + MLA_V) * H * B * S * (S + 1) // 2
    n_bytes = 2 * B * S * (H * hd + KV * hd + KV * MLA_V + H * MLA_V)
    out["flash_attention_deepseek_v2_lite"] = dict(
        err=err, ms=ms_k, plain_ms=plain, library_ms=lib, library=backend,
        ops=ops, bytes=n_bytes, ops_ms=ops / BF16_OPS_PER_S * 1e3,
        rate="989 TFLOP/s", cuda_core_ms=core_ms)
    del q, k, v, o, qt, kt, vt
    # internvl2-2b's prefill shape (16 query heads over 8 kv heads of 128)
    # and hubert-xlarge's encoder (16/16 heads of 80, no tile skipped)
    for key, (*shape, causal, win), gqa in (
            ("flash_attention_internvl2", INTERNVL_FLASH, True),
            ("flash_attention_hubert", HUBERT_FLASH, False)):
        B, S, H, KV, hd = shape
        q, k, v = flash_inputs(np, torch, shape, "bfloat16", dev, seed=96)
        err = flash_err(torch, fa, q, k, v, causal, win, tc=True)
        ms_k = time_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal), reps=20)
        plain = time_ms(torch, lambda: fa.reference(q, k, v, causal=causal),
                        reps=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=gqa), reps=20)
        o = torch.empty_like(q)
        core = cuda_core_kernel(torch, fa, B, S, H, KV, hd, hd ** -0.5,
                                int(causal), 0)
        core_ms = time_ms(torch, lambda: core(q.data_ptr(), k.data_ptr(),
                                              v.data_ptr(), o.data_ptr()),
                          reps=20)
        pairs = S * (S + 1) // 2 if causal else S * S
        ops = 4 * hd * H * B * pairs
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        out[key] = dict(err=err, ms=ms_k, plain_ms=plain, library_ms=lib,
                        ops=ops, bytes=n_bytes,
                        ops_ms=ops / BF16_OPS_PER_S * 1e3,
                        rate="989 TFLOP/s", cuda_core_ms=core_ms, gqa=gqa)
        if not gqa:
            out[key]["library"] = sdpa_backend(torch, qt, kt, vt,
                                               is_causal=causal)
        del q, k, v, o, qt, kt, vt
    B, L, H, P, G, N, chunk = PATH_SCAN
    x, dt, A, Bm, Cm = scan_inputs(np, torch, PATH_SCAN, "bfloat16", dev,
                                   seed=99)
    err = scan_err(torch, ms, x, dt, A, Bm, Cm, chunk)
    ms_k = time_ms(torch, lambda: ms.mamba2_scan(x, dt, A, Bm, Cm), reps=20)
    plain = time_ms(torch, lambda: ms.reference(x, dt, A, Bm, Cm), reps=5)
    y = torch.empty_like(x)
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    core = cuda_core_kernel(torch, ms, B, L, H, P, G, N, chunk)
    core_ms = time_ms(torch, lambda: core(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), hf.data_ptr()), reps=20)
    ops = 0
    for c0 in range(0, L, chunk):               # per chunk of Qc steps:
        qc = min(chunk, L - c0)                 # C.B^T, M.x, C.h^T, update
        ops += B * H * (2 * qc * qc * N + 2 * qc * qc * P + 4 * qc * N * P)
    n_bytes = (2 * (2 * x.numel() + Bm.numel() + Cm.numel())
               + 4 * (dt.numel() + A.numel() + B * H * P * N))
    out["mamba2_scan"] = dict(err=err, ms=ms_k, plain_ms=plain,
                              library_ms=None, ops=ops, bytes=n_bytes,
                              ops_ms=ops / BF16_OPS_PER_S * 1e3,
                              rate="989 TFLOP/s", cuda_core_ms=core_ms)
    del x, dt, A, Bm, Cm, y, hf
    B, L, H, N, chunk = PATH_WKV
    r, k, v, w, u = wkv_inputs(np, torch, PATH_WKV, "bfloat16", "path", dev,
                               seed=99)
    err = wkv_err(torch, wk, r, k, v, w, u, chunk, True)
    ms_k = time_ms(torch, lambda: wk.rwkv6_wkv(r, k, v, w, u, chunk=chunk),
                   reps=20)
    plain = time_ms(torch, lambda: wk.reference(r, k, v, w, u, chunk=chunk),
                    reps=5)
    passes = kernel_times(torch, lambda: wk.rwkv6_wkv(r, k, v, w, u,
                                                      chunk=chunk), "wkv6_tc")
    print("[time] rwkv6_wkv passes (torch.profiler, mean of 10 calls): "
          + ", ".join(f"{n} {t * 1e3:.1f} us" for n, t in passes.items()),
          flush=True)
    o = torch.empty_like(r)
    sf = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    core = cuda_core_kernel(torch, wk, B, L, H, N, chunk)
    core_ms = time_ms(torch, lambda: core(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        o.data_ptr(), sf.data_ptr()), reps=20)
    # r, k, v and out bf16; w, u and the state float32. The products take
    # their fp32 operands as bf16 pairs, as the scan's do: the tensor-core
    # rate applies to them, the fp32 rate to the rest. The earlier bound counted
    # every operation at the fp32 rate; that bound is printed beside the
    # new one in the [time] line, and the kernels line carries only bound_ms
    n_bytes = (2 * (4 * r.numel()) + 4 * (w.numel() + u.numel()
                                          + B * H * N * N))
    tensor, fp32 = wkv_ops(B, L, H, N, chunk)
    out["rwkv6_wkv"] = dict(
        err=err, ms=ms_k, plain_ms=plain, library_ms=None,
        ops=tensor + fp32, bytes=n_bytes,
        ops_ms=(tensor / BF16_OPS_PER_S + fp32 / FP32_OPS_PER_S) * 1e3,
        rate=f"989 TFLOP/s for {tensor / 1e9:.3f} G, 67 for "
             f"{fp32 / 1e9:.3f} G", cuda_core_ms=core_ms, passes_ms=passes,
        fp32_rate_bound_ms=max(n_bytes / HBM_BYTES_PER_S,
                               (tensor + fp32) / FP32_OPS_PER_S) * 1e3)
    for name, r in out.items():
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops_ms"]
        r["bound_ms"] = max(bytes_ms, ops_ms)
        r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms (scaled_dot_product_attention"
                    f"{', enable_gqa' if r.get('gqa') else ''}"
                    + (f"{f', v {MLA_V} wide' if 'deepseek' in name else ''}"
                       f", backend {r['library']}"
                       if "library" in r else "") + ")")
        core = f"; the CUDA-core kernel on the same inputs " \
               f"{r['cuda_core_ms']:.4f} ms"
        if "fp32_rate_bound_ms" in r:
            core += (f"; every operation at 67 TFLOP/s (the earlier bound): "
                     f"{r['fp32_rate_bound_ms']:.4f} ms = "
                     f"{r['fp32_rate_bound_ms'] / r['ms'] * 100:.2f}%")
        print(f"[time] {name} bf16 at the path's shape: {r['ms']:.4f} ms "
              f"(median of 20); bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['ops'] / 1e9:.3f} GFLOP = {ops_ms:.4f} "
              f"ms at {r['rate']}, "
              f"{r['bytes'] / 1e6:.2f} MB = {bytes_ms:.4f} ms) = "
              f"{r['bound_ms'] / r['ms'] * 100:.2f}% of the bound; plain "
              f"version {r['plain_ms']:.4f} ms; library {lib}; max |diff| "
              f"{r['err']:.3g}{core}", flush=True)
    return out


def frontend_inputs(np, torch, cfg, B, S, dev, seed):
    """A vision config's (B, S) text tokens and (B, P, feat) image
    embeddings, or an audio config's (B, S, feat) features, from numpy's
    generator at ``seed``: the features float32, as the reference takes
    them."""
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    if fe.kind == "audio_frames":
        return {"features": f32(rng.standard_normal((B, S, fe.feature_dim)))}
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
            .to(dev),
            "image_embeds": f32(rng.standard_normal(
                (B, fe.num_prefix_tokens, fe.feature_dim)))}


def check_frontends_and_training_against_cpu(np, torch, dev):
    """Phase 6, continued: internvl2-2b's and hubert-xlarge's smoke configs
    forward on the card (K2) and on the CPU, float32, logits within 1e-4;
    then qwen3-32b's smoke config on both from the same weights: the first
    batch's grads, every leaf within 1e-4 (max |diff| over max |ref|), and
    two ``make_train_step`` steps, the losses within 1e-4, AdamW's m and v
    every leaf within 1e-4 (max |diff| over max |ref|: they are linear in
    the grads) and every updated parameter within 1e-4 normwise (||diff||
    over ||ref||).

    The parameters are held normwise, not element by element: Adam's first
    steps move an element by lr g / (|g| + eps), so where |g| is near eps
    (1e-8) an absolute grad difference of 1e-9, float32 rounding in another
    summation order, moves the update by a tenth of lr. Two correct float32
    runs then differ by a few 1e-4 of the largest element (an H100 against
    the CPU: 5.35e-4 in ``embed.table``; float32 against float64 on the
    CPU: 2.52e-4 in layer 0's ``wq``), while the norm of the difference
    stays near 1e-5 (tests/test_torch_train.py holds float32 against
    float64 so)."""
    import copy
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import optimizer, train_step
    for arch in ("internvl2_2b", "hubert_xlarge"):
        cfg = get_smoke_config(arch)
        on = {"cpu": M.init_model(torch.Generator().manual_seed(0), cfg)}
        on["card"] = copy.deepcopy(on["cpu"]).to(dev)
        out = {}
        for where, params in on.items():
            inputs = frontend_inputs(np, torch, cfg, 2, 40,
                                     params.embed.table.device, seed=1)
            x, _ = M.forward(params, cfg, inputs)
            out[where] = M.logits(params, cfg, x)[..., :cfg.vocab].cpu()
        err = rel_err(out["card"], out["cpu"])
        if not err < 1e-4:
            raise AssertionError(f"{arch} smoke: card vs CPU forward logits "
                                 f"rel {err} (< 1e-4)")
        print(f"[check] {cfg.name} smoke ({cfg.frontend.kind}), card vs CPU: "
              f"forward logits rel {err:.3g} (< 1e-4)", flush=True)
    cfg = get_smoke_config("qwen3_32b")
    opt = optimizer.OptConfig(total_steps=10, warmup_steps=2, peak_lr=1e-3)
    step = train_step.make_train_step(
        cfg, ShapeConfig("s", "train", 32, 4, num_microbatches=2), opt)
    cpu, _ = train_step.init_train_state(torch.Generator().manual_seed(0),
                                         cfg, opt)
    models = {"cpu": cpu, "card": copy.deepcopy(cpu).to(dev)}
    states = {k: optimizer.init_opt_state(m) for k, m in models.items()}
    losses = {k: [] for k in models}
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (4, 32)))
    grads = {}
    for k, m in models.items():
        t = toks.to(m.embed.table.device)
        grads[k], _, _ = train_step.grads_and_loss(
            m, cfg, {"tokens": t, "labels": t},
            ShapeConfig("s", "train", 32, 4, num_microbatches=2))
    grad_err = max(rel_err(grads["card"][n].cpu(), g)
                   for n, g in grads["cpu"].items())
    for i in range(2):
        toks = torch.from_numpy(np.random.default_rng(10 + i).integers(
            0, cfg.vocab, (4, 32)))
        for k, m in models.items():
            t = toks.to(m.embed.table.device)
            _, states[k], met = step(m, states[k], {"tokens": t, "labels": t})
            losses[k].append(float(met["loss"]))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                       losses["cpu"]))
    pairs = [(p.detach().cpu(), q.detach()) for (_, p), (_, q)
             in zip(models["card"].named_parameters(),
                    models["cpu"].named_parameters())]
    param_err = max(float((a - b).norm() / b.norm()) for a, b in pairs)
    param_max = max(rel_err(a, b) for a, b in pairs)
    moment_err = max(rel_err(states["card"][k][n].cpu(), t)
                     for k in ("m", "v") for n, t in states["cpu"][k].items())
    if not (grad_err < 1e-4 and loss_err < 1e-4 and moment_err < 1e-4
            and param_err < 1e-4):
        raise AssertionError(f"qwen3-32b smoke training, card vs CPU: grads "
                             f"rel {grad_err}, loss rel {loss_err}, m and v "
                             f"rel {moment_err}, parameters normwise rel "
                             f"{param_err} (< 1e-4)")
    print(f"[check] {cfg.name} smoke, card vs CPU: the first batch's grads "
          f"within rel {grad_err:.3g} (< 1e-4, every leaf); 2 "
          f"make_train_step steps (2 microbatches, remat): losses "
          f"{[round(x, 6) for x in losses['card']]}, rel {loss_err:.3g}; "
          f"m and v within rel {moment_err:.3g} (< 1e-4, every leaf); "
          f"every updated parameter within {param_err:.3g} normwise (< "
          f"1e-4; element-wise max |diff| / max |ref| {param_max:.3g})",
          flush=True)


def frontend_inference(np, torch, dev, zero_counts, counted, tensor_core):
    """Phase 10: the frontends' inference on K2 at full width and depth,
    bf16, random weights from seed 0, each model freed before the next.
    internvl2-2b: ``prefill_step`` of 256 image + 1024 text tokens, then 16
    greedy decode steps; hubert-xlarge: ``forward`` on (1, 2048, 512)
    features. Each with its launch counts set to 0 just before and read
    just after: 24 and 48 K2 launches, all on ``flash_fwd_tc``, no other
    kernel; every logit finite. Returns {arch: K2 launches}."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import greedy_sample, prefill_step
    launches = {}
    for arch, text in (("internvl2_2b", PREFILL_TEXT),
                       ("hubert_xlarge", HUBERT_FLASH[1])):
        cfg = get_config(arch)
        want = cfg.n_layers                  # one K2 launch a layer
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        inputs = frontend_inputs(np, torch, cfg, 1, text, dev, seed=4)
        zero_counts()
        t0 = time.perf_counter()
        if cfg.causal:
            P = cfg.frontend.num_prefix_tokens
            S = P + text
            logits, caches = prefill_step(params, cfg, inputs,
                                          capacity=S + 16)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            finite = bool(torch.isfinite(logits).all())
            tok = greedy_sample(logits)[:, None].long()
            steps = []
            for _ in range(16):
                t1 = time.perf_counter()
                logits, caches = M.decode_step(params, cfg, tok, caches)
                tok = greedy_sample(logits)[:, None].long()
                finite &= bool(torch.isfinite(logits).all())
                steps.append(time.perf_counter() - t1)
            step_s = statistics.median(steps[1:])
            timing = (f"TTFT {first_s:.4f} s ({S} positions: {P} image + "
                      f"{text} text); 16 decode steps at batch 1, each "
                      f"ending in a host read of its logits: the first "
                      f"{steps[0]:.4f} s, the median of the rest "
                      f"{step_s:.4f} s ({1 / step_s:.2f} tokens/s)")
        else:
            with torch.no_grad():
                x, _ = M.forward(params, cfg, inputs)
                logits = M.logits(params, cfg, x)[..., :cfg.vocab]
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(logits).all())
            timing = (f"forward {time.perf_counter() - t0:.4f} s over "
                      f"{text} frames")
        counts = {fn.__name__: fn.launches for fn in counted}
        tc = tensor_core[0].launches_tc
        peak = torch.cuda.max_memory_allocated() / 1e9
        n = sum(p.numel() for p in params.parameters())
        print(f"[frontends] {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {n / 1e9:.3f} B parameters, bf16): init "
              f"{init_s:.2f} s, {timing}; launches {json.dumps(counts)}, "
              f"{tc} on flash_fwd_tc; peak device memory {peak:.2f} GB",
              flush=True)
        if counts != {"hedm_reduce": 0, "flash_attention": want,
                      "mamba2_scan": 0, "rwkv6_wkv": 0} or tc != want:
            raise AssertionError(f"{cfg.name}: launches {counts}, {tc} on "
                                 f"the tensor cores; expected {want} K2")
        if not finite:
            raise AssertionError(f"{cfg.name}: non-finite logits")
        launches[arch] = want
        del params, logits, inputs
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def train_full_width(np, torch, dev, arch, zero_counts, counted):
    """Phase 11: 8 ``make_train_step`` steps of ``arch`` at full width and
    depth in bf16 on one repeated batch of 4 (microbatches 2, remat on, the
    reference launcher's ``OptConfig``: peak 1e-3, warmup 2). internvl2-2b:
    256 image embeddings (numpy seed) and 768 text tokens from a
    ``StagedLoader`` over token shards staged collectively on the
    simulator; hubert-xlarge: 1024 frames of 512 features and labels from
    its 504 clusters. The loss falls, every loss and grad norm is finite,
    and no K2, K3 or K4 launches inside the steps (counts set to 0 just
    before, read just after). Then one more step under ``torch.profiler``.
    Returns the step's numbers."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fabric import BGQ, Fabric
    from repro_torch.data.pipeline import StagedLoader, write_token_shards
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = get_config(arch)
    B, steps = 4, 8
    rng = np.random.default_rng(5)
    if cfg.frontend.kind == "vision_patches":
        P = cfg.frontend.num_prefix_tokens
        text = 1024 - P
        fabric = Fabric(n_hosts=8, constants=BGQ)
        write_token_shards(fabric, n_shards=8, tokens_per_shard=1 << 16,
                           vocab=cfg.vocab, seed=5)
        loader = StagedLoader(fabric, "data/*.bin", batch=B, seq=text)
        rep = loader.stage(collective=True)
        batch = next(loader.batches(seed=5, device=dev))
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, P, cfg.frontend.feature_dim)).astype(np.float32)).to(dev)
        print(f"[train] {cfg.name} data: 8 shards of 65,536 tokens staged "
              f"collectively onto 8 simulated BG/Q hosts ({rep.mode}): "
              f"{rep.total_bytes} bytes, FS read {rep.fs_bytes} bytes, "
              f"interconnect {rep.net_bytes} bytes; simulated stage "
              f"{rep.stage_time:.6f} s + comm {rep.comm_time:.6f} s + "
              f"write {rep.write_time:.6f} s + broadcast "
              f"{rep.broadcast_time:.6f} s = {loader.staging_time:.6f} s",
              flush=True)
        S = P + text
    else:
        S = 1024
        batch = {"features": torch.from_numpy(rng.standard_normal(
            (B, S, cfg.frontend.feature_dim)).astype(np.float32)).to(dev),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)}
    opt = OptConfig(total_steps=max(steps, 10),
                    warmup_steps=max(2, steps // 10), peak_lr=1e-3)
    shape = ShapeConfig("train", "train", S, B, num_microbatches=2,
                        remat=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state = init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    # N of 6 N tokens: every parameter that multiplies, so not the token
    # table, a lookup (the output head does multiply; tied, it is the table)
    n_mul = n - (0 if cfg.tie_embeddings else params.embed.table.numel())
    step = make_train_step(cfg, shape, opt)
    zero_counts()
    losses, norms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    counts = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(times[1:])
    tokens = B * S
    mfu = 6 * n_mul * tokens / step_s / BF16_OPS_PER_S
    print(f"[train] {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n / 1e9:.3f} B parameters, bf16, AdamW fp32 "
          f"state): init {init_s:.2f} s; {steps} steps of {B} x {S} "
          f"positions (2 microbatches, remat): losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in norms]}; step times "
          f"{[round(x, 3) for x in times]} s (median after the first "
          f"{step_s:.4f} s, {tokens / step_s:.0f} tokens/s, 6 N tokens / "
          f"step with N = {n_mul / 1e9:.3f} B, the token table left out, "
          f"= {mfu * 100:.2f}% of 989 TFLOP/s); launches "
          f"{json.dumps(counts)}; peak device memory {peak:.2f} GB",
          flush=True)
    if any(counts.values()):
        raise AssertionError(f"{cfg.name} training launched {counts}: the "
                             f"training path must take the plain mixers")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name} training: losses {losses}, grad "
                             f"norms {norms}: not finite, or not falling")
    r = trace(torch, lambda: step(params, state, batch))
    print_trace(f"{cfg.name} train step", r)
    out = {"step_s": step_s, "tokens_per_s": tokens / step_s,
           "mfu": mfu, "peak_gb": peak, "losses": losses, "trace": r,
           "params": n}
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_trainer_restart(np, torch, dev, zero_counts, counted):
    """Phase 11b: ``repro_torch.launch.train.main`` on the card, smoke
    qwen3-32b, 20 steps, checkpoints every 10, a failure injected before
    step 15: one restart, and the state restored at step 10 equal byte for
    byte to the one saved there; no kernel launched."""
    import tempfile
    from repro_torch.checkpoint.store import CheckpointStore, _flatten
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.driver import TrainDriver
    saved, restored = {}, {}
    real_save, real_restore = CheckpointStore.save_async, TrainDriver._restore

    def host(tree):
        return {p: t.detach().to("cpu", copy=True)
                for p, t in _flatten(tree).items()}

    def save_async(self, step, tree, n_shards=8):
        saved[step] = host(tree)
        real_save(self, step, tree, n_shards)

    def restore(self, template, step):
        state = real_restore(self, template, step)
        restored[step] = host(state)
        return state
    CheckpointStore.save_async, TrainDriver._restore = save_async, restore
    zero_counts()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="repro_train_") as d:
            report = launch_train.main(arch="qwen3-32b", smoke=True,
                                       steps=20, ckpt_dir=d, device=dev,
                                       fail_at=15)
    finally:
        CheckpointStore.save_async, TrainDriver._restore = (real_save,
                                                            real_restore)
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in counted}

    def raw(t):
        return t.reshape(-1).view(torch.uint8)
    same = (sorted(saved.get(10, {})) == sorted(restored.get(10, {}))
            and all(a.dtype == restored[10][p].dtype
                    and torch.equal(raw(a), raw(restored[10][p]))
                    for p, a in saved[10].items()))
    n_bytes = sum(t.numel() * t.element_size() for t in saved[10].values())
    print(f"[train] launch.train.main qwen3-32b smoke on the card, 20 steps, "
          f"a failure before step 15: {report.steps_completed} steps run, "
          f"{report.restarts} restart, checkpoints {report.checkpoints}, "
          f"losses {report.losses[0]:.4f} -> {report.losses[-1]:.4f}; the "
          f"state restored at step 10 ({len(saved[10])} leaves, "
          f"{n_bytes / 1e6:.1f} MB) {'equals' if same else 'DIFFERS from'} "
          f"the saved one byte for byte; launches {json.dumps(counts)}; "
          f"{wall:.2f} s", flush=True)
    if not (same and report.restarts == 1 and report.checkpoints == [10, 20]
            and report.steps_completed == 25
            and np.isfinite(report.losses).all()):
        raise AssertionError("the trainer's restart did not restore the "
                             "saved state or did not finish its steps")
    if any(counts.values()):
        raise AssertionError(f"the trainer launched {counts}")




def main(n_frames=FRAMES, grid_points=GRID_POINTS):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.hedm import interactive
    from repro_torch.hedm.pipeline import (fit_grid, make_gvectors,
                                           pack_reduced, reduce_frames,
                                           simulate_detector_frames,
                                           synth_grid_observations)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import hedm_reduce as hr
    from repro_torch.kernels.ops import (flash_attention, hedm_reduce,
                                         mamba2_scan, rwkv6_wkv)
    from repro_torch.launch import serve as launch_serve
    counted = (hedm_reduce, flash_attention, mamba2_scan, rwkv6_wkv)
    tensor_core = (flash_attention, mamba2_scan, rwkv6_wkv)

    def zero_counts():
        for fn in counted:
            fn.launches = 0
        for fn in tensor_core:
            fn.launches_tc = 0

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    full = (n_frames, SIZE, SIZE)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f}s: "
          + ", ".join(str(p.relative_to(ROOT)) for p in libs.values()))
    for name, p in libs.items():
        for line in ptxas_summary(p.with_suffix(".log")):
            print(f"[ptxas] {name}: {line}")
    fa_smem = _build.bind("flash_attention", "flash_attention_tc_smem_bytes",
                          [ctypes.c_int])
    tc_smem = {"flash_fwd_tc, hd 112": fa_smem(112),
               "flash_fwd_tc, hd 192": fa_smem(192),
               "ssd_scan_tc": _build.bind(
                   "mamba2_scan", "mamba2_scan_tc_smem_bytes", [])()}
    wkv_smem = _build.bind("rwkv6_wkv", "rwkv6_wkv_tc_smem_bytes",
                           [ctypes.c_int, ctypes.c_int])
    tc_smem["wkv6_tc_walk, chunk 32"] = wkv_smem(0, 32)
    tc_smem["wkv6_tc_out, chunk 32"] = wkv_smem(1, 32)
    print("[ptxas] dynamic shared memory a block: " + ", ".join(
        f"{k} {v} bytes" for k, v in tc_smem.items()), flush=True)

    # 3. kernel vs plain version, then the path's stages vs the CPU
    max_err = 0
    cases = kernel_cases(np)
    big = simulate_detector_frames(CHUNK, size=SIZE, seed=1, device=dev)
    cases.append(("f32-8x2048x2048", big[0], big[1], 200.0))
    cases.append(("u16-8x2048x2048", np.clip(big[0], 0, 65535)
                  .astype(np.uint16), big[1], 200.0))
    for name, f, d, thr in cases:
        ft, dt = torch.from_numpy(f).to(dev), torch.from_numpy(d).to(dev)
        m, c = hedm_reduce(ft, dt, thr)
        m_ref, c_ref = hr.reference(ft, dt, thr)
        torch.cuda.synchronize()
        err = max(int((m.int() - m_ref.int()).abs().max()),
                  int((c - c_ref).abs().max()))
        max_err = max(max_err, err)
        if not (torch.equal(m, m_ref) and torch.equal(c, c_ref)):
            raise AssertionError(f"hedm_reduce != plain version on {name} "
                                 f"{tuple(f.shape)} {f.dtype}: max |diff| "
                                 f"{err}")
    print(f"[check] hedm_reduce == plain version on {len(cases)} inputs "
          f"(float32 and uint16, up to (8, 2048, 2048))", flush=True)
    prompts = launch_serve.draw_prompts(get_config("zamba2_7b").vocab)
    errs = check_lm_kernels(np, torch, dev, [len(p) for p in prompts])
    del big, cases

    frames, dark = simulate_detector_frames(6, size=256, n_spots=12, seed=4)
    on_card = pack_reduced(reduce_frames(frames, dark, device=dev))
    on_cpu = pack_reduced(reduce_frames(frames, dark, device="cpu"))
    if on_card.tobytes() != on_cpu.tobytes():
        raise AssertionError("stage 1 on the card != stage 1 on the CPU")
    gvec = make_gvectors()
    truth, obs = synth_grid_observations(512, gvec, device="cpu")
    theta0 = np.zeros((512, 3), np.float32)
    fit_card = fit_grid(obs, gvec, theta0, device=dev).cpu().numpy()
    fit_cpu = fit_grid(obs, gvec, theta0, device="cpu").numpy()
    rec = np.abs(fit_cpu - truth).max(axis=1) < 0.05
    fit_err = float(np.abs(fit_card - fit_cpu)[rec].max())
    if not (np.isfinite(fit_card).all() and fit_err <= 1e-4):
        raise AssertionError(f"stage 2 on the card vs the CPU: max |diff| "
                             f"{fit_err} on recovered points (atol 1e-4)")
    print(f"[check] small scan: stage 1 packed bytes identical card vs CPU "
          f"({on_card.size} floats); stage 2 max |diff| {fit_err:.3g} on "
          f"{rec.sum()} recovered points (atol 1e-4)", flush=True)

    # 4. the main path, at the paper's size
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = interactive.main(device=dev, n_frames=n_frames, size=SIZE,
                           grid_points=grid_points)
    main_s = time.perf_counter() - t0
    launches = hr.hedm_reduce.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[main] {main_s:.2f}s wall, hedm_reduce launches {launches}, "
          f"{out['n_spots']} spots over {out['n_frames']} frames, "
          f"recovered {out['recovered']:.4f}, peak device memory "
          f"{peak_gb:.2f} GB, peak host RSS {rss_gb:.2f} GB")
    print("[main] phases (s): " + json.dumps(out["phases"]), flush=True)
    if launches < 1:
        raise AssertionError("the main path never launched hedm_reduce")
    if out["n_spots"] < out["n_frames"]:
        raise AssertionError(f"fewer than one spot per frame: "
                             f"{out['n_spots']} over {out['n_frames']}")
    if not out["recovered"] > 0.7:
        raise AssertionError(f"stage 2 recovered {out['recovered']} <= 0.7")
    del out
    gc.collect()

    # 4b. the streamed and the multi-session drivers at 2048x2048
    driver_launches = check_hedm_drivers(torch, dev, hr, zero_counts)

    # 5. the kernel at the main path's shape: equal to the plain version
    # on every frame, then timed beside its bound and its plain version
    frames, dark = simulate_detector_frames(n_frames, size=SIZE, seed=2,
                                            device=dev)
    ft, dt = torch.from_numpy(frames).to(dev), torch.from_numpy(dark).to(dev)
    del frames
    m, c = hedm_reduce(ft, dt, 200.0)
    for f0 in range(0, n_frames, CHUNK):
        m_ref, c_ref = hr.reference(ft[f0:f0 + CHUNK], dt, 200.0)
        if not (torch.equal(m[f0:f0 + CHUNK], m_ref)
                and torch.equal(c[f0:f0 + CHUNK], c_ref)):
            raise AssertionError(f"hedm_reduce != plain version at "
                                 f"{full}, frames {f0}..{f0 + CHUNK}")
    del m, c, m_ref, c_ref
    ms = time_ms(torch, lambda: hedm_reduce(ft, dt, 200.0), reps=20)

    def plain_full():
        for f0 in range(0, n_frames, CHUNK):
            hr.reference(ft[f0:f0 + CHUNK], dt, 200.0)
    plain_ms = time_ms(torch, plain_full, reps=3, warmup=1)
    plain_chunk_ms = time_ms(
        torch, lambda: hr.reference(ft[:CHUNK], dt, 200.0), reps=10)
    pixels = ft.numel()
    n_bytes = (ft.numel() * ft.element_size() + dt.numel() * 4 + pixels
               + n_frames * 4)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = HEDM_OPS_PER_PIXEL * pixels / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[time] hedm_reduce {full} float32: {ms:.4f} ms (median of 20); "
          f"bound {bound_ms:.4f} ms by bytes ({n_bytes / 1e9:.3f} GB; ops "
          f"{ops_ms:.4f} ms); plain version {plain_ms:.2f} ms in "
          f"{n_frames // CHUNK} chunks of {CHUNK}, {plain_chunk_ms:.3f} ms "
          f"per chunk; no single PyTorch call computes this function "
          f"(library_ms null); {n_bytes / ms / 1e6:.1f} GB/s = "
          f"{bound_ms / ms * 100:.1f}% of the bound")
    # the port's nf_reduction row (benchmarks/paper_figures.py:91-108) from
    # the same time: microseconds a frame, and 736 frames
    per_frame_us = ms * 1e3 / n_frames
    nf_row = {"nf_reduction_per_frame_us": per_frame_us,
              "px_per_s": SIZE * SIZE / (per_frame_us * 1e-6),
              "nf_reduction_736_frames_est_us": per_frame_us * 736,
              "paper_736_frames_s": 106.0, "paper_cores": 320}
    print(f"[nf_reduction] nf_reduction_per_frame {per_frame_us:.4f} us "
          f"(px_per_s={nf_row['px_per_s']:.3e}); nf_reduction_736_frames_est "
          f"{per_frame_us * 736:.1f} us = {per_frame_us * 736e-3:.4f} ms on "
          f"one card, against the paper's 106 s on 320 cores "
          f"({106.0 / (per_frame_us * 736e-6):.0f}x); from the kernel time "
          f"above, no second timing", flush=True)
    del ft, dt
    gc.collect()
    torch.cuda.empty_cache()

    # 6.-7. the LM path on the card against the CPU, then at full width
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    check_serving_against_cpu(np, torch, dev)
    check_frontends_and_training_against_cpu(np, torch, dev)
    check_full_width_prefill_decode(np, torch, dev, "zamba2_7b", 12)
    check_full_width_prefill_decode(np, torch, dev, "rwkv6_3b", 4)
    check_full_width_prefill_decode(np, torch, dev, "qwen3_moe_30b_a3b", 4)
    check_full_width_prefill_decode(np, torch, dev, "deepseek_v2_lite_16b", 4)
    check_full_width_prefill_decode(np, torch, dev, "internvl2_2b", 4)
    gc.collect()
    torch.cuda.empty_cache()

    def serve_main_path(arch, want):
        """One LM main path at full width and depth, its launch counts set
        to 0 just before and read just after; ``want(cfg)`` gives the counts
        it must show, every launch of a kernel with a tensor-core variant
        on that variant. Returns the counts and those of the tensor-core
        kernels."""
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        served = launch_serve.main(arch=arch, device=dev)
        serve_s = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in counted}
        tc = {fn.__name__: fn.launches_tc for fn in tensor_core}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cfg, ph = served["cfg"], served["phases"]
        n_req = len(served["finished"])
        print(f"[lm] {serve_s:.2f}s wall for {cfg.name} ({cfg.n_layers} "
              f"layers, d_model {cfg.d_model}, {cfg.param_dtype}): init "
              f"{ph['init_s']:.2f}s, session {ph['serve_s']:.2f}s; decode "
              f"{ph['decode_tokens_per_s']:.2f} tokens/s; launches "
              f"{json.dumps(counts)}; peak device memory {peak_gb:.2f} GB")
        print("[lm] phases: " + json.dumps(ph), flush=True)
        if counts != want(cfg, n_req):
            raise AssertionError(f"the {cfg.name} path launched {counts}, "
                                 f"expected {want(cfg, n_req)}")
        print(f"[lm] tensor-core launches on the {cfg.name} path: "
              f"{json.dumps(tc)}", flush=True)
        if any(n != counts[name] for name, n in tc.items()):
            raise AssertionError(f"the {cfg.name} path: {tc} of {counts} "
                                 f"launches on the tensor-core kernels")
        if sorted(p["tokens"] for p in ph["prefill"]) != sorted(
                len(p) for p in prompts):
            raise AssertionError(f"the {cfg.name} path served other prompt "
                                 f"lengths than phase 3 checked")
        if ph["nonfinite_logits"] or n_req != 8 or any(
                len(r.generated) != 32 for r in served["finished"]):
            raise AssertionError(f"{cfg.name} path: {ph['nonfinite_logits']}"
                                 f" non-finite logits, {n_req} requests "
                                 f"finished")
        profile_serving(torch, served["session"], prompts)
        del served
        gc.collect()
        torch.cuda.empty_cache()
        return counts, tc

    # 8. the LM main path: zamba2-7b serving at full width and depth
    lm_launches, lm_tc = serve_main_path("zamba2-7b", lambda cfg, n: {
        "hedm_reduce": 0, "flash_attention": n * (cfg.n_layers
                                                  // cfg.attn_every),
        "mamba2_scan": n * cfg.n_layers, "rwkv6_wkv": 0})
    # 8b. rwkv6-3b serving at full width and depth, the zamba2 session freed
    rw_launches, rw_tc = serve_main_path("rwkv6-3b", lambda cfg, n: {
        "hedm_reduce": 0, "flash_attention": 0, "mamba2_scan": 0,
        "rwkv6_wkv": n * cfg.n_layers})
    lm_launches["rwkv6_wkv"] = rw_launches["rwkv6_wkv"]
    lm_tc["rwkv6_wkv"] = rw_tc["rwkv6_wkv"]
    # 8c. qwen3-moe-30b-a3b serving at full width and depth, the rwkv6
    # session freed
    qw_launches, qw_tc = serve_main_path("qwen3-moe-30b-a3b", lambda cfg, n: {
        "hedm_reduce": 0, "flash_attention": n * cfg.n_layers,
        "mamba2_scan": 0, "rwkv6_wkv": 0})
    # 8d. deepseek-v2-lite-16b serving at full width and depth, the
    # qwen3-moe session freed: MLA prefill on K2 at hd 192
    ds_launches, ds_tc = serve_main_path(
        "deepseek-v2-lite-16b", lambda cfg, n: {
            "hedm_reduce": 0, "flash_attention": n * cfg.n_layers,
            "mamba2_scan": 0, "rwkv6_wkv": 0})
    # the kernels line counts the launches of the three attention paths
    for n, n_tc in ((qw_launches, qw_tc), (ds_launches, ds_tc)):
        lm_launches["flash_attention"] += n["flash_attention"]
        lm_tc["flash_attention"] += n_tc["flash_attention"]

    # 9. the LM kernels at the path's shapes
    timed = time_lm_kernels(np, torch, dev)
    timed["flash_attention_qwen3_moe"]["launches"] = \
        qw_launches["flash_attention"]
    timed["flash_attention_deepseek_v2_lite"]["launches"] = \
        ds_launches["flash_attention"]

    # 10. the frontends' inference on K2 at full width and depth
    fe_launches = frontend_inference(np, torch, dev, zero_counts, counted,
                                     tensor_core)
    for arch, n in fe_launches.items():
        timed[f"flash_attention_{arch.split('_')[0]}"]["launches"] = n
        lm_launches["flash_attention"] += n
        lm_tc["flash_attention"] += n
    # 11. training at full width and depth on the plain mixers, then 11b.
    # the trainer's restart from its checkpoint
    for arch in ("internvl2_2b", "hubert_xlarge"):
        train_full_width(np, torch, dev, arch, zero_counts, counted)
    check_trainer_restart(np, torch, dev, zero_counts, counted)
    print(f"[done] {time.perf_counter() - t_start:.1f}s total", flush=True)

    kernels = [{
        "name": "hedm_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/hedm_reduce.cu",
        "replaces": "src/repro/kernels/hedm_reduce.py:148",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "exact": max_err == 0,
        "driver_launches": driver_launches, "nf_reduction": nf_row,
    }]
    for name, line in [("flash_attention", 110), ("mamba2_scan", 89),
                       ("rwkv6_wkv", 80)]:
        r = timed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": lm_launches[name],
            "launches_tc": lm_tc[name], "cuda_core_ms": r["cuda_core_ms"],
            **({"passes_ms": r["passes_ms"]} if "passes_ms" in r else {}),
            **({f"at_{shape}_shape": {
                k: timed[f"flash_attention_{shape}"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "cuda_core_ms", "err", "launches", "library")
                if k in timed[f"flash_attention_{shape}"]}
                for shape in FLASH_SHAPES_TIMED}
               if name == "flash_attention" else {}),
            "max_abs_err": max(errs[name], r["err"], *(
                [timed[f"flash_attention_{shape}"]["err"]
                 for shape in FLASH_SHAPES_TIMED]
                if name == "flash_attention" else [])), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (defaults: the paper's size).")
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help="frames of 2048x2048 on the main path")
    ap.add_argument("--grid-points", type=int, default=GRID_POINTS)
    a = ap.parse_args()
    main(n_frames=a.frames, grid_points=a.grid_points)
