#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a.
3. Kernel vs plain version on the card: ``hedm_reduce`` against its plain
   PyTorch version at the test shapes (float32 and uint16) and at
   (8, 2048, 2048); masks and counts must be equal (``torch.equal``). Then
   the main path's stages on a small scan against the CPU: stage 1 bit for
   bit, stage 2 within 1e-4 on recovered points.
4. The main path: ``repro_torch.hedm.interactive.main`` at the paper's
   size, 736 frames of 2048x2048 and 100,000 grid points, with the launch
   counts set to 0 just before and read just after.
5. Timing: the kernel at (736, 2048, 2048) float32 (CUDA events, median of
   20 launches after warm-up) beside its HBM bound and its plain version,
   which is first held equal to the kernel on all 736 frames.

The last three lines of standard output are the card's ``nvidia-smi`` line,
the ``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``.
"""
import argparse
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
# fp32 operations per pixel: subtract, clamp, 19 min/max exchanges (38),
# Laplacian (7 adds, 1 mul, 1 sub), two compares, one and, one count add
HEDM_OPS_PER_PIXEL = 53
FRAMES, SIZE = 736, 2048           # the paper's NF-HEDM layer
GRID_POINTS = 100_000
CHUNK = 8                          # frames per plain-version call


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
    return cases


def time_ms(torch, fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    from repro_torch.kernels import _build
    from repro_torch.kernels import hedm_reduce as hr
    from repro_torch.kernels.ops import hedm_reduce

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
    for p in libs.values():
        log = p.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                print(f"[build] {line}")

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
    hr.hedm_reduce.launches = 0
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
    print(f"[done] {time.perf_counter() - t_start:.1f}s total", flush=True)

    kernels = [{
        "name": "hedm_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/hedm_reduce.cu",
        "replaces": "src/repro/kernels/hedm_reduce.py:148",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "exact": max_err == 0,
    }]
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
