"""NF/FF-HEDM analysis pipeline (paper §II, §V, §VI).

Stage 0 — detector simulation: synthetic diffraction frames (bright spots on
noise, sparse like real frames) streamed to the shared FS
(repro_torch.core.fabric) exactly as the APS detector writes to NFS/GPFS.
The numpy generator is the reference package's, bit for bit;
``device=`` renders the same distributions on the card instead.

Stage 1 — data reduction (§VI-A): per-frame background subtraction, median
filter, Laplacian edge response, threshold, connected-component labeling ->
peak list. The filter half runs on the hedm_reduce CUDA kernel
(`repro_torch.kernels.ops`, or its plain PyTorch version); labeling runs
on host (networkx-free union-find).

Stage 2 — orientation fitting (§V-C, Fig. 8): for every grid point, fit the
crystal orientation (3 Euler-like params) to the observed diffraction
signature by batched Gauss-Newton — the FitOrientation() many-task stage,
vmapped (``torch.func``) instead of one C process per point.

Online mode — ``reduce_frames_online`` / ``run_online_hedm`` run stage-1
incrementally per sliding window over a streamed acquisition
(`repro_torch.core.streaming`): results are produced while the detector is still
writing, and are bit-identical to the batch path (``run_batch_hedm``).

Interactive mode — ``run_interactive_hedm`` drives N concurrent analysis
sessions over M scans through the long-lived dataset catalog + staging
service (`repro_torch.core.datasvc`): sessions lease datasets (coalescing
concurrent stages), reduce from the resident replicas, and write their
results back to the shared FS with the collective ``stage_out`` — the
"extended residency, various processing tasks" regime of §VI-B.

Every function that computes on tensors takes ``device=`` (default
``"cuda"``, see `repro_torch.device.resolve_device`); arrays cross the
public functions as numpy, in the reference package's layouts.
"""
from __future__ import annotations

import time as _time
import warnings
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.fabric import Fabric
from repro_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# stage 0: detector simulation
# ---------------------------------------------------------------------------

def simulate_detector_frames(n_frames: int, size: int = 256,
                             n_spots: int = 12, seed: int = 0,
                             device: Optional[DeviceLike] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic diffraction frames: Gaussian spots on Poisson background.
    Returns (frames (F,size,size) float32, dark (size,size)).

    Spot rendering is fully vectorized: an isotropic Gaussian separates into
    a row factor and a column factor, so all F x n_spots spots render as one
    (F,S,H) x (F,S,W) einsum — no per-frame/per-spot Python loops.

    ``device=None`` (the default) runs numpy and is bit-exact with the
    reference package. A ``device`` renders the scan there with a seeded
    ``torch.Generator`` (:func:`_simulate_on_device`): the same
    distributions and float32 result, other random numbers. It exists
    because numpy takes ~0.8 s per 2048x2048 frame.
    """
    if device is not None:
        return _simulate_on_device(n_frames, size, n_spots, seed,
                                   resolve_device(device))
    rng = np.random.default_rng(seed)
    dark = rng.poisson(8.0, (size, size)).astype(np.float32)
    frames = rng.poisson(8.0, (n_frames, size, size)).astype(np.float32)
    if n_frames and n_spots:
        cy = rng.uniform(8, size - 8, (n_frames, n_spots, 1))
        cx = rng.uniform(8, size - 8, (n_frames, n_spots, 1))
        amp = rng.uniform(800, 4000, (n_frames, n_spots, 1))
        sig = rng.uniform(1.0, 2.5, (n_frames, n_spots, 1))
        r = np.arange(size, dtype=np.float64)
        gy = amp * np.exp(-((r - cy) ** 2) / (2 * sig ** 2))   # (F,S,H)
        gx = np.exp(-((r - cx) ** 2) / (2 * sig ** 2))         # (F,S,W)
        frames += np.einsum("fsh,fsw->fhw", gy, gx,
                            optimize=True).astype(np.float32)
    return frames, dark


_RENDER_CHUNK = 32   # frames per step: a 2048x2048 scan's float64 spot
#                      product would need 24.7 GB at once


def _simulate_on_device(n_frames: int, size: int, n_spots: int, seed: int,
                        dev: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`simulate_detector_frames` rendered on ``dev``, a chunk of
    frames at a time. Poisson(8) background and dark frame, spot centres
    U(8, size-8), amplitudes U(800, 4000), widths U(1, 2.5), rendered in
    float64 and added in float32 — the numpy path's distributions and
    arithmetic."""
    chunk = _RENDER_CHUNK
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f32, f64 = torch.float32, torch.float64
    dark = torch.poisson(torch.full((size, size), 8.0, dtype=f32, device=dev),
                         generator=g)
    frames = torch.empty((n_frames, size, size), dtype=f32, device=dev)
    for f0 in range(0, n_frames, chunk):
        frames[f0:f0 + chunk] = torch.poisson(
            torch.full((min(chunk, n_frames - f0), size, size), 8.0,
                       dtype=f32, device=dev), generator=g)
    if n_frames and n_spots:
        def uniform(lo: float, hi: float) -> torch.Tensor:
            u = torch.rand((n_frames, n_spots, 1), generator=g, dtype=f64,
                           device=dev)
            return lo + (hi - lo) * u
        cy, cx = uniform(8, size - 8), uniform(8, size - 8)
        amp, sig = uniform(800, 4000), uniform(1.0, 2.5)
        r = torch.arange(size, dtype=f64, device=dev)
        for f0 in range(0, n_frames, chunk):
            c = slice(f0, f0 + chunk)
            gy = amp[c] * torch.exp(-((r - cy[c]) ** 2) / (2 * sig[c] ** 2))
            gx = torch.exp(-((r - cx[c]) ** 2) / (2 * sig[c] ** 2))
            frames[c] += torch.einsum("fsh,fsw->fhw", gy, gx).to(f32)
    return frames.cpu().numpy(), dark.cpu().numpy()


def stream_to_fs(fabric: Fabric, frames: np.ndarray, prefix: str = "scan"
                 ) -> List[str]:
    """Detector -> shared FS, one file per frame (8 MB TIFFs in the paper)."""
    paths = []
    for i, frame in enumerate(frames):
        path = f"{prefix}/frame_{i:05d}.bin"
        fabric.fs.put(path, frame.astype(np.float32).view(np.uint8))
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# stage 1: reduction
# ---------------------------------------------------------------------------

def label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """Vectorized 4-connected component labeling (run-based two-pass).

    Pass 1 finds horizontal runs of the whole mask at once (a sentinel
    column keeps runs from spanning rows) and unions runs that overlap
    between adjacent rows; pass 2 paints final labels with one scatter.
    Work is O(H*W) vectorized + O(#runs) scalar — for sparse diffraction
    masks #runs is ~100x smaller than #pixels, which is what makes stage-1
    labeling faster than the filter kernel it post-processes.

    Label numbering matches ``_union_find_label`` exactly (components
    numbered by first pixel in row-major scan order), so the two are
    interchangeable; tests assert equivalence.
    """
    H, W = mask.shape
    m = np.ascontiguousarray(mask, dtype=bool)
    if not m.any():
        return np.zeros((H, W), np.int32), 0

    # --- pass 1a: horizontal runs over the flattened mask -----------------
    padded = np.zeros((H, W + 1), bool)          # sentinel column: runs
    padded[:, :W] = m                            # never cross a row edge
    flat = padded.ravel()
    d = np.diff(flat.view(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1           # every run closes (sentinel)
    if flat[0]:
        starts = np.concatenate(([0], starts))
    rows = starts // (W + 1)
    col_s = starts - rows * (W + 1)
    col_e = ends - rows * (W + 1)
    n_runs = len(starts)

    # --- pass 1b: union runs that overlap between adjacent rows ----------
    # Encode (row, col) into one monotone key so a SINGLE pair of
    # searchsorted calls finds, for every run i in row r, the contiguous
    # range [lo_i, hi_i) of row r-1 runs j with col_s[j] < col_e[i] and
    # col_e[j] > col_s[i] (4-connectivity overlap). Runs in other rows fall
    # outside [lo_i, hi_i) by key construction (row-0 runs get hi <= lo).
    stride = W + 2                               # > any col value
    key_s = rows * stride + col_s
    key_e = rows * stride + col_e
    target = (rows - 1) * stride
    lo = np.searchsorted(key_e, target + col_s, side="right")
    hi = np.searchsorted(key_s, target + col_e, side="left")
    n_ov = np.maximum(hi - lo, 0)
    pair_i = np.repeat(np.arange(n_runs), n_ov)
    off = np.concatenate(([0], n_ov.cumsum()[:-1]))
    pair_j = np.arange(n_ov.sum()) + np.repeat(lo - off, n_ov)

    parent = np.arange(n_runs, dtype=np.int64)

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in zip(pair_i.tolist(), pair_j.tolist()):
        ri, rj = find(i), find(j)
        if ri != rj:                         # min-root union keeps scan order
            if rj < ri:
                ri, rj = rj, ri
            parent[rj] = ri
    # full path compression, vectorized (log-depth)
    while True:
        p2 = parent[parent]
        if np.array_equal(p2, parent):
            break
        parent = p2

    # --- pass 2: renumber roots in scan order, paint runs -----------------
    roots = np.unique(parent)                # sorted == first-run order
    run_label = (np.searchsorted(roots, parent) + 1).astype(np.int32)
    lengths = ends - starts
    pos = (np.arange(lengths.sum()) + np.repeat(
        starts - np.concatenate(([0], lengths.cumsum()[:-1])), lengths))
    out = np.zeros(H * (W + 1), np.int32)
    out[pos] = np.repeat(run_label, lengths)
    return out.reshape(H, W + 1)[:, :W], len(roots)


def _union_find_label(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """Pure-Python pixel-loop 4-connected labeling. Kept as the reference
    oracle for :func:`label_components` (and the benchmark baseline) — the
    hot path uses the vectorized labeler."""
    H, W = mask.shape
    labels = np.zeros((H, W), np.int32)
    parent: List[int] = [0]

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    nxt = 1
    for i in range(H):
        for j in range(W):
            if not mask[i, j]:
                continue
            up = labels[i - 1, j] if i else 0
            left = labels[i, j - 1] if j else 0
            if up and left:
                ru, rl = find(up), find(left)
                labels[i, j] = ru
                if ru != rl:
                    parent[max(ru, rl)] = min(ru, rl)
            elif up or left:
                labels[i, j] = up or left
            else:
                parent.append(nxt)
                labels[i, j] = nxt
                nxt += 1
    remap: Dict[int, int] = {}
    count = 0
    for i in range(H):
        for j in range(W):
            if labels[i, j]:
                r = find(labels[i, j])
                if r not in remap:
                    count += 1
                    remap[r] = count
                labels[i, j] = remap[r]
    return labels, count


@dataclass
class ReducedFrame:
    frame_id: int
    n_signal_pixels: int
    n_spots: int
    peaks: np.ndarray              # (n_spots, 3): y, x, intensity


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev`` as a tensor. Staged replicas are read-only views;
    nothing here writes to the tensor, so torch's warning about a
    non-writable source is moot."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _lap(dev: torch.device, timings: Optional[Dict[str, float]], key: str,
         t0: float) -> float:
    """Add the wall seconds since ``t0`` to ``timings[key]`` (device work
    included) and return the new start time; a no-op without ``timings``."""
    if timings is None:
        return t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = _time.perf_counter()
    timings[key] = timings.get(key, 0.0) + (t - t0)
    return t


def reduce_frames(frames: np.ndarray, dark: np.ndarray,
                  threshold: float = 200.0, use_kernel: bool = True,
                  device: DeviceLike = "cuda",
                  timings: Optional[Dict[str, float]] = None
                  ) -> List[ReducedFrame]:
    """Stage-1 reduction of a frame stack (paper: 8 MB -> ~1 MB binary).

    The filter runs on ``device``: ``use_kernel=True`` through
    ``ops.hedm_reduce`` (the CUDA kernel on a card), ``False`` through its
    plain PyTorch version. Frames other than float32/uint16 are cast to
    float32 for the filter, as the oracle casts them; the centroids weigh
    the frames as given. ``timings``, when given, accumulates wall seconds
    per phase: ``h2d``, ``kernel`` (the filter), ``d2h`` and ``labeling``
    (labels and centroids on the host).
    """
    dev = resolve_device(device)
    filter_in = (frames if frames.dtype in (np.float32, np.uint16)
                 else frames.astype(np.float32))
    if timings is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = _time.perf_counter()
    frames_t = _tensor(filter_in, dev)
    dark_t = _tensor(np.asarray(dark, dtype=np.float32), dev)
    t = _lap(dev, timings, "h2d", t)
    if use_kernel:
        from repro_torch.kernels.ops import hedm_reduce
        masks, counts = hedm_reduce(frames_t, dark_t, threshold=threshold)
    else:
        from repro_torch.kernels.hedm_reduce import reference
        masks, counts = reference(frames_t, dark_t, threshold=threshold)
    del frames_t, filter_in
    t = _lap(dev, timings, "kernel", t)
    masks = masks.cpu().numpy()
    counts = counts.cpu().numpy()
    t = _lap(dev, timings, "d2h", t)
    H, W = frames.shape[1:]
    yy, xx = np.divmod(np.arange(H * W), W)
    out = []
    for f in range(frames.shape[0]):
        labels, n = label_components(masks[f] > 0)
        # intensity-weighted centroids: one bincount pass per moment instead
        # of a per-label nonzero scan over the full frame
        lab = labels.ravel()
        sel = np.flatnonzero(lab)
        l_s, v_s = lab[sel], frames[f].ravel()[sel].astype(np.float64)
        s_i = np.bincount(l_s, weights=v_s, minlength=n + 1)
        s_y = np.bincount(l_s, weights=v_s * yy[sel], minlength=n + 1)
        s_x = np.bincount(l_s, weights=v_s * xx[sel], minlength=n + 1)
        denom = np.maximum(s_i, 1e-9)
        peaks = np.stack([s_y / denom, s_x / denom, s_i],
                         axis=1)[1:].astype(np.float32)
        out.append(ReducedFrame(f, int(counts[f]), n, peaks))
    _lap(dev, timings, "labeling", t)
    return out


# ---------------------------------------------------------------------------
# online (streaming) stage-1 mode
# ---------------------------------------------------------------------------

def reduce_frames_online(frames: np.ndarray, dark: np.ndarray,
                         window: int = 8, threshold: float = 200.0,
                         use_kernel: bool = True,
                         device: DeviceLike = "cuda"
                         ) -> Iterator[List[ReducedFrame]]:
    """Incremental stage-1: yield per-window ``ReducedFrame`` lists.

    The filter/label/centroid chain is per-frame independent, so splitting
    the frame axis into windows of `window` is bit-identical to one batch
    ``reduce_frames`` call over the whole stack (tests assert it); frame
    ids are global. This is the compute half of the online mode — the
    simulated-time half (delivery, backpressure, turnaround) lives in
    :func:`run_online_hedm`.
    """
    dev = resolve_device(device)
    for w0 in range(0, frames.shape[0], window):
        chunk = reduce_frames(frames[w0:w0 + window], dark,
                              threshold=threshold, use_kernel=use_kernel,
                              device=dev)
        for r in chunk:
            r.frame_id += w0
        yield chunk


@dataclass
class OnlineHEDMResult:
    """Outcome of a streamed stage-1 run (times in simulated seconds)."""
    reduced: List[ReducedFrame]
    window_done: List[float]       # completion time of each reduce window
    turnaround: float              # last window done = end-to-end latency
    stream: "object"               # StreamReport of the ingest side


def run_online_hedm(fabric: Fabric, frames: np.ndarray, dark: np.ndarray,
                    rate_hz: Optional[float] = 10.0, window: int = 8,
                    threshold: float = 200.0, use_kernel: bool = True,
                    cache_frames: Optional[int] = None,
                    reduce_time_per_frame: Optional[float] = None,
                    device: DeviceLike = "cuda"
                    ) -> OnlineHEDMResult:
    """Online HEDM: ingest a streamed acquisition and reduce per window.

    Frames stream through a :class:`repro_torch.core.streaming.StreamStager`
    (scatter + ring broadcast, sliding window of ``cache_frames`` frames —
    ``None`` keeps the whole scan resident); every full window is reduced
    FROM THE STAGED NODE-LOCAL REPLICA the moment its last frame lands,
    overlapping compute with acquisition. Consumed frames are released
    back to the window (enabling eviction/backpressure).

    ``reduce_time_per_frame`` is the simulated stage-1 cost per frame (s);
    ``None`` charges the measured wall time of the real reduction instead
    (the `ManyTaskEngine` payload idiom). Outputs are bit-identical to
    ``reduce_frames`` over the same stack.
    """
    from repro_torch.core.api import StagingClient, StreamConfig
    from repro_torch.core.streaming import DetectorSource

    dev = resolve_device(device)
    if cache_frames is not None and cache_frames < window:
        raise ValueError(
            f"cache_frames ({cache_frames}) must be >= window ({window}): "
            f"frames are only released once a full reduce window has run, "
            f"so a smaller cache wedges the stream")
    # detector emits float32, same cast as the batch path's stream_to_fs —
    # keeps the 4-byte/pixel window accounting and replica decode honest
    frames = np.ascontiguousarray(frames, dtype=np.float32)
    F, H, W = frames.shape
    frame_bytes = H * W * 4
    config = StreamConfig(rate_hz=rate_hz,
                          window_bytes=(cache_frames or F) * frame_bytes)
    src = DetectorSource.from_frames(frames, rate_hz=config.rate_hz)
    stager = StagingClient(fabric).stream_stager(config)

    reduced: List[ReducedFrame] = []
    window_done: List[float] = []
    pending: List = []
    t_done = 0.0
    store = fabric.hosts[0].store
    for fid, path, buf, t_emit in src:
        pending.append(stager.ingest(path, buf, t_emit))
        if len(pending) == window or fid == F - 1:
            stack = np.stack([store.data[r.path].view(np.float32)
                              .reshape(H, W) for r in pending])
            t_wall = _time.perf_counter()
            chunk = reduce_frames(stack, dark, threshold=threshold,
                                  use_kernel=use_kernel, device=dev)
            wall = _time.perf_counter() - t_wall
            dur = (reduce_time_per_frame * len(pending)
                   if reduce_time_per_frame is not None else wall)
            base = pending[0].frame_id
            for r in chunk:
                r.frame_id += base
            t_start = max(t_done, max(r.t_avail for r in pending))
            t_done = t_start + dur
            for r in pending:
                stager.release(r.path, t_done)
            reduced.extend(chunk)
            window_done.append(t_done)
            pending = []
    return OnlineHEDMResult(reduced=reduced, window_done=window_done,
                            turnaround=t_done, stream=stager.finish())


def run_batch_hedm(fabric: Fabric, frames: np.ndarray, dark: np.ndarray,
                   rate_hz: Optional[float] = 10.0, threshold: float = 200.0,
                   use_kernel: bool = True, mode: str = "collective",
                   reduce_time_per_frame: Optional[float] = None,
                   device: DeviceLike = "cuda"
                   ) -> Tuple[List[ReducedFrame], float, "object"]:
    """Stage-then-process baseline for the same scan as ``run_online_hedm``.

    The detector writes every frame to the shared FS first (acquisition
    completes at ``F / rate_hz`` simulated s; the producer write itself is
    not charged, which favors this baseline), the whole scan is staged with
    the batch engine `mode` through the unified client (concrete paths, no
    glob resolution or pinning — ``resolve=False``), then stage-1 runs
    over the staged node-local replicas in one pass. Returns
    ``(reduced, turnaround, StagingReport)``.
    """
    from repro_torch.core.api import (BroadcastEntry, ENGINES, StagingClient,
                                      StagingSpec)
    dev = resolve_device(device)
    config = ENGINES.config_for(mode, batch_only=True)

    F, H, W = frames.shape
    paths = stream_to_fs(fabric, frames)
    t_acq = F / rate_hz if rate_hz else 0.0
    spec = StagingSpec([BroadcastEntry(files=tuple(paths), pin=False)])
    crep = StagingClient(fabric).stage(spec, config, t0=t_acq, resolve=False)
    # same arithmetic as the engine's returned completion time (bit-exact)
    rep = crep.reports[0]
    t_staged = t_acq + rep.total_time

    store = fabric.hosts[0].store
    stack = np.stack([store.data[p].view(np.float32).reshape(H, W)
                      for p in paths])
    t_wall = _time.perf_counter()
    reduced = reduce_frames(stack, dark, threshold=threshold,
                            use_kernel=use_kernel, device=dev)
    wall = _time.perf_counter() - t_wall
    dur = (reduce_time_per_frame * F
           if reduce_time_per_frame is not None else wall)
    return reduced, t_staged + dur, rep


# ---------------------------------------------------------------------------
# interactive (multi-session) mode over the dataset catalog + service
# ---------------------------------------------------------------------------

def pack_reduced(reduced: Sequence[ReducedFrame]) -> np.ndarray:
    """Flat float32 write-back payload for a reduced scan: per frame a
    ``[frame_id, n_signal_pixels, n_spots]`` header followed by the
    ``(n_spots, 3)`` peak rows. Deterministic, so two sessions reducing
    the same staged dataset produce byte-identical buffers — the
    write-back byte-exactness criterion."""
    parts = []
    for r in reduced:
        parts.append(np.array([r.frame_id, r.n_signal_pixels, r.n_spots],
                              np.float32))
        parts.append(np.ascontiguousarray(r.peaks, np.float32).ravel())
    return (np.concatenate(parts) if parts else np.zeros(0, np.float32))


@dataclass
class SessionScript:
    """One tenant's plan: which datasets it reduces, in order, starting at
    ``t_start`` (simulated s). ``reduce_s_per_frame`` is the declared
    stage-1 cost (the ManyTaskEngine duration idiom — keeps multi-session
    schedules deterministic)."""
    name: str
    datasets: List[str]
    t_start: float = 0.0
    reduce_s_per_frame: float = 0.15


@dataclass
class InteractiveHEDMResult:
    """Outcome of a multi-session interactive run (times simulated s)."""
    outputs: Dict[str, Dict[str, np.ndarray]]   # session -> dataset -> packed
    result_paths: Dict[str, Dict[str, str]]     # session -> dataset -> FS path
    session_done: Dict[str, float]              # flush completion per session
    writeback: Dict[str, "object"]              # session -> StagingReport
    service: "object"                           # the StagingService (stats)
    turnaround: float                           # last session flush


def run_interactive_hedm(fabric: Fabric, scans: Dict[str, np.ndarray],
                         dark: np.ndarray,
                         sessions: Sequence[SessionScript],
                         budget_bytes: int, threshold: float = 200.0,
                         use_kernel: bool = False, mode: str = "collective",
                         collective_writeback: bool = True,
                         device: DeviceLike = "cuda"
                         ) -> InteractiveHEDMResult:
    """N concurrent analysis sessions over M scans through the staging
    service — the paper's interactive regime (§VI-B) plus write-back.

    Every scan lands on the shared FS (stage 0) and registers in the
    catalog. Sessions then interleave round-robin: each leases its next
    dataset (concurrent requests COALESCE into one collective stage;
    unleased residents evict under ``budget_bytes`` and re-stage
    transparently on a later miss), reduces stage-1 FROM THE RESIDENT
    NODE-LOCAL REPLICA (charged: replica read at ``local_read_bw`` +
    ``reduce_s_per_frame`` per frame), installs the packed result as a
    dirty replica, and releases the lease. When a session's script is
    done it FLUSHES its results to the shared FS (collective
    ``stage_out`` or the naive baseline).

    Outputs are bit-identical to reducing each scan directly — eviction
    and re-staging never change bytes, only times (tests assert this).
    """
    from contextlib import ExitStack

    from repro_torch.core.api import ENGINES, ServiceConfig, StagingClient

    dev = resolve_device(device)
    scans32 = {n: np.ascontiguousarray(f, dtype=np.float32)
               for n, f in scans.items()}
    for name, frames in scans32.items():
        stream_to_fs(fabric, frames, prefix=name)
    client = StagingClient(fabric, service=ServiceConfig(
        budget_bytes=budget_bytes,
        engine=ENGINES.config_for(mode, batch_only=True)))
    svc = client.service
    for name in scans32:
        svc.register(name, patterns=[f"{name}/frame_*.bin"])

    clocks = {s.name: s.t_start for s in sessions}
    outputs: Dict[str, Dict[str, np.ndarray]] = {s.name: {} for s in sessions}
    result_paths: Dict[str, Dict[str, str]] = {s.name: {} for s in sessions}
    c = fabric.constants

    session_done: Dict[str, float] = {}
    writeback: Dict[str, object] = {}
    with ExitStack() as stack:
        # session-scoped campaigns: any lease a tenant still holds when
        # the stack unwinds (including on error) is auto-released
        handles = {s.name: stack.enter_context(client.session(s.name))
                   for s in sessions}
        for step in range(max(len(s.datasets) for s in sessions)):
            for script in sessions:
                if step >= len(script.datasets):
                    continue
                ds = script.datasets[step]
                sess = handles[script.name]
                lease = sess.acquire(ds, clocks[script.name])
                entry = svc.catalog[ds]
                F, H, W = scans32[ds].shape
                store = fabric.hosts[0].store
                stack_ = np.stack([store.data[p].view(np.float32)
                                   .reshape(H, W) for p in entry.paths])
                reduced = reduce_frames(stack_, dark, threshold=threshold,
                                        use_kernel=use_kernel, device=dev)
                packed = pack_reduced(reduced)
                t_compute = (lease.t_ready
                             + entry.nbytes / c.local_read_bw  # replica read
                             + script.reduce_s_per_frame * F)
                path, t_put = sess.put_result(ds, packed, t_compute)
                sess.release(ds, t_put)
                clocks[script.name] = t_put
                outputs[script.name][ds] = packed
                result_paths[script.name][ds] = path

        for script in sessions:
            rep, t_done = handles[script.name].flush(
                clocks[script.name], collective=collective_writeback)
            writeback[script.name] = rep
            session_done[script.name] = t_done
    return InteractiveHEDMResult(
        outputs=outputs, result_paths=result_paths,
        session_done=session_done, writeback=writeback, service=svc,
        turnaround=max(session_done.values()) if session_done else 0.0)


# ---------------------------------------------------------------------------
# stage 2: orientation fitting (batched Gauss-Newton)
# ---------------------------------------------------------------------------

N_GVEC = 24          # reference reciprocal-lattice directions per point

ArrayLike = Union[np.ndarray, torch.Tensor]


def _rotation(angles: torch.Tensor) -> torch.Tensor:
    """ZYZ Euler rotation matrix from 3 angles."""
    a, b, c = angles[0], angles[1], angles[2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    one, zero = torch.ones_like(a), torch.zeros_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    rz1 = mat([[ca, -sa, zero], [sa, ca, zero], [zero, zero, one]])
    ry = mat([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
    rz2 = mat([[cc, -sc, zero], [sc, cc, zero], [zero, zero, one]])
    return rz1 @ ry @ rz2


def make_gvectors(seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(N_GVEC, 3))
    return (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)


def forward_model(angles: torch.Tensor, gvec: torch.Tensor) -> torch.Tensor:
    """Simulated diffraction signature of an orientation (nonlinear)."""
    R = _rotation(angles)
    rotated = gvec @ R.T                              # (N,3)
    det_normal = torch.tensor([0.0, 0.0, 1.0], dtype=gvec.dtype,
                              device=gvec.device)
    proj = rotated @ det_normal                       # (N,)
    return torch.cat([torch.sin(3.0 * rotated[:, 0]) * proj,
                      torch.cos(2.0 * rotated[:, 1]) * proj])


def fit_orientation(y_obs: torch.Tensor, gvec: torch.Tensor,
                    theta0: torch.Tensor, iters: int = 12,
                    damping: float = 1e-3) -> torch.Tensor:
    """Gauss-Newton (Levenberg-damped) fit of one grid point."""
    eye = torch.eye(3, dtype=theta0.dtype, device=theta0.device)
    jac = torch.func.jacfwd(lambda t: forward_model(t, gvec))
    theta = theta0
    for _ in range(iters):
        r = forward_model(theta, gvec) - y_obs
        J = jac(theta)                                # (M,3)
        JtJ = J.T @ J + damping * eye
        delta = torch.linalg.solve(JtJ, J.T @ r)
        theta = theta - delta
    return theta


def _as_f32(x: ArrayLike, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def fit_grid(y_obs: ArrayLike, gvec: ArrayLike, theta0: ArrayLike,
             iters: int = 12, device: DeviceLike = "cuda") -> torch.Tensor:
    """vmapped FitOrientation over all grid points: (Npts, M) -> (Npts, 3),
    float32 on ``device``. One batched program over the point axis — the
    many-task structure of Fig. 8 expressed as data parallelism.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False``: the fit's
    products and 3x3 solves stay in full float32, as in the reference."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = _as_f32(gvec, dev)
    return torch.func.vmap(lambda y, t0: fit_orientation(y, g, t0, iters))(
        _as_f32(y_obs, dev), _as_f32(theta0, dev))


def synth_grid_observations(n_points: int, gvec: np.ndarray, seed: int = 3,
                            noise: float = 0.01, device: DeviceLike = "cuda"
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth orientations + noisy observed signatures (numpy; the
    forward model runs on ``device``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    truth = rng.uniform(-0.6, 0.6, (n_points, 3)).astype(np.float32)
    g = _as_f32(gvec, dev)
    obs = torch.func.vmap(lambda t: forward_model(t, g))(_as_f32(truth, dev))
    obs = obs.cpu().numpy()
    obs = obs + rng.normal(0, noise, obs.shape).astype(np.float32)
    return truth, obs
