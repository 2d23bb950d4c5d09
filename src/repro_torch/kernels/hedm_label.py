"""NF-HEDM stage-1 labeling and centroids: the CUDA kernel and the host
algorithm it replaces.

After ``hedm_reduce`` (K1) has thresholded a stack of frames into a uint8
mask, each frame's 4-connected components ("spots") are numbered by their
first pixel in row-major order, and each spot is weighed by the frame's
pixels as given: ``s_i = sum v``, ``s_y = sum v*y``, ``s_x = sum v*x`` in
float64, summed in ascending pixel order, and its peak is ``(s_y / d,
s_x / d, s_i)`` with ``d = max(s_i, 1e-9)``, rounded to float32.

The host algorithm: :func:`label_components` numbers one frame's spots
(:func:`_union_find_label` is its pixel-by-pixel oracle), and
:func:`reference` weighs them by one ``np.bincount`` a moment
(:func:`signal_index` and :func:`centroids` are its two halves);
``repro_torch.hedm.pipeline.reduce_frames`` runs it on the CPU and with
``use_kernel=False``. :func:`hedm_label` is the direct entry: a mask and
frames in, ``(n_signal, n_spots, peaks)`` out on the host. On a CPU
tensor it runs :func:`reference`; on a CUDA tensor it runs the kernels of
``csrc/hedm_label.cu`` (built for sm_90a at first use, see
`repro_torch.kernels._build`) in two passes, each on the current stream
with no synchronize:

* :func:`label` numbers the components on the card and counts them per
  frame into a (2, F) int32 head (signal pixels, spots);
* the head comes back (the first blocking copy), which sizes the peaks;
* :func:`weigh` writes the peaks, and they come back (the second).

The weights are the frames as given where the card has a pass 2 for their
type (float32, uint16, float64), else the frames cast to float64 on the
card, which is what the host weighs too. uint16 weights at a frame size
where every sum is an integer below 2**53 (:func:`_exact_sums`) are summed
in any order, by atomics; other weights in ascending pixel order.

The passes go over chunks of whole frames of at most
:data:`CHUNK_PIXELS` pixels, so the scratch (:func:`scratch_ints`, 12
bytes a pixel of a chunk) never grows with the stack. With more than one
chunk, pass 2 labels each chunk again before weighing it, since the
chunks share one scratch. ``hedm_label.launches`` counts the calls into
the library, one a chain of launches on the stream: pass 1 a chunk, and
in pass 2 a chunk's relabeling and its weighing. The source note in
``csrc/hedm_label.cu`` says what bounds the kernels and what their design
does about it.
"""
from __future__ import annotations

from ctypes import c_int, c_void_p
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

#: most pixels a chunk of pass 1 and 2: 8 frames of 2048x2048
CHUNK_PIXELS = 1 << 25
#: pass 2 in ascending pixel order, by the weights' type
_WEIGH = {torch.float32: "hedm_label_weigh_f32",
          torch.uint16: "hedm_label_weigh_u16",
          torch.float64: "hedm_label_weigh_f64"}
_MAX_FRAME = 1 << 30            # pixels a frame: the kernel's int32 indices


# ---------------------------------------------------------------------------
# the host algorithm
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



def signal_index(masks: np.ndarray
                 ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per frame of a (F, H, W) mask, its nonzero pixels in ascending order:
    ``(flat index in the frame, y, x)``, int64."""
    F, H, W = masks.shape
    flat = np.flatnonzero(masks)
    frame, pix = np.divmod(flat, H * W)
    yy, xx = np.divmod(pix, W)
    cut = np.searchsorted(frame, np.arange(F + 1))
    return [(pix[a:b], yy[a:b], xx[a:b]) for a, b in zip(cut[:-1], cut[1:])]


def centroids(labels: np.ndarray, n: int, values: np.ndarray,
              yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """(n, 3) float32 peaks of one frame from its signal pixels in ascending
    order: their labels (1..n), values as given, rows and columns. One
    ``np.bincount`` a moment, which sums in the pixels' order."""
    v = values.astype(np.float64)
    s_i = np.bincount(labels, weights=v, minlength=n + 1)
    s_y = np.bincount(labels, weights=v * yy, minlength=n + 1)
    s_x = np.bincount(labels, weights=v * xx, minlength=n + 1)
    denom = np.maximum(s_i, 1e-9)
    return np.stack([s_y / denom, s_x / denom, s_i],
                    axis=1)[1:].astype(np.float32)


def reference(mask: np.ndarray, frames: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """mask (F, H, W) (nonzero: signal) and frames (F, H, W) of any dtype ->
    (n_signal (F,) int32, n_spots (F,) int32, peaks (sum n_spots, 3)
    float32, frame after frame), on the host."""
    F = mask.shape[0]
    n_signal = np.zeros(F, np.int32)
    n_spots = np.zeros(F, np.int32)
    peaks = [np.zeros((0, 3), np.float32)]
    for f, (sel, yy, xx) in enumerate(signal_index(mask)):
        labels, n = label_components(mask[f] > 0)
        n_signal[f], n_spots[f] = len(sel), n
        peaks.append(centroids(labels.ravel()[sel], n,
                               frames[f].ravel()[sel], yy, xx))
    return n_signal, n_spots, np.concatenate(peaks)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def scratch_ints(F: int, H: int, W: int) -> int:
    """int32 elements of a chunk's scratch (``struct Scratch`` in
    ``csrc/hedm_label.cu``): a parent slot a pixel, a count a row, and a
    root and a bounding box (xmin, xmax, ymax) for each of the most
    components F frames can hold, ceil(H * W / 2) a frame."""
    return F * H * W + F * H + 4 * F * -(-(H * W) // 2)


def _exact_sums(H: int, W: int) -> bool:
    """Whether every float64 sum of uint16 weights (and of their products
    with a row or column) over a component of an H x W frame is an integer
    of at most 2**53, so that any order of summation gives the same bits."""
    return 65535 * max(H, W) * H * W <= 1 << 53


@dataclass
class Labeling:
    """Pass 1's state on the card, for :func:`weigh`. ``head`` (2, F) int32
    holds each frame's signal pixels and spots once the stream reaches
    it; ``chunks`` are the frame ranges that share ``scratch``;
    ``weights`` are the frames as pass 2 reads them."""
    mask: torch.Tensor
    weights: torch.Tensor
    scratch: torch.Tensor
    head: torch.Tensor
    chunks: List[Tuple[int, int]]


def _check(mask: torch.Tensor, frames: torch.Tensor) -> None:
    if mask.dim() != 3 or frames.shape != mask.shape:
        raise ValueError(f"expected mask and frames (F,H,W) of one shape, got "
                         f"{tuple(mask.shape)} and {tuple(frames.shape)}")
    if mask.dtype != torch.uint8:
        raise TypeError(f"mask must be uint8, got {mask.dtype}")
    if mask.device != frames.device:
        raise ValueError(f"mask on {mask.device}, frames on {frames.device}")


def _chunks(F: int, H: int, W: int) -> List[Tuple[int, int]]:
    """Frame ranges of at most :data:`CHUNK_PIXELS` pixels (one frame at
    least) and 65535 frames (gridDim.z)."""
    if H * W == 0:
        return []
    step = max(1, min(CHUNK_PIXELS // (H * W), 65535))
    return [(f0, min(f0 + step, F)) for f0 in range(0, F, step)]


def _at(t: torch.Tensor, offset: int) -> int:
    """Address of element ``offset`` of contiguous ``t``."""
    return t.data_ptr() + int(offset) * t.element_size()


def _label_chunk(lab: Labeling, f0: int, f1: int, count: bool) -> None:
    """Pass 1 over frames f0..f1 into the scratch; ``count`` adds their
    counts to the head (pass 2 labels a chunk again without)."""
    F, H, W = lab.mask.shape
    head = ((_at(lab.head, f0), _at(lab.head, F + f0)) if count
            else (None, None))
    _LIB.launch("hedm_label_chunk", lab.mask.device,
                _at(lab.mask, f0 * H * W), f1 - f0, H, W,
                lab.scratch.data_ptr(), *head)


def label(mask: torch.Tensor, frames: torch.Tensor) -> Labeling:
    """Pass 1 on CUDA tensors: number every frame's components. Launches
    on the current stream and returns at once; ``head`` is filled when the
    stream reaches it. Frames of a type :data:`_WEIGH` lacks are cast to
    float64 on the card for pass 2."""
    _check(mask, frames)
    if not _build.on_card("hedm_label", mask, frames):
        raise ValueError(f"unsupported device {mask.device}")
    F, H, W = mask.shape
    if H * W > _MAX_FRAME:
        raise ValueError(f"at most {_MAX_FRAME} pixels a frame, got "
                         f"{H}x{W}")
    chunks = _chunks(F, H, W)
    step = chunks[0][1] if chunks else 0
    lab = Labeling(mask,
                   frames if frames.dtype in _WEIGH
                   else frames.to(torch.float64),
                   torch.empty(scratch_ints(step, H, W), dtype=torch.int32,
                               device=mask.device),
                   torch.zeros((2, F), dtype=torch.int32, device=mask.device),
                   chunks)
    for f0, f1 in chunks:
        _label_chunk(lab, f0, f1, count=True)
    return lab


def weigh(lab: Labeling, n_spots: np.ndarray) -> torch.Tensor:
    """Pass 2: the (sum n_spots, 3) float32 peaks on the card, frame after
    frame, given pass 1's head's spot counts on the host."""
    F, H, W = lab.mask.shape
    dev = lab.mask.device
    ends = np.concatenate(([0], np.cumsum(n_spots, dtype=np.int64)))
    peaks = torch.empty((int(ends[-1]), 3), dtype=torch.float32, device=dev)
    exact = lab.weights.dtype == torch.uint16 and _exact_sums(H, W)
    if exact:       # the sums of the largest chunk, zeroed a chunk at a time
        most = max((int(ends[b] - ends[a]) for a, b in lab.chunks), default=0)
        sums = torch.empty((most, 3), dtype=torch.float64, device=dev)
    for f0, f1 in lab.chunks:
        K = int(ends[f1] - ends[f0])
        if not K:
            continue
        if len(lab.chunks) > 1:   # the scratch holds the last chunk
            _label_chunk(lab, f0, f1, count=False)
        at = f0 * H * W
        args = (_at(lab.mask, at), _at(lab.weights, at), f1 - f0, H, W,
                lab.scratch.data_ptr(), K)
        out = _at(peaks, 3 * ends[f0])
        if exact:
            _LIB.launch("hedm_label_weigh_u16_exact", dev, *args,
                        sums.data_ptr(), out)
        else:
            _LIB.launch(_WEIGH[lab.weights.dtype], dev, *args, out)
    return peaks


def hedm_label(mask: torch.Tensor, frames: torch.Tensor
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """mask (F,H,W) uint8 and frames (F,H,W) on one device -> (n_signal (F,)
    int32, n_spots (F,) int32, peaks (sum n_spots, 3) float32) on the host.

    A CUDA input (contiguous) runs the kernels: :func:`label`, the head's
    copy, :func:`weigh`, the peaks' copy. A CPU input runs
    :func:`reference`."""
    _check(mask, frames)
    if mask.device.type == "cpu":
        return reference(mask.numpy(), frames.numpy())
    lab = label(mask, frames)
    n_signal, n_spots = lab.head.cpu().numpy()
    return n_signal, n_spots, weigh(lab, n_spots).cpu().numpy()


_P, _I = c_void_p, c_int
_LIB = _build.Library(
    "hedm_label",
    {"hedm_label_chunk": [_P, _I, _I, _I, _P, _P, _P],
     "hedm_label_weigh_u16_exact": [_P, _P, _I, _I, _I, _P, _I, _P, _P],
     **{name: [_P, _P, _I, _I, _I, _P, _I, _P]
        for name in _WEIGH.values()}}, hedm_label)
