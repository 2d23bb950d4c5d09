"""Peaks of the card and the work of each measured layer, counted from the
shapes and the mathematics, not from what implements them.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # outside the tensor cores
BF16_FLOPS = 989e12


def hedm_reduce_bytes(frames: int, height: int, width: int,
                      itemsize: int) -> int:
    """Stage 1's filter: the frames read once, the float32 dark frame once,
    the uint8 mask and the int32 counts written once."""
    plane = height * width
    return frames * plane * itemsize + plane * 4 + frames * plane + frames * 4


def hedm_reduce_seconds(frames: int, height: int, width: int,
                        itemsize: int) -> float:
    """The filter's least time: bound by HBM bytes."""
    return hedm_reduce_bytes(frames, height, width, itemsize) / HBM_BYTES_PER_S


def fit_flops_per_iteration(n_gvec: int) -> int:
    """Float32 operations of one Gauss-Newton step of one grid point, a
    transcendental counted as one: sines and cosines of the angles (6), R
    as two 3x3 products (90), the rotated g-vectors (15 N), the signature
    (6 N), the residual (2 N), the three dR (270) and their rotated
    g-vectors (45 N), the Jacobian's entries (28 N), the 6 distinct
    entries of J^T J (24 N) and the damping (3), J^T r (12 N), the 3x3
    solve (40) and the update (3)."""
    n = n_gvec
    return 6 + 90 + 15 * n + 6 * n + 2 * n + 270 + 45 * n + 28 * n \
        + 24 * n + 3 + 12 * n + 40 + 3


def fit_flops(points: int, n_gvec: int, iters: int) -> int:
    return points * iters * fit_flops_per_iteration(n_gvec)


def fit_bytes(points: int, n_gvec: int) -> int:
    """The observations and the starting orientations read once, the
    fitted ones written once, the g-vectors read once (float32)."""
    return 4 * (points * 2 * n_gvec + 2 * points * 3 + n_gvec * 3)


def fit_seconds(points: int, n_gvec: int, iters: int) -> float:
    """The fit's least time: the larger of its FLOPs at the fp32 peak and
    its bytes at HBM's."""
    return max(fit_flops(points, n_gvec, iters) / FP32_FLOPS,
               fit_bytes(points, n_gvec) / HBM_BYTES_PER_S)
