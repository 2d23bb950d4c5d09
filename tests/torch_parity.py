"""Helpers for holding the port's results equal to the reference package's.

Imports neither JAX nor the reference package, so that the tests that run
only on a card can use it where JAX is not installed.

``plain`` turns a result of either package into plain Python values, so
that the two compare with ``==`` although their classes differ: dataclasses
become ``(class name, {field: value})``, enums their value, numpy arrays
``(dtype, shape, bytes)``. Other objects (a service, a fabric) reduce to
their class name, because they are compared through what they report.
"""
import dataclasses
import enum
import hashlib

import numpy as np


def plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (str, int, float, bool, type(None))):
        return x
    return type(x).__name__


def stores(fabric):
    """Every host's node-local store as ``{host: {path: sha256 of bytes}}``."""
    return {h.host_id: {p: hashlib.sha256(np.ascontiguousarray(d)).hexdigest()
                        for p, d in sorted(h.store.data.items())}
            for h in fabric.hosts}


def spot_case(dtype):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 40, (4, 64, 64)).astype(np.float32)
    frames[1, 10:13, 40:43] += 3000
    dark = np.full((64, 64), 8.0, np.float32)
    return frames.astype(dtype), dark, 150.0, None


def _tiled(H, W, tile, dtype):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 40, (2, H, W)).astype(np.float32)
    frames[0, H // 2:H // 2 + 3, W // 2:W // 2 + 3] += 3000
    frames[1, 0:3, 0:3] += 3000                # spot crossing the edge
    dark = np.full((H, W), 8.0, np.float32)
    return frames.astype(dtype), dark, 150.0, tile


def _noisy(seed, H, W, tile, dtype):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 400, (2, H, W)).astype(dtype)
    return frames, np.zeros((H, W), np.float32), 150.0, tile


def pure_noise_case(dtype):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 30, (2, 96, 96)).astype(dtype)
    return frames, np.full((96, 96), 10.0, np.float32), 500.0, None


def _full_range_u16():
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 65536, (2, 33, 40)).astype(np.uint16)
    dark = rng.uniform(0, 30000, (33, 40)).astype(np.float32)
    return frames, dark, 5000.0, 16


#: hedm_reduce inputs: the cases of tests/test_kernels.py (spot, row-tiled
#: shapes, the noisy-border sweep, pure noise) and uint16 frames, as
#: ``name -> () -> (frames, dark, threshold, Pallas tile_rows)``.
HEDM_REDUCE_CASES = {
    "spot": lambda: spot_case(np.float32),
    "tiled-64x64": lambda: _tiled(64, 64, 16, np.float32),
    "tiled-72x48": lambda: _tiled(72, 48, 32, np.float32),
    "tiled-40x56": lambda: _tiled(40, 56, 8, np.float32),
    "pure-noise": lambda: pure_noise_case(np.float32),
    **{f"noisy-s{s}-{H}x{W}": (lambda s=s, H=H, W=W, t=t:
                               _noisy(s, H, W, t, np.float32))
       for s in range(5) for H, W, t in [(24, 24, 8), (20, 16, 8),
                                         (21, 24, 16)]},
    "u16-spot": lambda: spot_case(np.uint16),
    "u16-tiled-72x48": lambda: _tiled(72, 48, 32, np.uint16),
    "u16-noisy-21x24": lambda: _noisy(0, 21, 24, 4, np.uint16),
    "u16-pure-noise": lambda: pure_noise_case(np.uint16),
    "u16-full-range": _full_range_u16,
}
