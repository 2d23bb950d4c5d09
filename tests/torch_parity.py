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


#: flash_attention cases ``(B, S, H, KV, hd, causal, window)``: the shapes
#: of tests/test_kernels.py, then ragged S (not a multiple of any tile) with
#: the head dims of zamba2 (112) and danube3 (120), and a bidirectional
#: windowed case with 4 query heads per kv head.
FLASH_SHAPES = [
    (2, 256, 8, 4, 64, True, 0),
    (1, 256, 4, 4, 128, True, 64),
    (2, 128, 8, 2, 32, False, 0),
    (1, 512, 8, 8, 64, True, 0),
    (1, 256, 16, 4, 64, True, 128),
    (1, 100, 4, 2, 112, True, 0),
    (1, 200, 8, 2, 120, True, 48),
    (1, 37, 4, 1, 32, False, 16),
]

#: mamba2_scan cases ``(B, L, H, P, G, N, chunk)``: the shapes of
#: tests/test_kernels.py, then a ragged L (100 is no multiple of the chunk)
#: at the model's chunk of 128 and at 32.
SCAN_SHAPES = [
    (2, 128, 4, 16, 2, 8, 32),
    (1, 64, 2, 32, 1, 16, 16),
    (1, 256, 8, 16, 8, 8, 64),
    (1, 100, 4, 16, 2, 8, 32),
    (1, 100, 4, 64, 1, 64, 128),
]


def flash_inputs(B, S, H, KV, hd, seed=0):
    """q (B,S,H,hd), k and v (B,S,KV,hd), standard normal float32."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)])


def scan_inputs(B, L, H, P, G, N, seed=0):
    """x (B,L,H,P), dt = softplus(normal) (B,L,H), A = -exp(normal) (H,),
    B and C (B,L,G,N), float32: the distributions of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


#: rwkv6_wkv cases ``(B, L, H, N, chunk)``: the shapes of
#: tests/test_kernels.py, then a prime L (97: no chunk divides it) at the
#: kernel's chunk of 32 and at 64.
WKV_SHAPES = [
    (2, 96, 3, 8, 32),
    (1, 64, 2, 16, 16),
    (1, 128, 4, 32, 32),
    (1, 97, 3, 16, 32),
    (1, 97, 2, 64, 64),
]


def wkv_inputs(B, L, H, N, seed=0, strong=False, path=False):
    """r, k, v (B,L,H,N) and u (H,N) standard normal, w (B,L,H,N) =
    0.45 + 0.5 sigmoid(normal) as in tests/test_kernels.py; with ``strong``
    uniform in [1e-4, 0.1] (a decay whose cumulative log over a chunk of 32
    reaches -295: exp(-lcum) would overflow float32); with ``path``
    exp(-exp(-4 + 0.5 normal)), about 0.98 as rwkv6-3b's initial
    ``w0 = -4`` gives (a long memory); float32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, L, H, N)).astype(np.float32)
               for _ in range(3))
    shape = (B, L, H, N)
    if strong:
        w = rng.uniform(1e-4, 0.1, shape)
    elif path:
        w = np.exp(-np.exp(-4 + 0.5 * rng.standard_normal(shape)))
    else:
        w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal(shape)))
    u = rng.standard_normal((H, N)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u
