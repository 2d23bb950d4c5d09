"""Helpers for holding the port's results equal to the reference package's.

Imports neither JAX nor the reference package, so that the tests that run
only on a card can use it where JAX is not installed.

``plain`` turns a result of either package into plain Python values, so
that the two compare with ``==`` although their classes differ: dataclasses
become ``(class name, {field: value})``, enums their value, numpy arrays
``(dtype, shape, bytes)``. Other objects (a service, a fabric) reduce to
their class name, because they are compared through what they report.
"""
import contextlib
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


def _ragged(F, H, W, dtype):
    frames = np.random.default_rng(H * W).integers(0, 400, (F, H, W))
    return frames.astype(dtype), np.full((H, W), 8.0, np.float32), 150.0, None


#: hedm_reduce's ragged shapes ``(F, H, W, frame type)``: widths 1, 3, 131
#: and 1027, heights 1, 5 and 67, and uint16 with an odd width; the same as
#: chip_smoke.py's RAGGED_HEDM
RAGGED_HEDM = [(2, 1, 7, "float32"), (2, 5, 1, "float32"),
               (1, 1, 1, "float32"), (2, 67, 131, "float32"),
               (1, 5, 1027, "float32"), (2, 5, 3, "float32"),
               (2, 67, 131, "uint16"), (1, 5, 1027, "uint16")]

#: hedm_reduce inputs: the cases of tests/test_kernels.py (spot, row-tiled
#: shapes, the noisy-border sweep, pure noise), uint16 frames and the ragged
#: shapes, as ``name -> () -> (frames, dark, threshold, Pallas tile_rows)``.
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
    **{f"ragged-{H}x{W}-{dt}": (lambda F=F, H=H, W=W, dt=dt:
                                _ragged(F, H, W, dt))
       for F, H, W, dt in RAGGED_HEDM},
}



#: hedm_label's masks: `label_mask`'s kinds. The patterns vary their phase
#: from frame to frame, so frames of one stack differ.
LABEL_MASKS = ("empty", "full", "checkerboard", "hstripes", "vstripes",
               "spiral", "rings", "edges", "random-0.001", "random-0.05",
               "random-0.5")


def _spiral(H, W):
    """A one-pixel path spiralling inward with one-pixel gaps: it crosses
    every 32-pixel tile border of the frame many times."""
    m = np.zeros((H, W), np.uint8)
    for t in range(0, min(H, W), 2):
        top, bottom, left, right = t, H - 1 - t, t, W - 1 - t
        if top > bottom or left > right:
            break
        m[top, max(left - 2, 0):right + 1] = 1
        m[top:bottom + 1, right] = 1
        m[bottom, left:right + 1] = 1
        m[min(top + 2, bottom):bottom + 1, left] = 1
    return m


def _edges(H, W, rng):
    """The frame's border cut at the middle of each side (four components,
    each on two edges and a corner) and sparse pixels inside."""
    m = (rng.random((H, W)) < 0.02).astype(np.uint8)
    m[[0, -1], :] = 1
    m[:, [0, -1]] = 1
    m[[0, -1], W // 2] = 0
    m[H // 2, [0, -1]] = 0
    return m


def label_mask(kind, F, H, W, seed=0):
    """(F, H, W) uint8 mask of ``kind`` (one of :data:`LABEL_MASKS`)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    frames = []
    for f in range(F):
        if kind.startswith("random-"):
            m = rng.random((H, W)) < float(kind.split("-")[1])
        elif kind == "empty":
            m = np.zeros((H, W))
        elif kind == "full":
            m = np.ones((H, W))
        elif kind == "checkerboard":
            m = (yy + xx + f) % 2 == 0
        elif kind == "hstripes":
            m = (yy + f) % 2 == 0
        elif kind == "vstripes":
            m = (xx + f) % 2 == 0
        elif kind == "spiral":
            m = np.roll(_spiral(H, W), f, axis=1)
        elif kind == "rings":          # like powder rings: thin, wide boxes
            r = np.hypot(yy - H / 2, xx - W / 2 + f)
            m = np.zeros((H, W), bool)
            for radius in (min(H, W) / 5, min(H, W) / 3, max(H, W) / 2):
                m |= np.abs(r - radius) < 1.5
        elif kind == "edges":
            m = _edges(H, W, rng)
        else:
            raise ValueError(kind)
        frames.append(np.asarray(m, np.uint8))
    return np.stack(frames) if frames else np.zeros((0, H, W), np.uint8)


def label_frames(shape, dtype, seed=0):
    """Weights for hedm_label: an integer type over its whole range, or a
    float type positive over ~10 decades (~7 in float16), where the order
    of a float64 sum shows."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape,
                            endpoint=True).astype(dtype)
    span = 8.0 if dtype.itemsize < 4 else 12.0
    return np.exp(rng.uniform(-span, span, shape)).astype(dtype)

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


def scan_float64(x, dt, A, Bm, Cm):
    """The oracle's step-by-step recurrence (``mamba2_scan_ref.reference``)
    in float64 with torch, on the inputs' device: h_t = exp(dt_t A) h_{t-1}
    + dt_t x_t B_t^T, y_t = h_t C_t. Returns (y, h_final), float64."""
    import torch
    B, L, H, P = x.shape
    G = Bm.shape[2]
    x, dt, A = x.double(), dt.double(), A.double()
    Bh = Bm.double().repeat_interleave(H // G, dim=2)
    Ch = Cm.double().repeat_interleave(H // G, dim=2)
    h = torch.zeros(B, H, P, Bm.shape[3], dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(L):
        h = (h * torch.exp(dt[:, t] * A)[..., None, None]
             + dt[:, t, :, None, None] * x[:, t, :, :, None]
             * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1), h


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


# ---------------------------------------------------------------------------
# The tensor-core kernels' rounding, emulated with torch on the CPU. The
# bf16 inputs enter the tensor cores as they are; every float32 operand
# enters as a bf16 pair hi + lo (``split=True``, the kernels' design) or as
# one bf16 value (``split=False``, what the design rules out); products are
# exact in fp32 and summed in fp32; the output is bf16.

def bf16_operand(t, split=True):
    """A float32 tensor as the tensor cores see it: hi + lo with hi =
    bf16(t), lo = bf16(t - hi) (``split``), or bf16(t)."""
    import torch
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float() if split else hi


def flash_tc_emulation(q, k, v, causal=True, window=0, split=True,
                       block_k=64):
    """``flash_fwd_tc``'s arithmetic: scores in fp32, an online softmax in
    base 2 over key tiles of ``block_k`` (masked entries -1e30 and exactly
    0, the sum from the fp32 probabilities, clamped at 1e-30), P as a bf16
    operand, O summed in fp32, divided by the sum and rounded to bf16. q
    (B,S,H,hd), k/v (B,S,KV,hd) bf16 -> (B,S,H,hd) bf16."""
    import math
    import torch
    B, S, H, hd = q.shape
    KV = k.shape[2]
    c = hd ** -0.5 * math.log2(math.e)
    qf = q.float().reshape(B, S, KV, H // KV, hd)
    kf, vf = k.float(), v.float()
    pos = torch.arange(S)
    m = torch.full((B, KV, H // KV, S, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros(B, KV, H // KV, S, hd)
    for k0 in range(0, S, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        keys = pos[k0:k0 + block_k]
        ok = torch.ones(S, len(keys), dtype=torch.bool)
        if causal:
            ok &= keys[None] <= pos[:, None]
        if window > 0:
            ok &= keys[None] > pos[:, None] - window
        s = torch.einsum("bskgh,btkh->bkgst", qf, kt) * c
        s = s.masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).masked_fill(~ok, 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bkgst,btkh->bkgsh",
                                     bf16_operand(p, split), vt)
        m = m_new
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(torch.bfloat16)


def scan_tc_emulation(x, dt, A, Bm, Cm, chunk=128, split=True):
    """``ssd_scan_tc``'s arithmetic, chunk by chunk: C B^T from the bf16
    inputs; M = (C B^T) exp(seg) dt, the state h and w B (w = dt times the
    decay to the chunk's end) as bf16 operands; the state carried in fp32;
    y rounded to bf16. x, B, C bf16, dt and A float32 -> (y bf16, h
    float32)."""
    import torch
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xf = x.float()
    Bh = Bm.float().repeat_interleave(H // G, dim=2)
    Ch = Cm.float().repeat_interleave(H // G, dim=2)
    h = torch.zeros(B, H, P, N)
    ys = []
    for c0 in range(0, L, chunk):
        xc, dtc = xf[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bc, Cc = Bh[:, c0:c0 + chunk], Ch[:, c0:c0 + chunk]
        Q = xc.shape[1]
        a = dtc * A
        later = torch.tril(torch.ones(Q, Q, dtype=torch.bool), -1)
        seg = torch.cumsum(a[:, :, None].expand(-1, -1, Q, -1)
                           .masked_fill(~later[None, :, :, None], 0.0), 1)
        keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, :, :,
                                                              None]
        M = (torch.einsum("bqhn,bkhn->bqkh", Cc, Bc)
             * torch.exp(seg.masked_fill(~keep, float("-inf")))
             * dtc[:, None])
        y = torch.einsum("bqhn,bhpn->bqhp", Cc, bf16_operand(h, split)) \
            * torch.exp(a[:, :1] + seg[:, :, 0])[..., None]
        y = y + torch.einsum("bqkh,bkhp->bqhp", bf16_operand(M, split), xc)
        w = torch.exp(seg[:, -1]) * dtc
        wB = bf16_operand(Bc * w[..., None], split)
        h = h * torch.exp(a[:, :1] + seg[:, -1, :1])[:, 0, :, None, None] \
            + torch.einsum("bqhn,bqhp->bhpn", wB, xc)
        ys.append(y)
    return torch.cat(ys, dim=1).to(torch.bfloat16), h


def wkv_tc_emulation(r, k, v, w, u, chunk=32, split=True):
    """``wkv6_tc``'s arithmetic, chunk by chunk: the state pass's U =
    (k exp(lcum_last - lcum))^T v with that float32 factor as a bf16
    operand and v as it is, the state carried in fp32; the output pass's
    scores in fp32 (exact exps, every exponent <= 0, as the plain version),
    then sc v and (r exp(lprev)) S with sc, r exp(lprev) and the state at
    the chunk's start as bf16 operands; the output rounded to bf16. r, k, v
    bf16, w and u float32 -> (out bf16, s float32)."""
    import torch
    B, L, H, N = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    lw_all = torch.log(torch.clamp(w.float(), min=1e-20))
    s = torch.zeros(B, H, N, N)
    outs = []
    for c0 in range(0, L, chunk):
        rc, kc, vc = (t[:, c0:c0 + chunk] for t in (rf, kf, vf))
        Q = rc.shape[1]
        lcum = torch.cumsum(lw_all[:, c0:c0 + chunk], dim=1)
        lprev = torch.cat([torch.zeros_like(lcum[:, :1]), lcum[:, :-1]], 1)
        before = torch.tril(torch.ones(Q, Q, dtype=torch.bool), -1)
        diff = (lprev[:, :, None] - lcum[:, None, :]).masked_fill(
            ~before[None, :, :, None, None], float("-inf"))
        sc = torch.einsum("bqhi,bqjhi,bjhi->bqjh", rc, torch.exp(diff), kc)
        sc = sc + torch.diag_embed(torch.einsum(
            "bqhi,hi,bqhi->bhq", rc, u, kc)).permute(0, 2, 3, 1)
        o = torch.einsum("bqjh,bjhn->bqhn", bf16_operand(sc, split), vc)
        o = o + torch.einsum("bqhi,bhin->bqhn",
                             bf16_operand(rc * torch.exp(lprev), split),
                             bf16_operand(s, split))
        kd = bf16_operand(kc * torch.exp(lcum[:, -1:] - lcum), split)
        s = s * torch.exp(lcum[:, -1])[..., None] \
            + torch.einsum("bqhi,bqhn->bhin", kd, vc)
        outs.append(o)
    return torch.cat(outs, dim=1).to(torch.bfloat16), s


def train_batch(cfg, B, S, seed=0):
    """A numpy training batch for ``cfg``: tokens and labels (one label
    -100), plus ``image_embeds`` (B, P, feat) for a vision config; for an
    audio config ``features`` (B, S, feat) and labels over its clusters.
    S counts the text tokens of a vision config (P image positions come
    before them)."""
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, S // 2] = -100
    if fe.kind == "audio_frames":
        return {"features": rng.standard_normal(
            (B, S, fe.feature_dim)).astype(np.float32), "labels": labels}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": labels}
    if fe.kind == "vision_patches":
        batch["image_embeds"] = rng.standard_normal(
            (B, fe.num_prefix_tokens, fe.feature_dim)).astype(np.float32)
    return batch


def tree_items(tree, prefix=()):
    """(path, leaf) of a nested dict of arrays, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def assert_trees_close(port, ref, rtol, normwise=False):
    """Every leaf of ``ref`` (nested dicts of arrays) within ``rtol`` of
    ``port``'s, as max |diff| over max |ref| (or with ``normwise`` as
    ||diff|| / ||ref||); a leaf that is exactly zero in ``ref`` must be
    exactly zero in ``port``. Both trees have the same paths."""
    got = dict(tree_items(port))
    want = dict(tree_items(ref))
    assert sorted(got) == sorted(want)
    size = np.linalg.norm if normwise else (lambda x: np.abs(x).max())
    for path, r in want.items():
        a = got[path]
        assert a.shape == r.shape, path
        if not r.any():
            assert not a.any(), f"{'/'.join(path)}: zero in the reference"
            continue
        r = r.astype(np.float64)
        err = float(size(a.astype(np.float64) - r) / size(r))
        assert err < rtol, f"{'/'.join(path)}: rel {err:.3g}"


@contextlib.contextmanager
def one_rank_mesh(tmp_path, shape=(1, 1), axes=("data", "model")):
    """A CPU ``DeviceMesh`` of ``shape`` (every size 1) over a gloo group of
    one rank, its rendezvous under ``tmp_path``; the group is destroyed on
    exit."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv1",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_mesh(shape, axes, "cpu")
    finally:
        dist.destroy_process_group()


def int8_pod_hop(per_pod, errs, leaf_of=lambda k: k):
    """The pod branch's int8 hop in one process, as the reference's
    ``pod_body`` computes it: each pod's ``g + e`` quantized once
    (``train.compression``'s arithmetic) with the scale of its whole leaf,
    its new error ``g + e - q * scale``, and the mean over the pods of
    scale times payload, summed in pod order.
    ``per_pod`` and ``errs``: a dict of float32 tensors for each pod, keyed
    alike; ``leaf_of(key)`` names the leaf a key is part of (the port's
    per-layer parameters of one of the reference's stacked leaves).
    Returns (the reduced dict, the new errors of each pod)."""
    import torch
    from repro_torch.train import compression as C
    n = len(per_pod)
    tgts = [{k: g[k].to(torch.float32) + e[k] for k in g}
            for g, e in zip(per_pod, errs)]
    amax = [{} for _ in range(n)]
    for i in range(n):
        for k, t in tgts[i].items():
            m = t.abs().amax()
            old = amax[i].get(leaf_of(k))
            amax[i][leaf_of(k)] = m if old is None else torch.maximum(old, m)
    red, new_errs = {}, [{} for _ in per_pod]
    for k in per_pod[0]:
        qs = []
        for i in range(n):
            scale = amax[i][leaf_of(k)] / 127.0 + 1e-12
            q = torch.clamp(torch.round(tgts[i][k] / scale), -127,
                            127).to(torch.int8)
            new_errs[i][k] = tgts[i][k] - C.dequantize_int8(q, scale)
            qs.append((q, scale))
        acc = qs[0][1] * qs[0][0].to(torch.float32)
        for q, scale in qs[1:]:
            acc = acc + scale * q.to(torch.float32)
        red[k] = acc / n
    return red, new_errs
