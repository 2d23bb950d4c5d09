"""The port on the card: the CUDA kernels against their plain versions, and
the pipeline's stages and the serving path on the card against the CPU.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode) and skips without one. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the reference package; the plain versions
it holds the kernels to are themselves held to the reference on the CPU
(``tests/test_torch_hedm_reduce.py``, ``test_torch_flash_attention.py``,
``test_torch_mamba2_scan.py``, ``test_torch_rwkv6_wkv.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.hedm import pipeline as T
from repro_torch.hedm import service, streaming
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hedm_reduce as port
from repro_torch.kernels import mamba2_scan as ms
from repro_torch.kernels import rwkv6_wkv as wk
from repro_torch.kernels.ops import (flash_attention, hedm_reduce,
                                     mamba2_scan, rwkv6_wkv)
from repro_torch.models import model as M
from repro_torch.models import rwkv6 as rw
from repro_torch.serve.engine import Request, ServeSession, prefill_step
from torch_parity import HEDM_REDUCE_CASES as CASES
from torch_parity import (FLASH_SHAPES, SCAN_SHAPES, WKV_SHAPES,
                          flash_inputs, scan_float64, scan_inputs,
                          wkv_inputs)

pytestmark = pytest.mark.cuda

#: zamba2-7b's prefill widths at prompt lengths of its serving path, none a
#: multiple of the 64-row attention tile or the 128-step scan chunk. The
#: scan's outputs reach a few hundred at these widths, where float32 summed
#: in another order differs from the plain version by more than an absolute
#: 2e-4; there float32 is held within 2e-4 + 1e-5 max |ref|. The error of a
#: reordered float32 sum scales with its terms, not with the value they sum
#: to: an element bound of 2e-4 + 1e-5 |ref| failed on the card at 1.19e-3
#: on an output of 39 where the largest was 260.
PATH_FLASH_SHAPES = [(1, S, 32, 32, 112, True, 0) for S in (285, 1781)]
PATH_SCAN_SHAPES = [(1, L, 112, 64, 1, 64, 128) for L in (285, 1781)]
BOTH = ("float32", "bfloat16")
SCAN_CASES = [(s, d) for s in SCAN_SHAPES + PATH_SCAN_SHAPES for d in BOTH]
#: rwkv6_wkv: the test shapes (two with a prime L) with the test decay and a
#: strong one, and rwkv6-3b's prefill widths (40 heads of 64, chunk 32) at
#: two prompt lengths of its serving path with a decay like its own, ~0.98.
PATH_WKV_SHAPES = [(1, L, 40, 64, 32) for L in (285, 1781)]
WKV_CASES = ([(s, d, "test") for s in WKV_SHAPES for d in BOTH]
             + [(s, d, "strong") for s in WKV_SHAPES for d in BOTH]
             + [(s, d, "path") for s in PATH_WKV_SHAPES for d in BOTH])


def assert_close(out, ref, atol, rtol):
    """|out - ref| <= atol + rtol |ref| everywhere; the message names the
    worst element against its bound and the largest |ref|."""
    diff = (out.float() - ref).abs()
    excess = diff - (atol + rtol * ref.abs())
    worst = int(excess.argmax())
    assert float(excess.max()) <= 0, (
        f"max |diff| {float(diff.max()):.3g}; worst element: |diff| "
        f"{float(diff.flatten()[worst]):.3g} at |ref| "
        f"{float(ref.flatten()[worst].abs()):.3g} (bound atol {atol} + rtol "
        f"{rtol}); max |ref| {float(ref.abs().max()):.3g}")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(card, case):
    frames, dark, thr, _ = CASES[case]()
    f, d = torch.from_numpy(frames).to(card), torch.from_numpy(dark).to(card)
    before = port.hedm_reduce.launches
    m, c = hedm_reduce(f, d, thr)
    torch.cuda.synchronize()
    assert port.hedm_reduce.launches == before + 1
    m_ref, c_ref = port.reference(f, d, thr)
    assert m.dtype == torch.uint8 and c.dtype == torch.int32
    assert torch.equal(m, m_ref) and torch.equal(c, c_ref)
    cpu_m, cpu_c = port.reference(torch.from_numpy(frames),
                                  torch.from_numpy(dark), thr)
    assert torch.equal(m.cpu(), cpu_m) and torch.equal(c.cpu(), cpu_c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint16], ids=str)
@pytest.mark.parametrize("offset", ["frames", "dark"])
def test_kernel_on_views_off_a_16_byte_boundary(card, dtype, offset):
    # contiguous views one element into their storage, at a width the
    # kernel otherwise reads with 16-byte loads: they take its scalar path
    F, H, W = 2, 40, 1024
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 400, (F, H, W)).astype(np.float32)
    dark = rng.integers(0, 40, (H, W)).astype(np.float32)
    f = torch.from_numpy(frames).to(card, dtype)
    d = torch.from_numpy(dark).to(card)
    if offset == "frames":
        f = torch.cat([f.new_zeros(1), f.flatten()])[1:].view(F, H, W)
    else:
        d = torch.cat([d.new_zeros(1), d.flatten()])[1:].view(H, W)
    assert f.is_contiguous() and d.is_contiguous()
    assert (f.data_ptr() | d.data_ptr()) % 16 != 0
    m, c = hedm_reduce(f, d, 150.0)
    torch.cuda.synchronize()
    m_ref, c_ref = port.reference(f, d, 150.0)
    assert int(c_ref.sum()) > 0
    assert torch.equal(m, m_ref) and torch.equal(c, c_ref)


def test_kernel_rejects_non_contiguous_input(card):
    f = torch.zeros(2, 16, 32, device=card)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        hedm_reduce(f, torch.zeros(16, 16, device=card), 100.0)


def test_stage1_on_card_equals_cpu(card):
    frames, dark = T.simulate_detector_frames(4, size=192, n_spots=8, seed=6)
    on_card = T.reduce_frames(frames, dark, device=card)
    on_cpu = T.reduce_frames(frames, dark, device="cpu")
    assert sum(r.n_spots for r in on_card) >= 4
    assert T.pack_reduced(on_card).tobytes() == \
        T.pack_reduced(on_cpu).tobytes()


def test_stage2_on_card_matches_cpu(card):
    gvec = T.make_gvectors()
    truth, obs = T.synth_grid_observations(256, gvec, device="cpu")
    theta0 = np.zeros((256, 3), np.float32)
    fit_card = T.fit_grid(obs, gvec, theta0, device=card).cpu().numpy()
    fit_cpu = T.fit_grid(obs, gvec, theta0, device="cpu").numpy()
    rec = np.abs(fit_cpu - truth).max(axis=1) < 0.05
    # float32 on both; the card sums in another order
    np.testing.assert_allclose(fit_card[rec], fit_cpu[rec], rtol=0,
                               atol=1e-4)
    assert (np.abs(fit_card - truth).max(axis=1) < 0.05).mean() > 0.7


def test_device_generator_is_seeded(card):
    a, da = T.simulate_detector_frames(3, size=128, seed=5, device=card)
    b, db = T.simulate_detector_frames(3, size=128, seed=5, device=card)
    assert np.array_equal(a, b) and np.array_equal(da, db)
    assert a.dtype == np.float32 and a.shape == (3, 128, 128)
    assert all(f.max() > 500 for f in a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,win",
                         FLASH_SHAPES + PATH_FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain_version(card, B, S, H, KV, hd,
                                                      causal, win, dtype):
    """float32 within 3e-5; bfloat16 against the plain version run in
    float32 on the same bf16 inputs, within 1e-3 plus one bf16 rounding
    step (2^-7) of each output value."""
    q, k, v = (torch.from_numpy(a).to(card).to(getattr(torch, dtype))
               for a in flash_inputs(B, S, H, KV, hd, seed=S + hd))
    before = fa.flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.reference(q.float(), k.float(), v.float(), causal=causal,
                       window=win)
    assert out.dtype == q.dtype
    atol, rtol = (3e-5, 0.0) if dtype == "float32" else (1e-3, 2.0 ** -7)
    assert bool(((out.float() - ref).abs() <= atol + rtol * ref.abs()).all())


@pytest.mark.parametrize("shape,dtype", SCAN_CASES, ids=str)
def test_mamba2_scan_kernel_matches_plain_version(card, shape, dtype):
    """float32 within 2e-4 at the test shapes and 2e-4 + 1e-5 max |ref| at
    the path's widths (y and h); bf16 x/B/C against the plain version run
    in float32 on the same inputs, within 2e-2 plus one bf16 rounding step
    (2^-7) of each output value, whose magnitude reaches ~100."""
    B, L, H, P, G, N, chunk = shape
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(card)
                        for a in scan_inputs(B, L, H, P, G, N, seed=L + P))
    low = getattr(torch, dtype)
    x, Bm, Cm = x.to(low), Bm.to(low), Cm.to(low)
    before = ms.mamba2_scan.launches
    y, h = mamba2_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ms.mamba2_scan.launches == before + 1
    y_ref, h_ref = ms.reference(x.float(), dt, A, Bm.float(), Cm.float(),
                                chunk=chunk)
    assert y.dtype == low and h.dtype == torch.float32
    if dtype == "bfloat16":
        assert_close(y, y_ref, 2e-2, 2.0 ** -7)
        assert_close(h, h_ref, 2e-2, 0.0)
    else:
        scale = 1e-5 if shape in PATH_SCAN_SHAPES else 0.0
        assert_close(y, y_ref, 2e-4 + scale * float(y_ref.abs().max()), 0.0)
        assert_close(h, h_ref, 2e-4 + scale * float(h_ref.abs().max()), 0.0)


#: the tensor-core kernels' tile edges at the path's widths, bf16: the
#: attention tile of 128 query rows (64 a warpgroup, 64 keys a K/V tile)
#: and the scan chunk of 128
EDGE_FLASH_SHAPES = [(1, S, 32, 32, 112, True, 0) for S in (127, 128, 129,
                                                           255)]
EDGE_SCAN_SHAPES = [(1, L, 112, 64, 1, 64, 128) for L in (127, 129)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,win", EDGE_FLASH_SHAPES)
def test_flash_attention_tile_edges_bf16(card, B, S, H, KV, hd, causal,
                                         win):
    """bf16 on the tensor-core kernel against the plain version run in
    float32 on the same inputs, within 1e-3 + 2^-7 |ref|."""
    q, k, v = (torch.from_numpy(a).to(card).to(torch.bfloat16)
               for a in flash_inputs(B, S, H, KV, hd, seed=S + hd))
    before = fa.flash_attention.launches_tc
    out = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_tc == before + 1
    ref = fa.reference(q.float(), k.float(), v.float(), causal=causal,
                       window=win)
    assert_close(out, ref, 1e-3, 2.0 ** -7)


#: qwen3-moe-30b-a3b's prefill widths (32 query heads, 4 kv heads of 128:
#: no zero-padded columns, 8 query heads a kv head) at the eight prompt
#: lengths of its serving path and at the 128-row tile's edges
QWEN_FLASH_SHAPES = [(1, S, 32, 4, 128, True, 0)
                     for S in (1781, 1398, 1172, 739, 807, 329, 390, 285,
                               127, 128, 129)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,win", QWEN_FLASH_SHAPES)
def test_flash_attention_qwen3_moe_shape_bf16(card, B, S, H, KV, hd, causal,
                                              win):
    """bf16 at hd 128 and 8 query heads a kv head on the tensor-core
    kernel, within 1e-3 + 2^-7 |ref| of the plain version in float32."""
    q, k, v = (torch.from_numpy(a).to(card).to(torch.bfloat16)
               for a in flash_inputs(B, S, H, KV, hd, seed=S + KV))
    before = fa.flash_attention.launches_tc
    out = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_tc == before + 1
    ref = fa.reference(q.float(), k.float(), v.float(), causal=causal,
                       window=win)
    assert_close(out, ref, 1e-3, 2.0 ** -7)


#: deepseek-v2-lite's MLA prefill widths (16 query heads, 16 kv heads, q
#: and k 192 wide, v zero-padded from 128 as the model pads it) at the eight
#: prompt lengths of its serving path, 2048 and the 128-row tile's edges
DEEPSEEK_FLASH_SHAPES = [(1, S, 16, 16, 192, True, 0)
                         for S in (1781, 1398, 1172, 739, 807, 329, 390, 285,
                                   2048, 127, 128, 129)]


def _mla_inputs(card, dtype, S):
    q, k, v = (torch.from_numpy(a).to(card).to(dtype)
               for a in flash_inputs(1, S, 16, 16, 192, seed=S + 192))
    v[..., 128:] = 0
    return q, k, v


@pytest.mark.parametrize("B,S,H,KV,hd,causal,win", DEEPSEEK_FLASH_SHAPES)
def test_flash_attention_deepseek_shape_bf16(card, B, S, H, KV, hd, causal,
                                             win):
    """bf16 at hd 192 on the tensor-core kernel, within 1e-3 + 2^-7 |ref|
    of the plain version in float32; the padded columns stay 0."""
    q, k, v = _mla_inputs(card, torch.bfloat16, S)
    before = fa.flash_attention.launches_tc
    out = flash_attention(q, k, v, causal=causal, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_tc == before + 1
    ref = fa.reference(q.float(), k.float(), v.float(), causal=causal,
                       scale=192 ** -0.5)
    assert_close(out, ref, 1e-3, 2.0 ** -7)
    assert not out[..., 128:].any()


@pytest.mark.parametrize("S", [127, 129, 1024])
def test_flash_attention_deepseek_shape_float32(card, S):
    """float32 at hd 192 on the CUDA-core kernel, within 3e-5."""
    q, k, v = _mla_inputs(card, torch.float32, S)
    n, n_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    out = flash_attention(q, k, v, causal=True, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.launches_tc) == \
        (n + 1, n_tc)
    ref = fa.reference(q, k, v, causal=True, scale=192 ** -0.5)
    assert_close(out, ref, 3e-5, 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [200, 256])
def test_flash_attention_rejects_head_dims_past_192(card, dtype, hd):
    """No kernel takes hd > 192, and nothing falls back: the wrapper
    raises and launches nothing."""
    q, k, v = (torch.from_numpy(a).to(card).to(getattr(torch, dtype))
               for a in flash_inputs(1, 16, 2, 2, hd))
    n = fa.flash_attention.launches
    with pytest.raises(ValueError, match="hd <= 192"):
        flash_attention(q, k, v)
    assert fa.flash_attention.launches == n


@pytest.mark.parametrize("shape", EDGE_SCAN_SHAPES, ids=str)
def test_mamba2_scan_tile_edges_bf16(card, shape):
    """bf16 on the tensor-core kernel against the plain version run in
    float32 on the same inputs: y within 2e-2 + 2^-7 |ref|, h within
    2e-2."""
    B, L, H, P, G, N, chunk = shape
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(card)
                        for a in scan_inputs(B, L, H, P, G, N, seed=L + P))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    before = ms.mamba2_scan.launches_tc
    y, h = mamba2_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ms.mamba2_scan.launches_tc == before + 1
    y_ref, h_ref = ms.reference(x.float(), dt, A, Bm.float(), Cm.float(),
                                chunk=chunk)
    assert_close(y, y_ref, 2e-2, 2.0 ** -7)
    assert_close(h, h_ref, 2e-2, 0.0)


@pytest.mark.parametrize("shape", PATH_SCAN_SHAPES, ids=str)
def test_mamba2_scan_float32_matches_float64_recurrence(card, shape):
    """Which side errs: the float32 kernel and the float32 plain version,
    each against the recurrence in float64 on the card, within half the
    card bound of the two against each other, (2e-4 + 1e-5 max |ref|) / 2,
    for y and for h. Both within it keeps the kernel within the full bound
    of its plain version."""
    B, L, H, P, G, N, chunk = shape
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(card)
                        for a in scan_inputs(B, L, H, P, G, N, seed=L + P))
    y64, h64 = scan_float64(x, dt, A, Bm, Cm)
    got = {"kernel": mamba2_scan(x, dt, A, Bm, Cm, chunk=chunk),
           "plain version": ms.reference(x, dt, A, Bm, Cm, chunk=chunk)}
    torch.cuda.synchronize()
    for name, (y, h) in got.items():
        for out, ref in ((y, y64), (h, h64)):
            bound = (2e-4 + 1e-5 * float(ref.abs().max())) / 2
            err = float((out.double() - ref).abs().max())
            assert err <= bound, f"{name}: max |diff| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("dtype,hd,tc", [
    ("bfloat16", 112, True), ("bfloat16", 120, True), ("bfloat16", 64, True),
    ("bfloat16", 192, True), ("bfloat16", 100, False),
    ("float32", 112, False), ("float32", 192, False),
    ("bfloat16", 200, False)])
def test_flash_attention_dispatch(card, dtype, hd, tc):
    """bf16 with hd % 8 == 0 and hd <= 192 goes to the tensor-core kernel;
    float32 and any other hd up to 192 to the CUDA-core one. Both count in
    ``launches``, the first also in ``launches_tc``. Past 192 neither
    kernel runs: the wrapper raises."""
    q, k, v = (torch.from_numpy(a).to(card).to(getattr(torch, dtype))
               for a in flash_inputs(1, 96, 4, 2, hd, seed=hd))
    n, n_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    assert fa.on_tensor_cores(q, k, v) == tc
    if hd > fa.MAX_HEAD_DIM:
        with pytest.raises(ValueError, match="hd <= 192"):
            flash_attention(q, k, v)
        assert fa.flash_attention.launches == n
        return
    flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    assert fa.flash_attention.launches_tc == n_tc + tc


@pytest.mark.parametrize("dtype,P,N,tc", [
    ("bfloat16", 64, 64, True), ("bfloat16", 16, 8, True),
    ("bfloat16", 12, 8, False), ("float32", 64, 64, False)])
def test_mamba2_scan_dispatch(card, dtype, P, N, tc):
    """bf16 with P % 8 == 0 and N % 8 == 0 goes to the tensor-core kernel;
    float32 and any other P or N to the CUDA-core one."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(card)
                        for a in scan_inputs(1, 100, 4, P, 2, N, seed=P))
    low = getattr(torch, dtype)
    x, Bm, Cm = x.to(low), Bm.to(low), Cm.to(low)
    n, n_tc = ms.mamba2_scan.launches, ms.mamba2_scan.launches_tc
    assert ms.on_tensor_cores(x, Bm, Cm) == tc
    mamba2_scan(x, dt, A, Bm, Cm, chunk=32)
    torch.cuda.synchronize()
    assert ms.mamba2_scan.launches == n + 1
    assert ms.mamba2_scan.launches_tc == n_tc + tc


@pytest.mark.parametrize("shape,dtype,decay", WKV_CASES, ids=str)
def test_rwkv6_wkv_kernel_matches_plain_version(card, shape, dtype, decay):
    """The output: float32 within 2e-4 at the test shapes and 2e-4 + 1e-5
    |ref| at the path's widths; bf16 r/k/v against the plain version run in
    float32 on the same inputs, within 1e-3 plus one bf16 rounding step
    (2^-7) of each value. The float32 state within 2e-4 + 1e-5 |ref|."""
    B, L, H, N, chunk = shape
    r, k, v, w, u = (torch.from_numpy(a).to(card) for a in wkv_inputs(
        B, L, H, N, seed=L + N, strong=decay == "strong",
        path=decay == "path"))
    low = getattr(torch, dtype)
    r, k, v = r.to(low), k.to(low), v.to(low)
    before = wk.rwkv6_wkv.launches
    out, s = rwkv6_wkv(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wk.rwkv6_wkv.launches == before + 1
    o_ref, s_ref = wk.reference(r.float(), k.float(), v.float(), w, u,
                                chunk=chunk)
    assert out.dtype == low and s.dtype == torch.float32
    if dtype == "bfloat16":
        atol, rtol = 1e-3, 2.0 ** -7
    else:
        atol, rtol = 2e-4, (1e-5 if decay == "path" else 0.0)
    assert bool(torch.isfinite(out).all() and torch.isfinite(s).all())
    assert_close(out, o_ref, atol, rtol)
    assert_close(s, s_ref, 2e-4, 1e-5)


@pytest.mark.parametrize("dtype,N,tc", [
    ("bfloat16", 64, True), ("bfloat16", 16, True), ("bfloat16", 8, False),
    ("float32", 64, False)])
def test_rwkv6_wkv_dispatch(card, dtype, N, tc):
    """bf16 with N a multiple of 16 goes to the tensor-core kernel
    (``wkv6_tc``); float32 and N = 8 to the CUDA-core one (``wkv6``). Both
    count in ``launches``, the first also in ``launches_tc``."""
    r, k, v, w, u = (torch.from_numpy(a).to(card)
                     for a in wkv_inputs(1, 70, 3, N, seed=N))
    low = getattr(torch, dtype)
    r, k, v = r.to(low), k.to(low), v.to(low)
    n, n_tc = wk.rwkv6_wkv.launches, wk.rwkv6_wkv.launches_tc
    assert wk.on_tensor_cores(r, k, v, w) == tc
    rwkv6_wkv(r, k, v, w, u, chunk=32)
    torch.cuda.synchronize()
    assert wk.rwkv6_wkv.launches == n + 1
    assert wk.rwkv6_wkv.launches_tc == n_tc + tc


#: the tensor-core kernel's chunk edges: 16-row tiles, chunks of 16, 32 and
#: 64, sequences shorter than, equal to and one past a tile or a chunk
EDGE_WKV = [(L, chunk) for L in (1, 15, 16, 17, 33, 97)
            for chunk in (16, 32, 64)]


@pytest.mark.parametrize("L,chunk", EDGE_WKV, ids=str)
def test_rwkv6_wkv_tile_edges_bf16(card, L, chunk):
    """bf16 on the tensor-core kernel at N = 64 against the plain version
    run in float32 on the same inputs: out within 1e-3 + 2^-7 |ref|, the
    state within 2e-4 + 1e-5 |ref|."""
    r, k, v, w, u = (torch.from_numpy(a).to(card)
                     for a in wkv_inputs(1, L, 4, 64, seed=L + chunk))
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    before = wk.rwkv6_wkv.launches_tc
    out, s = rwkv6_wkv(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wk.rwkv6_wkv.launches_tc == before + 1
    o_ref, s_ref = wk.reference(r.float(), k.float(), v.float(), w, u,
                                chunk=chunk)
    assert_close(out, o_ref, 1e-3, 2.0 ** -7)
    assert_close(s, s_ref, 2e-4, 1e-5)


def test_rwkv6_wkv_batch_of_two(card):
    """Two batch rows of three heads with a ragged last chunk, bf16 on the
    tensor-core kernel: within the card bounds of the plain version, and
    each batch row equal bit for bit to that row run alone, so the scratch
    offsets by (batch row, head, chunk) address no other row's state."""
    r, k, v, w, u = (torch.from_numpy(a).to(card)
                     for a in wkv_inputs(2, 200, 3, 32, seed=11, path=True))
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    out, s = rwkv6_wkv(r, k, v, w, u, chunk=32)
    o_ref, s_ref = wk.reference(r.float(), k.float(), v.float(), w, u,
                                chunk=32)
    assert_close(out, o_ref, 1e-3, 2.0 ** -7)
    assert_close(s, s_ref, 2e-4, 1e-5)
    for b in range(2):
        o_b, s_b = rwkv6_wkv(*(t[b:b + 1].contiguous()
                               for t in (r, k, v, w)), u, chunk=32)
        assert torch.equal(o_b[0], out[b]) and torch.equal(s_b[0], s[b])


def test_chunked_wkv_from_a_state_raises_on_the_card(card):
    """No kernel takes an initial state: on the card the chunked form with
    ``s0`` raises instead of running the plain version."""
    cfg = get_smoke_config("rwkv6_3b")
    mixer = rw.RWKV6(cfg, torch.Generator(device=card).manual_seed(0), card)
    x = torch.zeros(1, 8, cfg.d_model, device=card)
    s0 = rw.init_rwkv_state(cfg, 1, card).s
    with pytest.raises(NotImplementedError, match="zero state"):
        rw.rwkv6_time_mix(mixer, cfg, x, x[:, 0], s0=s0, use_chunked=True)


def test_lm_kernels_reject_non_contiguous_input(card):
    q = torch.zeros(1, 8, 4, 64, device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 8, 4, 32, device=card)[..., ::2]
    dt = torch.zeros(1, 8, 4, device=card)
    bc = torch.zeros(1, 8, 1, 8, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        mamba2_scan(x, dt, torch.zeros(4, device=card), bc, bc)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_wkv(x, x, x, x, torch.zeros(4, 16, device=card))


#: the kernel each smoke config's prefill launches
ARCH_KERNEL = {"zamba2_7b": fa.flash_attention, "h2o_danube3_4b":
               fa.flash_attention, "rwkv6_3b": wk.rwkv6_wkv,
               "qwen3_moe_30b_a3b": fa.flash_attention,
               "deepseek_v2_lite_16b": fa.flash_attention}


@pytest.mark.parametrize("arch", sorted(ARCH_KERNEL))
def test_prefill_and_decode_on_card_match_cpu(card, arch):
    """The same seed-made smoke weights on both devices, float32: logits
    within 1e-4 relative, and the path launched its kernel."""
    cfg = get_smoke_config(arch)
    cpu = M.init_model(torch.Generator().manual_seed(0), cfg)
    on_card = M.Model(cfg, None, card)
    on_card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40)))
    out = {}
    counter = ARCH_KERNEL[arch]
    before = counter.launches
    for name, params in [("cpu", cpu), ("card", on_card)]:
        t = toks.to(params.embed.table.device)
        logits, caches = prefill_step(params, cfg, {"tokens": t[:, :39]},
                                      capacity=48)
        dec, _ = M.decode_step(params, cfg, t[:, 39:], caches)
        out[name] = (logits.cpu(), dec.cpu())
    assert counter.launches > before
    for a, b in zip(out["card"], out["cpu"]):
        v = cfg.vocab
        assert float((a[:, :v] - b[:, :v]).abs().max()
                     / b[:, :v].abs().max()) < 1e-4


def test_rwkv_session_on_card_matches_cpu(card):
    """rwkv6 smoke weights made on the CPU, served by a 2-slot session on
    both devices: greedy token ids identical."""
    _session_on_card_matches_cpu(card, "rwkv6_3b")


def test_qwen3_moe_session_on_card_matches_cpu(card):
    """The same for the qwen3-moe smoke config (its MoE FFN in every
    layer)."""
    _session_on_card_matches_cpu(card, "qwen3_moe_30b_a3b")


def test_deepseek_session_on_card_matches_cpu(card):
    """The same for the deepseek-v2-lite smoke config (MLA prefill through
    the flash-attention kernel, the absorbed decode over the latent
    caches)."""
    _session_on_card_matches_cpu(card, "deepseek_v2_lite_16b")


def _session_on_card_matches_cpu(card, arch):
    cfg = get_smoke_config(arch)
    cpu = M.init_model(torch.Generator().manual_seed(0), cfg)
    on_card = M.Model(cfg, None, card)
    on_card.load_state_dict(cpu.state_dict())
    served = {}
    for where, params in [("cpu", cpu), ("cuda", on_card)]:
        sess = ServeSession(params, cfg, batch_slots=2, capacity=32,
                            device=where)
        rng = np.random.default_rng(3)
        for i, n in enumerate((11, 5, 17, 8)):
            sess.submit(Request(i, rng.integers(0, cfg.vocab, n,
                                                dtype=np.int32), 6))
        served[where] = {r.request_id: r.generated
                         for r in sess.run_to_completion()}
        assert sess.nonfinite_logits == 0
    assert served["cuda"] == served["cpu"] and len(served["cpu"]) == 4


def test_streaming_driver_on_card(card):
    """The streamed driver on the card at 256x256: online equals batch (the
    driver raises otherwise), one ``hedm_reduce`` launch for the batch pass
    and one a window, and the output equals the plain version's on the CPU
    over the same seeded scan."""
    before = hedm_reduce.launches
    out = streaming.main(device=card, n_frames=16, frame_size=256,
                         verbose=False)
    assert hedm_reduce.launches == before + 1 + 16 // 8
    frames, dark = T.simulate_detector_frames(16, size=256, n_spots=8,
                                              seed=0, device=card)
    ref = T.pack_reduced(T.reduce_frames(frames, dark, device="cpu"))
    assert out["packed"].tobytes() == ref.tobytes()


def test_service_driver_on_card(card):
    """The multi-session driver on the card at 256x256, 4 frames a scan:
    every output equals direct reduction (the driver raises otherwise), 12
    session and 3 direct launches, and the outputs equal the plain
    version's on the CPU over the same seeded scans."""
    before = hedm_reduce.launches
    out = service.main(device=card, n_frames=4, frame_size=256,
                       verbose=False)
    assert hedm_reduce.launches == before + 4 * 3 + 3
    # the driver's dark frame is its last scan's
    scans = [T.simulate_detector_frames(4, size=256, n_spots=6, seed=i,
                                        device=card)
             for i in range(len(service.SCANS))]
    dark = scans[-1][1]
    for name, (frames, _) in zip(service.SCANS, scans):
        ref = T.pack_reduced(T.reduce_frames(frames, dark, device="cpu"))
        assert all(o[name].tobytes() == ref.tobytes()
                   for o in out["outputs"].values())


# ---------------------------------------------------------------------------
# training and the frontends on the card
# ---------------------------------------------------------------------------

def test_lm_kernels_refuse_inputs_that_require_grad(card):
    """K2, K3 and K4 have no backward: a CUDA input that requires grad in
    grad mode raises, and under ``no_grad`` the same call runs."""
    q = torch.randn(1, 8, 4, 64, device=card, requires_grad=True)
    x = torch.randn(1, 8, 4, 32, device=card, requires_grad=True)
    dt = torch.rand(1, 8, 4, device=card)
    A = -torch.rand(4, device=card)
    bc = torch.randn(1, 8, 1, 8, device=card)
    w = torch.rand(1, 8, 4, 32, device=card)
    u = torch.randn(4, 32, device=card)
    calls = [lambda: flash_attention(q, q.detach(), q.detach()),
             lambda: mamba2_scan(x, dt, A, bc, bc),
             lambda: rwkv6_wkv(x.detach(), x, x.detach(), w, u)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


#: internvl2-2b's prefill widths (16 query heads over 8 kv heads of 128,
#: causal) with its 256 image tokens ahead of two served text lengths and
#: of the 1024 that chip_smoke's phase 10 prefills, and at 2048; hubert-xlarge's encoder (16/16 heads of 80, bidirectional: no
#: tile is skipped) at the 128-row tile's edges, 1024 and 2048
FRONTEND_FLASH = ([((1, 256 + n, 16, 8, 128, True, 0), "bfloat16")
                   for n in (285, 1024, 1781)]
                  + [((1, 2048, 16, 8, 128, True, 0), "bfloat16")]
                  + [((1, S, 16, 16, 80, False, 0), "bfloat16")
                     for S in (127, 128, 129, 1024, 2048)]
                  + [((1, 2048, 16, 16, 80, False, 0), "float32")])


@pytest.mark.parametrize("shape,dtype", FRONTEND_FLASH, ids=str)
def test_flash_attention_frontend_shapes(card, shape, dtype):
    """bf16 on ``flash_fwd_tc`` within 1e-3 + 2^-7 |ref|, float32 on
    ``flash_fwd`` within 3e-5, of the plain version in float32."""
    B, S, H, KV, hd, causal, win = shape
    q, k, v = (torch.from_numpy(a).to(card).to(getattr(torch, dtype))
               for a in flash_inputs(B, S, H, KV, hd, seed=S + hd))
    before = fa.flash_attention.launches_tc
    out = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_tc == before + (dtype == "bfloat16")
    ref = fa.reference(q.float(), k.float(), v.float(), causal=causal,
                       window=win)
    atol, rtol = (3e-5, 0.0) if dtype == "float32" else (1e-3, 2.0 ** -7)
    assert_close(out, ref, atol, rtol)


def _frontend_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    if fe.kind == "audio_frames":
        return {"features": torch.from_numpy(rng.standard_normal(
            (B, S, fe.feature_dim)).astype(np.float32))}
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
            "image_embeds": torch.from_numpy(rng.standard_normal(
                (B, fe.num_prefix_tokens, fe.feature_dim))
                .astype(np.float32))}


@pytest.mark.parametrize("arch", ["internvl2_2b", "hubert_xlarge"])
def test_frontend_forward_on_card_matches_cpu(card, arch):
    """The same seed-made smoke weights on both devices, float32: forward
    logits within 1e-4 relative, attention on K2 on the card."""
    cfg = get_smoke_config(arch)
    cpu = M.init_model(torch.Generator().manual_seed(0), cfg)
    on_card = M.Model(cfg, None, card)
    on_card.load_state_dict(cpu.state_dict())
    inputs = _frontend_inputs(cfg, 2, 24, seed=1)
    before = fa.flash_attention.launches
    out = {}
    for name, params in [("cpu", cpu), ("card", on_card)]:
        dev = params.embed.table.device
        x, _ = M.forward(params, cfg, {k: v.to(dev)
                                       for k, v in inputs.items()})
        out[name] = M.logits(params, cfg, x).cpu()[..., :cfg.vocab]
    assert fa.flash_attention.launches == before + cfg.n_layers
    assert float((out["card"] - out["cpu"]).abs().max()
                 / out["cpu"].abs().max()) < 1e-4


def test_train_step_on_card_matches_cpu(card):
    """qwen3-32b's smoke config from the same weights on the same batches,
    float32: the first batch's grads every leaf within 1e-4 (max |diff|
    over max |ref|); two ``make_train_step`` steps, the losses within 1e-4,
    AdamW's m and v every leaf within 1e-4 element-wise, and every updated
    parameter within 1e-4 normwise (||diff|| / ||ref||: Adam moves an
    element with |g| near its eps by lr g / (|g| + eps), so float32
    rounding of such a grad moves it by up to a tenth of lr, and two
    correct float32 runs differ element-wise by a few 1e-4); no kernel
    launched."""
    import copy
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import optimizer, train_step
    cfg = get_smoke_config("qwen3_32b")
    opt = optimizer.OptConfig(total_steps=10, warmup_steps=2, peak_lr=1e-3)
    shape = ShapeConfig("s", "train", 32, 4, num_microbatches=2)
    step = train_step.make_train_step(cfg, shape, opt)
    cpu, _ = train_step.init_train_state(torch.Generator().manual_seed(0),
                                         cfg, opt)
    models = {"cpu": cpu, "card": copy.deepcopy(cpu).to(card)}
    states = {k: optimizer.init_opt_state(m) for k, m in models.items()}
    losses = {"cpu": [], "card": []}
    counts = [f.launches for f in (flash_attention, mamba2_scan, rwkv6_wkv)]
    batches = [torch.from_numpy(np.random.default_rng(i).integers(
        0, cfg.vocab, (4, 32))) for i in range(2)]
    grads = {}
    for k, m in models.items():
        t = batches[0].to(m.embed.table.device)
        grads[k], _, _ = train_step.grads_and_loss(
            m, cfg, {"tokens": t, "labels": t}, shape)
    for n, g in grads["cpu"].items():
        assert float((grads["card"][n].cpu() - g).abs().max()
                     / g.abs().max().clamp_min(1e-30)) < 1e-4, n
    for toks in batches:
        for k, m in models.items():
            t = toks.to(m.embed.table.device)
            _, states[k], met = step(m, states[k], {"tokens": t,
                                                    "labels": t})
            losses[k].append(float(met["loss"]))
    assert counts == [f.launches for f in (flash_attention, mamba2_scan,
                                           rwkv6_wkv)]
    for a, b in zip(losses["card"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b)
    for (n, p), (_, q) in zip(models["card"].named_parameters(),
                              models["cpu"].named_parameters()):
        err = float((p.detach().cpu() - q.detach()).norm()
                    / q.detach().norm())
        assert err < 1e-4, n
        for k in ("m", "v"):
            a, b = states["card"][k][n].cpu(), states["cpu"][k][n]
            assert float((a - b).abs().max() / b.abs().max()) < 1e-4, (k, n)


@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_3b",
                                  "deepseek_v2_lite_16b"])
def test_training_path_launches_no_kernel(card, arch):
    """The loss runs on the plain mixers: a backward on the card launches
    none of K2, K3 and K4, and every parameter the loss reaches gets a
    grad."""
    from repro_torch.train import optimizer, train_step
    cfg = get_smoke_config(arch)
    params, _ = train_step.init_train_state(
        torch.Generator(device=card).manual_seed(0), cfg,
        optimizer.OptConfig())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40))).to(card)
    counts = [f.launches for f in (flash_attention, mamba2_scan, rwkv6_wkv)]
    loss, _ = M.loss_fn(params, cfg, {"tokens": toks, "labels": toks})
    loss.backward()
    assert counts == [f.launches for f in (flash_attention, mamba2_scan,
                                           rwkv6_wkv)]
    assert torch.isfinite(loss)
    assert all(p.grad is not None for p in params.parameters())
