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
from repro_torch.hedm import h2d, service, streaming
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hedm_label as HL
from repro_torch.kernels import hedm_reduce as port
from repro_torch.kernels import mamba2_scan as ms
from repro_torch.kernels import mla_decode as md
from repro_torch.kernels import rwkv6_wkv as wk
from repro_torch.kernels.ops import (flash_attention, hedm_reduce,
                                     mamba2_scan, mla_decode, rwkv6_wkv)
from repro_torch.models import model as M
from repro_torch.models import rwkv6 as rw
from repro_torch.serve.engine import Request, ServeSession, prefill_step
from torch_parity import HEDM_REDUCE_CASES as CASES
from torch_parity import (FLASH_SHAPES, LABEL_MASKS, SCAN_SHAPES,
                          WKV_SHAPES, flash_inputs, label_frames, label_mask,
                          scan_float64, scan_inputs, wkv_inputs)

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


#: hedm_label's shapes (F, H, W): a detector frame at 1 and 3 frames, and
#: at 1, 3 and 40 frames a small square, a ragged frame, a row and a column
LABEL_SHAPES = ([(F, 2048, 2048) for F in (1, 3)]
                + [(F, H, W) for H, W in ((192, 192), (257, 131), (1, 517),
                                          (517, 1)) for F in (1, 3, 40)])


def _label_launches(shape, n_spots):
    """The library calls of one `hedm_label`: pass 1 a chunk, then for each
    chunk with spots its weighing, after its relabeling where there are
    several chunks."""
    chunks = HL._chunks(*shape)
    weighed = sum(int(n_spots[a:b].sum()) > 0 for a, b in chunks)
    return len(chunks) + weighed * (1 + (len(chunks) > 1))


def _label_matches_host(card, mask, dtypes=(np.uint16, np.float32)):
    """The card's labeler on ``mask`` against the host algorithm, with
    uint16 and float32 weights: counts and peaks bit for bit, and every
    launch counted."""
    m = torch.from_numpy(mask).to(card)
    for dtype in dtypes:
        frames = label_frames(mask.shape, dtype, seed=7)
        before = HL.hedm_label.launches
        got = HL.hedm_label(m, torch.from_numpy(frames).to(card))
        want = HL.reference(mask, frames)
        assert HL.hedm_label.launches == before + _label_launches(
            mask.shape, want[1])
        for name, g, w in zip(("n_signal", "n_spots", "peaks"), got, want):
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (name, dtype)
            assert g.tobytes() == w.tobytes(), (name, dtype)


@pytest.mark.parametrize("shape", LABEL_SHAPES, ids=str)
@pytest.mark.parametrize("kind", LABEL_MASKS)
def test_label_kernel_matches_host(card, kind, shape):
    _label_matches_host(card, label_mask(kind, *shape, seed=sum(shape)))


@pytest.mark.parametrize("kind", ["random-0.05", "spiral", "checkerboard"])
@pytest.mark.parametrize("shape", [(40, 192, 192), (7, 257, 131)], ids=str)
def test_label_kernel_over_chunks(card, monkeypatch, kind, shape):
    # chunks of three frames, the last one short: pass 2 labels each again
    monkeypatch.setattr(HL, "CHUNK_PIXELS", 3 * shape[1] * shape[2])
    assert len(HL._chunks(*shape)) > 2
    _label_matches_host(card, label_mask(kind, *shape, seed=3))


@pytest.mark.parametrize("kind", ["full", "spiral", "rings",
                                  "checkerboard", "random-0.05"])
@pytest.mark.parametrize("shape", [(1, 2048, 2048), (3, 257, 131)],
                         ids=str)
def test_label_kernel_sums_uint16_in_pixel_order_too(card, monkeypatch,
                                                     kind, shape):
    # where the sums might not be exact (a frame larger than any detector's)
    # uint16 takes the ordered pass 2 of float32; here it is forced
    monkeypatch.setattr(HL, "_exact_sums", lambda H, W: False)
    _label_matches_host(card, label_mask(kind, *shape, seed=9), (np.uint16,))


@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.uint8,
                                   np.float16], ids=str)
@pytest.mark.parametrize("kind", ["full", "spiral", "random-0.05"])
def test_label_kernel_weighs_any_frame_type(card, kind, dtype):
    # float64 as given; the others cast to float64 on the card, as the host
    # casts them
    _label_matches_host(card, label_mask(kind, 3, 257, 131, seed=4), (dtype,))


def _detector_scan(F, size, dtype):
    frames, dark = T.simulate_detector_frames(F, size=size, n_spots=12,
                                              seed=6)
    if dtype in (np.uint16, np.int32):  # as an integer detector stores it
        frames = np.clip(np.rint(frames), 0, 65535).astype(dtype)
    return frames, dark


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.int32])
@pytest.mark.parametrize("F,size", [(1, 2048), (8, 192)])
def test_stage1_on_card_equals_cpu(card, monkeypatch, F, size, dtype):
    from repro_torch.core import telemetry
    frames, dark = _detector_scan(F, size, dtype)
    copies = []
    cpu = torch.Tensor.cpu

    def counted(t, *args, **kwargs):
        copies.append(t.is_cuda)
        return cpu(t, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    tr = telemetry.Tracer()
    before = HL.hedm_label.launches
    with telemetry.recording(tr):
        on_card = T.reduce_frames(frames, dark, device=card)
    monkeypatch.undo()
    # the mask stays on the card: two copies come back, the counts and
    # the peaks; one chunk, labelled and weighed
    assert sum(copies) == 2
    assert HL.hedm_label.launches == before + 2
    counters = tr.metrics.snapshot()["counters"]
    assert counters["stage1.card_labeled_frames"] == F
    on_cpu = T.reduce_frames(frames, dark, device="cpu")
    assert sum(r.n_spots for r in on_card) >= 4 * F
    assert T.pack_reduced(on_card).tobytes() == \
        T.pack_reduced(on_cpu).tobytes()


def _small_ring(card, monkeypatch, slot_bytes, slots=3):
    """``reduce_frames``'s ring on ``card`` replaced by one of ``slots``
    slots of ``slot_bytes``."""
    ring = h2d.StagingRing(card, slots, slot_bytes)
    dev = torch.device("cuda", torch.cuda.current_device())
    monkeypatch.setattr(h2d, "_rings", {dev: ring})
    return ring


#: slot sizes that split a frame mid-row, and mid-element: a 192-wide
#: float32 row is 768 bytes; 2048-wide, 8,192
RING_SLOTS = [40_001, 3 * 8_192 + 20, 1 << 20]


@pytest.mark.parametrize("slot_bytes", RING_SLOTS)
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.float64])
@pytest.mark.parametrize("F,size", [(8, 192), (3, 2048)])
def test_stage1_through_a_small_ring_equals_cpu(card, monkeypatch, F, size,
                                                dtype, slot_bytes):
    # each call wraps the ring many times: 8 float32 frames of 192^2 are
    # 30 chunks of 40,001 bytes, 3 of 2048^2 48 of 1 MiB
    from repro_torch.core import telemetry
    ring = _small_ring(card, monkeypatch, slot_bytes)
    frames, dark = _detector_scan(F, size, dtype)
    frames = frames.astype(dtype)
    tr = telemetry.Tracer()
    with telemetry.recording(tr):
        on_card = T.reduce_frames(frames, dark, device=card)
    on_cpu = T.reduce_frames(frames, dark, device="cpu")
    assert sum(r.n_spots for r in on_card) >= 4 * F
    assert T.pack_reduced(on_card).tobytes() == \
        T.pack_reduced(on_cpu).tobytes()
    # float64 frames go as the filter's float32 and the labeler's float64
    sizes = ([frames.size * 4, dark.size * 4, frames.nbytes]
             if dtype == np.float64 else [frames.nbytes, dark.size * 4])
    counters = tr.metrics.snapshot()["counters"]
    assert counters["stage1.h2d_bytes"] == sum(sizes)
    assert counters["stage1.h2d_pinned_bytes"] == sum(sizes)
    plan = h2d.chunk_plan(sizes, slot_bytes, 3)
    assert 0 <= counters["stage1.h2d_slot_waits"] <= len(plan)
    assert ring.next_slot == len(plan) % 3


def test_stage1_back_to_back_windows_through_the_ring(card, monkeypatch):
    # windows of a scan one after the other, nothing synchronized between
    # calls: each slot is refilled while the last call's DMAs may be queued
    _small_ring(card, monkeypatch, 3 * 8_192 + 20)
    frames, dark = _detector_scan(12, 2048, np.uint16)
    got = [T.reduce_frames(frames[w:w + 3], dark, device=card)
           for w in range(0, 12, 3)]
    for w, window in zip(range(0, 12, 3), got):
        want = T.reduce_frames(frames[w:w + 3], dark, device="cpu")
        assert T.pack_reduced(window).tobytes() == \
            T.pack_reduced(want).tobytes()


@pytest.mark.parametrize("slot_bytes", [h2d.SLOT_BYTES, 40_001])
def test_ring_copies_are_the_callers_bytes_when_it_returns(card,
                                                           slot_bytes):
    # the source is overwritten as soon as the call returns, its DMAs
    # still queued: what reaches the card is what was there at the call
    ring = h2d.StagingRing(card, 3, slot_bytes)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 60000, (8, 2048, 2048)).astype(np.float32)
    dark = rng.integers(0, 20, (2048, 2048)).astype(np.float32)
    want = [frames.copy(), dark.copy()]
    for _ in range(2):
        out, _ = ring.stage([frames, dark])
        frames[...] = -1.0
        dark[...] = -1.0
        torch.cuda.synchronize()
        for t, w in zip(out, want):
            assert torch.equal(t.cpu(), torch.from_numpy(w))
        frames[...] = want[0]
        dark[...] = want[1]


def test_stage1_with_the_plain_filter_labels_on_the_host(card):
    from repro_torch.core import telemetry
    frames, dark = _detector_scan(2, 192, np.uint16)
    tr = telemetry.Tracer()
    before = HL.hedm_label.launches
    with telemetry.recording(tr):
        got = T.reduce_frames(frames, dark, use_kernel=False, device=card)
    assert HL.hedm_label.launches == before
    counters = tr.metrics.snapshot()["counters"]
    assert counters.get("stage1.card_labeled_frames", 0) == 0
    names = [k.name for k in tr.children(tr.roots()[0])]
    assert names[:4] == ["stage1.h2d", "stage1.filter", "stage1.d2h",
                         "stage1.index"]
    want = T.reduce_frames(frames, dark, device="cpu")
    assert T.pack_reduced(got).tobytes() == T.pack_reduced(want).tobytes()


def test_stage1_recording_times_the_device_phases_by_events(card,
                                                           monkeypatch):
    from repro_torch.core import telemetry
    frames, dark = T.simulate_detector_frames(2, size=256, n_spots=8, seed=6)
    frames = frames.astype(np.uint16)
    want = T.reduce_frames(frames, dark, device=card)

    def refuse(*args, **kwargs):
        raise AssertionError("reduce_frames synchronized the device")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    timings, tr = {}, telemetry.Tracer()
    with telemetry.recording(tr):
        got = T.reduce_frames(frames, dark, device=card, timings=timings)
    assert T.pack_reduced(got).tobytes() == T.pack_reduced(want).tobytes()
    (root,) = tr.roots()
    kids = tr.children(root)
    assert [k.name for k in kids] == [
        "stage1.h2d", "stage1.filter", "stage1.label", "stage1.d2h",
        "stage1.label", "stage1.d2h", "stage1.unpack"]
    for key, name in (("h2d", "stage1.h2d"), ("kernel", "stage1.filter"),
                      ("d2h", "stage1.d2h")):
        spans = [k for k in kids if k.name == name]
        assert all(k.attrs["device_s"] > 0 for k in spans)
        assert timings[key] == pytest.approx(sum(k.duration for k in spans))
    # the labeler's launches carry their kernels' device seconds; labeling
    # is their host seconds and the unpacking's
    labels = [k for k in kids if k.name == "stage1.label"]
    assert all(k.attrs["device_s"] > 0 for k in labels)
    assert "device_s" not in kids[-1].attrs
    assert timings["labeling"] == pytest.approx(
        sum(k.duration for k in labels) + kids[-1].duration)
    assert sum(timings.values()) == pytest.approx(root.duration)
    assert tr.metrics.snapshot()["counters"][
        "stage1.card_labeled_frames"] == 2
    # the copies to the host block, so their device seconds lie within the
    # host spans (clocks of two sources: 100 us of room)
    for d2h in (k for k in kids if k.name == "stage1.d2h"):
        assert d2h.duration >= d2h.attrs["device_s"] - 1e-4
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    off = T.reduce_frames(frames, dark, device=card)
    assert T.pack_reduced(off).tobytes() == T.pack_reduced(want).tobytes()


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
    the flash-attention kernel, the absorbed decode over the latent caches
    through ``mla_decode``'s CUDA-core kernel in float32, once an MLA layer
    a decode step, against its plain version on the CPU)."""
    _session_on_card_matches_cpu(card, "deepseek_v2_lite_16b")


def _session_on_card_matches_cpu(card, arch):
    cfg = get_smoke_config(arch)
    cpu = M.init_model(torch.Generator().manual_seed(0), cfg)
    on_card = M.Model(cfg, None, card)
    on_card.load_state_dict(cpu.state_dict())
    served = {}
    for where, params in [("cpu", cpu), ("cuda", on_card)]:
        n = md.mla_decode.launches
        sess = ServeSession(params, cfg, batch_slots=2, capacity=32,
                            device=where)
        rng = np.random.default_rng(3)
        for i, n_tok in enumerate((11, 5, 17, 8)):
            sess.submit(Request(i, rng.integers(0, cfg.vocab, n_tok,
                                                dtype=np.int32), 6))
        served[where] = {r.request_id: r.generated
                         for r in sess.run_to_completion()}
        assert sess.nonfinite_logits == 0
        mla = cfg.attention == "mla" and where == "cuda"
        assert md.mla_decode.launches - n == (
            cfg.n_layers * len(sess.timings["decode"]) if mla else 0)
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
# MLA decode (the absorbed attention over the latent caches) on the card
# ---------------------------------------------------------------------------

#: the cached lengths the kernel's edges and the served cells give: one
#: position, a 32-position tile's edges, a part's (512 at H 16, 1,024 at
#: H 32), dsv2-lite.decode's mean, the capacity's edge and past it
MLA_CAP = 8192
MLA_LENGTHS = (1, 31, 32, 33, 63, 64, 65, 511, 513, 1025, 2300, 8191, 8192,
               MLA_CAP + 7)
#: (latent R, rope E): DeepSeek-V2-Lite's and Kimi-Linear's, the smoke
#: configs'
MLA_WIDTHS = ((512, 64), (32, 16))


def _mla_decode_inputs(card, B, H, R, E, dtype, lengths, cap=MLA_CAP,
                       seed=0):
    """q_abs, q_rope, ck, cr with N(0, 1) entries drawn on the card from
    ``seed``, and pos: slot b's cached length is lengths[b % len] (pos
    is that less 1: past the capacity the slot reads all of it)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=g, device=card).to(dtype)
    pos = torch.tensor([lengths[b % len(lengths)] - 1 for b in range(B)],
                       dtype=torch.int32, device=card)
    return draw(B, H, R), draw(B, H, E), draw(B, cap, R), draw(B, cap, E), pos


def _mla_scale(R, E):
    """The served configs' 1/sqrt(q/k head dim): 192 at 512 + 64, the smoke
    configs' 48 at 32 + 16."""
    return (192 if R == 512 else 48) ** -0.5


def _assert_mla_close(out, q_abs, q_rope, ck, cr, pos, scale):
    """The kernel against the plain version on the same inputs.

    float32: the same arithmetic summed in another order. Each score sums
    R + E products, each rounded within 2^-24 of itself, so a reordered
    score differs by at most ~(R + E) 2^-24 of the sum of its terms'
    magnitudes, ~2e-5 at R + E = 576 for these N(0, 1) inputs after the
    scale; the latent, a mean of the cache's rows weighted by
    probabilities that move by that much relative, is held within 1e-5 of
    the largest |ck| and 1e-5 of itself.

    bfloat16: the kernel rounds each unnormalised probability to bf16, the
    plain version the normalised one, each within 2^-9 of the value it
    rounds: the two probabilities of a position differ by at most 2^-8 of
    it, so the latent (a probability-weighted sum of cache rows) by at most
    2^-8 of the largest |ck|; both round the latent to bf16, one ulp apart
    at most: 2^-7 of itself."""
    ref = md.reference(q_abs, q_rope, ck, cr, pos, scale)
    torch.cuda.synchronize()
    big = float(ck.float().abs().max())
    if ck.dtype == torch.float32:
        assert_close(out, ref.float(), 1e-5 * big, 1e-5)
    else:
        assert_close(out, ref.float(), 2.0 ** -8 * big, 2.0 ** -7)
    assert out.dtype == ck.dtype and out.shape == q_abs.shape


@pytest.mark.parametrize("B", (1, 7, 128, 256))
@pytest.mark.parametrize("H", (16, 32))
@pytest.mark.parametrize("widths", MLA_WIDTHS, ids=str)
@pytest.mark.parametrize("dtype", BOTH)
def test_mla_decode_kernel_matches_plain_version(card, B, H, widths, dtype):
    """Every length of ``MLA_LENGTHS`` mixed in one batch (one of them at B
    1) over a capacity of 8,192: bf16 on ``mla_decode_tc``, float32 on
    ``mla_decode_cc``, one library call each."""
    R, E = widths
    dt_ = getattr(torch, dtype)
    args = _mla_decode_inputs(card, B, H, R, E, dt_, MLA_LENGTHS[::-1]
                              if B == 1 else MLA_LENGTHS, seed=B + H + R)
    n, n_tc = md.mla_decode.launches, md.mla_decode.launches_tc
    out = mla_decode(*args, _mla_scale(R, E))
    torch.cuda.synchronize()
    assert md.mla_decode.launches == n + 1
    assert md.mla_decode.launches_tc == n_tc + (dtype == "bfloat16")
    _assert_mla_close(out, *args, _mla_scale(R, E))


@pytest.mark.parametrize("length", MLA_LENGTHS)
@pytest.mark.parametrize("dtype", BOTH)
def test_mla_decode_one_slot_at_each_length(card, length, dtype):
    """B 1 at each cached length, DeepSeek-V2-Lite's widths."""
    args = _mla_decode_inputs(card, 1, 16, 512, 64, getattr(torch, dtype),
                              (length,), seed=length)
    out = mla_decode(*args, _mla_scale(512, 64))
    _assert_mla_close(out, *args, _mla_scale(512, 64))


@pytest.mark.parametrize("H", (1, 4, 20, 48))
def test_mla_decode_any_head_count(card, H):
    """Head counts that fill no 16-row tile, or more than one block's 32
    rows (bf16 on the tensor cores; heads past H are zero rows)."""
    args = _mla_decode_inputs(card, 5, H, 512, 64, torch.bfloat16,
                              (3, 700, 1500, 2049, 4100), cap=4096, seed=H)
    n_tc = md.mla_decode.launches_tc
    out = mla_decode(*args, _mla_scale(512, 64))
    assert md.mla_decode.launches_tc == n_tc + 1
    _assert_mla_close(out, *args, _mla_scale(512, 64))


@pytest.mark.parametrize("dtype,R,E,tc", [
    ("bfloat16", 512, 64, True), ("bfloat16", 32, 16, True),
    ("bfloat16", 64, 16, False), ("float32", 512, 64, False),
    ("float32", 40, 8, False)])
def test_mla_decode_dispatch(card, dtype, R, E, tc):
    """bf16 at the built widths takes ``mla_decode_tc``; float32, and bf16
    at other widths, ``mla_decode_cc``: both counted in ``launches``, the
    first also in ``launches_tc``; both match the plain version."""
    args = _mla_decode_inputs(card, 3, 16, R, E, getattr(torch, dtype),
                              (1, 600, 1200), cap=1536, seed=R + E)
    n, n_tc = md.mla_decode.launches, md.mla_decode.launches_tc
    out = mla_decode(*args, 0.1)
    assert md.on_tensor_cores(*args[:4]) == tc
    assert (md.mla_decode.launches, md.mla_decode.launches_tc) == \
        (n + 1, n_tc + tc)
    _assert_mla_close(out, *args, 0.1)


def test_mla_decode_takes_strided_queries(card):
    """q_abs as the decode's einsum leaves it (strided (B, H, R) over an
    (H, B, R) buffer) is made contiguous for the kernel; the caches must
    be contiguous."""
    q_abs, q_rope, ck, cr, pos = _mla_decode_inputs(
        card, 4, 16, 512, 64, torch.bfloat16, (9, 900), cap=1024)
    strided = q_abs.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    out = mla_decode(strided, q_rope, ck, cr, pos, 0.1)
    _assert_mla_close(out, q_abs, q_rope, ck, cr, pos, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        mla_decode(q_abs, q_rope, ck[:, ::2], cr[:, ::2], pos, 0.1)


def _bf16_mla_smoke():
    from repro_torch.configs.base import with_overrides
    return with_overrides(get_smoke_config("deepseek_v2_lite_16b"),
                          param_dtype="bfloat16", compute_dtype="bfloat16")


def test_mla_session_goes_through_the_kernel_every_decode_step(card):
    """A 4-request bf16 ``ServeSession`` on the deepseek-v2-lite smoke
    config (latent 32, rope 16): ``mla_decode`` launches once an MLA layer
    a decode step, every launch on the tensor cores, and no logit is
    non-finite. (The float32 session of the same config is held to the
    plain version on CPU copies, token for token, by
    ``test_deepseek_session_on_card_matches_cpu``.)"""
    cfg = _bf16_mla_smoke()
    params = M.init_model(torch.Generator(device=card).manual_seed(0), cfg)
    n, n_tc = md.mla_decode.launches, md.mla_decode.launches_tc
    sess = ServeSession(params, cfg, batch_slots=2, capacity=64, device=card)
    rng = np.random.default_rng(5)
    for i, length in enumerate((11, 5, 40, 8)):
        sess.submit(Request(i, rng.integers(0, cfg.vocab, length,
                                            dtype=np.int32), 12))
    done = sess.run_to_completion()
    want = cfg.n_layers * len(sess.timings["decode"])
    assert want > 0 and len(done) == 4
    assert (md.mla_decode.launches - n,
            md.mla_decode.launches_tc - n_tc) == (want, want)
    assert sess.nonfinite_logits == 0


def test_mla_decode_refuses_inputs_that_require_grad(card):
    args = _mla_decode_inputs(card, 2, 16, 32, 16, torch.float32, (5, 9),
                              cap=16)
    q = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        mla_decode(q, *args[1:], 0.1)
    with torch.no_grad():
        mla_decode(q, *args[1:], 0.1)


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


# ---------------------------------------------------------------------------
# device-level staging, the int8 DCN reduction and the resharded restore
# over NCCL at world size 1 (the card's machine has one card; multi-rank
# behaviour is held on the CPU by tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl(card, tmp_path):
    """An NCCL process group of one rank, destroyed after the test."""
    from datetime import timedelta

    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=120))
    try:
        yield card
    finally:
        dist.destroy_process_group()


def test_device_staging_over_nccl(nccl):
    from repro_torch.core.staging import (device_replicate, device_shard,
                                          staged_restore)
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import make_mesh
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    mesh = make_mesh((1, 1), ("data", "model"))
    rep = device_replicate(mesh, torch.from_numpy(x), "data")
    assert rep.is_cuda and torch.equal(rep.cpu(), torch.from_numpy(x))
    shards = {i: x[8 * i:8 * (i + 1)] for i in (3, 0, 7, 1, 2, 6, 4, 5)}
    back = staged_restore(mesh, shards, "data")
    assert back.is_cuda and torch.equal(back.cpu(), torch.from_numpy(x))
    d = device_shard(mesh, x, P("data", "model"))
    assert d.to_local().is_cuda and torch.equal(d.full_tensor().cpu(),
                                                torch.from_numpy(x))


def test_compression_over_nccl_matches_the_arithmetic(nccl):
    """One rank: the reduction is the quantize-dequantize-quantize-dequant
    arithmetic, bit for bit, and the same on the card as on the CPU."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import compression as C
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.standard_normal((256, 96))
                               .astype(np.float32)).to(nccl),
         "b": {"c": torch.from_numpy(rng.standard_normal(33)
                                     .astype(np.float32)).to(nccl)}}
    e = {"w": torch.full((256, 96), 1e-3, device=nccl),
         "b": {"c": torch.zeros(33, device=nccl)}}
    red, err = C.compressed_grad_allreduce(g, e, make_mesh((1,), ("pod",)))
    for got, ge, gerr, ee in ((red["w"], g["w"], err["w"], e["w"]),
                              (red["b"]["c"], g["b"]["c"], err["b"]["c"],
                               e["b"]["c"])):
        q, scale, new_e = C.compress_residual(ge, ee)
        q2, s2 = C.quantize_int8(C.dequantize_int8(q, scale))
        assert torch.equal(got, C.dequantize_int8(q2, s2))
        assert torch.equal(gerr, new_e)
        q_cpu, s_cpu, e_cpu = C.compress_residual(ge.cpu(), ee.cpu())
        assert torch.equal(q.cpu(), q_cpu)
        assert torch.equal(scale.cpu(), s_cpu)
        assert torch.equal(new_e.cpu(), e_cpu)


def test_restore_resharded_over_nccl(nccl, tmp_path):
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.distributed.sharding import (make_ctx, param_pspecs,
                                                  placements)
    from repro_torch.launch.mesh import make_mesh
    cfg = get_smoke_config("internvl2_2b")
    saved = M.init_model(torch.Generator(device=nccl).manual_seed(0), cfg)
    store = CheckpointStore(str(tmp_path / "ckpt"))
    store.save(1, saved)
    mesh = make_mesh((1, 1), ("data", "model"))
    specs = param_pspecs(cfg, saved, make_ctx(mesh))
    back = store.restore_resharded(M.Model(cfg, None, nccl), mesh, specs)
    for n, p in saved.named_parameters():
        assert tuple(back[n].placements) == tuple(placements(specs[n], mesh))
        assert back[n].to_local().is_cuda
        assert torch.equal(back[n].to_local().reshape(-1).view(torch.uint8),
                           p.detach().reshape(-1).view(torch.uint8)), n


def _internvl_smoke_batch(cfg, dev):
    from torch_parity import train_batch
    return {k: torch.from_numpy(v).to(dev)
            for k, v in train_batch(cfg, 4, 32, seed=13).items()}


def test_sharded_train_step_over_nccl(nccl):
    """chip_smoke.py's phase 13a at smoke size: two steps of internvl2-2b
    on a (1, 1) mesh over NCCL against two unsharded steps on the card
    from the same weights: losses and grad norms within 1e-5, every
    updated parameter within 1e-4 normwise."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = get_smoke_config("internvl2_2b")
    batch = _internvl_smoke_batch(cfg, nccl)
    shape = ShapeConfig("s", "train", 32, 4, num_microbatches=2, remat=True)
    opt = OptConfig(total_steps=10, warmup_steps=2, peak_lr=1e-3)
    runs = {}
    for which, ctx in (("one", None),
                       ("mesh", make_ctx(make_mesh((1, 1),
                                                   ("data", "model"))))):
        params, state = init_train_state(
            torch.Generator(device=nccl).manual_seed(0), cfg, opt, ctx=ctx)
        step = make_train_step(cfg, shape, opt, ctx=ctx)
        mets = []
        for _ in range(2):
            params, state, m = step(params, state, batch)
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        runs[which] = (mets, {n: p.to_local() if ctx is not None else p
                              for n, p in params.named_parameters()})
    (m0, p0), (m1, p1) = runs["one"], runs["mesh"]
    for (l0, g0), (l1, g1) in zip(m0, m1):
        assert abs(l1 - l0) <= 1e-5 * abs(l0)
        assert abs(g1 - g0) <= 1e-5 * abs(g0)
    for n, p in p0.items():
        assert float((p1[n] - p).norm() / p.norm()) < 1e-4, n


def test_sharded_prefill_over_nccl(nccl):
    """chip_smoke.py's phase 13d at smoke size: internvl2-2b's prefill
    through ``prefill_step(ctx=...)`` on a (1, 1) mesh over NCCL equals the
    unsharded prefill (logits and every cache), with one K2 launch a
    layer."""
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_mesh
    cfg = get_smoke_config("internvl2_2b")
    params = M.init_model(torch.Generator(device=nccl).manual_seed(0), cfg)
    batch = _internvl_smoke_batch(cfg, nccl)
    inputs = {k: batch[k][:1] for k in ("tokens", "image_embeds")}
    ref_logits, ref_caches = prefill_step(params, cfg, inputs, 64)
    ctx = make_ctx(make_mesh((1, 1), ("data", "model")))
    flash_attention.launches = 0
    logits, caches = prefill_step(params, cfg, inputs, 64, ctx=ctx)
    assert flash_attention.launches == cfg.n_layers
    assert torch.equal(logits, ref_logits)
    for kind, layers in ref_caches.items():
        for c, r in zip(caches[kind], layers):
            for a, b in zip(c, r):
                assert torch.equal(a, b), kind
