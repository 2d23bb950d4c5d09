"""``mla_decode`` (the absorbed MLA decode attention over the latent caches)
on the CPU: its plain version against the code it replaced, the kernel's
split of the positions and online softmax emulated in float64, the
dispatcher op's fake shapes and FLOP formula, and a CUDA call that never
reaches the plain version (the library a stand-in). The kernel itself is
held to the plain version on the card by ``tests/test_torch_cuda.py``.
"""
import contextlib
import math
import types

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.distributed.op_cost import OpCost
from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode as md
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

NEG_INF = -1e30
#: (latent R, rope E): DeepSeek-V2-Lite's and Kimi-Linear's, the smoke
#: configs'
WIDTHS = ((512, 64), (32, 16))
CAP = 40


def former_core(q_abs, q_rope, ck, cr, pos, scale):
    """The attention core of ``_mla_absorbed`` as it stood before the
    kernel, line for line."""
    cap = ck.shape[1]
    scores = (torch.einsum("bhr,btr->bht", q_abs.float(), ck.float())
              + torch.einsum("bhe,bte->bht", q_rope.float(),
                             cr.float())) * scale
    valid = torch.arange(cap, device=q_abs.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(ck.dtype)
    return torch.einsum("bht,btr->bhr", probs, ck)


def former_absorbed(params, cfg, q_nope, q_rope, ck, cr, pos):
    """``_mla_absorbed`` as it stood before the kernel."""
    m = cfg.mla
    B = q_nope.shape[0]
    H, r = cfg.n_heads, m.kv_lora_rank
    w_uk = params["w_uk"].reshape(r, H, m.qk_nope_head_dim)
    q_abs = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], w_uk)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    lat = former_core(q_abs, q_rope[:, 0], ck, cr, pos, scale)
    w_uv = params["w_uv"].reshape(r, H, m.v_head_dim)
    return torch.einsum("bhr,rhe->bhe", lat, w_uv).reshape(
        B, 1, H * m.v_head_dim) @ params["wo"]


def inputs(B, H, R, E, dtype, pos, cap=CAP, seed=0):
    """q_abs (as the decode's einsum leaves it: strided), q_rope, ck, cr
    from a numpy seed, and pos."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    q_abs = draw(H, B, R).transpose(0, 1)
    return (q_abs, draw(B, H, E), draw(B, cap, R), draw(B, cap, E),
            torch.tensor(pos, dtype=torch.int32))


#: ragged positions: the first, mid-capacity, the capacity's last, past it
RAGGED = (0, 1, 17, CAP - 2, CAP - 1, CAP, CAP + 9)


@pytest.mark.parametrize("H", (16, 32))
@pytest.mark.parametrize("widths", WIDTHS, ids=str)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
def test_plain_version_is_the_former_core_bit_for_bit(H, widths, dtype):
    R, E = widths
    args = inputs(len(RAGGED), H, R, E, dtype, RAGGED, seed=H + R)
    scale = 192 ** -0.5
    out = ops.mla_decode(*args, scale)
    assert out.dtype == dtype and out.shape == (len(RAGGED), H, R)
    assert torch.equal(out, former_core(*args, scale))
    assert torch.equal(md.reference(*args, scale), former_core(*args, scale))


@pytest.mark.parametrize("widths", ["smoke", "deepseek"])
def test_absorbed_decode_is_the_former_one_bit_for_bit(widths):
    """``_mla_absorbed`` through the op equals the code it replaced, bit for
    bit, on a smoke model's weights (float32) at the smoke widths and at
    DeepSeek-V2-Lite's MLA widths."""
    import dataclasses
    cfg = registry.get_smoke_config("deepseek_v2_lite_16b")
    if widths == "deepseek":
        cfg = dataclasses.replace(cfg, n_heads=16, n_kv_heads=16,
                                  head_dim=192, mla=dataclasses.replace(
                                      cfg.mla, kv_lora_rank=512,
                                      qk_nope_head_dim=128,
                                      qk_rope_head_dim=64, v_head_dim=128))
    attn = TM.init_model(torch.Generator().manual_seed(0),
                         cfg).stack.prefix[0].attn
    m, H = cfg.mla, cfg.n_heads
    rng = np.random.default_rng(3)
    B = len(RAGGED)
    q_nope = torch.from_numpy(rng.standard_normal(
        (B, 1, H, m.qk_nope_head_dim)).astype(np.float32))
    q_rope = torch.from_numpy(rng.standard_normal(
        (B, 1, H, m.qk_rope_head_dim)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal(
        (B, CAP, m.kv_lora_rank)).astype(np.float32))
    cr = torch.from_numpy(rng.standard_normal(
        (B, CAP, m.qk_rope_head_dim)).astype(np.float32))
    pos = torch.tensor(RAGGED, dtype=torch.int32)
    with torch.no_grad():
        got = TA._mla_absorbed(attn, cfg, q_nope, q_rope, ck, cr, pos)
        want = former_absorbed(attn, cfg, q_nope, q_rope, ck, cr, pos)
    assert torch.equal(got, want)


def span(n_pos, p, cap, max_parts, chunk):
    """The kernel's split (``span`` in csrc/mla_decode.cu): slot positions
    [t0, t1) of part p and the slot's number of parts."""
    n = max(min(n_pos, cap - 1) + 1, 0)
    parts = min(max_parts, max(1, -(-n // chunk)))
    per = -(-(-(-n // parts)) // 32) * 32
    t0 = min(p * per, n)
    return parts, t0, min(t0 + per, n)


def emulate(q_abs, q_rope, ck, cr, pos, scale, tile=64, chunk=None):
    """The tensor-core kernel's arithmetic in float64 (its sums exact): the
    positions split as the kernel splits them, an online softmax a tile at
    a time with exp(score - running max) rounded to the caches' type before
    the product, the unrounded sum dividing, the parts merged as the
    combine merges them; the result rounded to the caches' type."""
    B, H, R = q_abs.shape
    cap = ck.shape[1]
    max_parts, default = md.parts(H, cap)
    chunk = chunk or default
    q = torch.cat([q_abs, q_rope], -1).double()
    kv = torch.cat([ck, cr], -1).double()
    out = torch.empty(B, H, R, dtype=torch.float64)
    for b in range(B):
        parts = span(int(pos[b]), 0, cap, max_parts, chunk)[0]
        ms, ls, os_ = [], [], []
        for p in range(parts):
            _, t0, t1 = span(int(pos[b]), p, cap, max_parts, chunk)
            m = torch.full((H,), -math.inf, dtype=torch.float64)
            l = torch.zeros(H, dtype=torch.float64)
            o = torch.zeros(H, R, dtype=torch.float64)
            for ts in range(t0, t1, tile):
                s = (q[b] @ kv[b, ts:min(ts + tile, t1)].T) * scale
                mx = torch.maximum(m, s.max(-1).values)
                e = torch.exp(s - mx[:, None])
                alpha = torch.exp(m - mx)
                l = l * alpha + e.sum(-1)
                o = o * alpha[:, None] + e.to(ck.dtype).double() @ \
                    kv[b, ts:min(ts + tile, t1), :R]
                m = mx
            ms.append(m), ls.append(l), os_.append(o)
        m_all = torch.stack(ms)
        w = torch.exp(m_all - m_all.max(0).values)
        out[b] = (w[..., None] * torch.stack(os_)).sum(0) / \
            (w * torch.stack(ls)).sum(0)[:, None]
    return out.to(ck.dtype)


@pytest.mark.parametrize("H", (16, 32))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
def test_the_kernels_split_and_online_softmax_hold_the_stated_bound(H,
                                                                    dtype):
    """The kernel's algorithm (split into parts of whole tiles, online
    softmax, the unnormalised probabilities rounded, the parts combined),
    emulated in float64 over a capacity of 3,000 with a chunk of 256 so
    that slots split into up to 12 parts: within the bound
    ``tests/test_torch_cuda.py`` holds the kernel to (float32: 1e-5 of the
    largest |ck| and of itself; bf16: 2^-8 of the largest |ck| and 2^-7 of
    itself), and every part boundary on a multiple of 32 positions."""
    cap = 3000
    lens = (1, 33, 64, 65, 257, 700, 1500, 2999, 3000, 3007)
    args = inputs(len(lens), H, 32, 16, dtype, [n - 1 for n in lens],
                  cap=cap, seed=H)
    ref = md.reference(*args, 0.3).double()
    got = emulate(*args, 0.3, chunk=256).double()
    big = float(args[2].double().abs().max())
    atol, rtol = ((1e-5 * big, 1e-5) if dtype == torch.float32
                  else (2.0 ** -8 * big, 2.0 ** -7))
    assert float(((got - ref).abs() - atol - rtol * ref.abs()).max()) <= 0
    for n in lens:
        parts = span(n - 1, 0, cap, md.parts(H, cap)[0], 256)[0]
        cuts = [span(n - 1, p, cap, md.parts(H, cap)[0], 256)[1:]
                for p in range(parts)]
        assert cuts[0][0] == 0 and cuts[-1][1] == min(n, cap)
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        assert all(t0 % 32 == 0 for t0, _ in cuts)


@pytest.mark.parametrize("H,cap,want", [(16, 8192, (8, 1024)),
                                        (32, 8192, (6, 1536)),
                                        (4, 64, (1, 1024)),
                                        (16, 1 << 20, (32, 1024))])
def test_parts_at_the_served_shapes(H, cap, want):
    """8 parts of at least 1,024 positions at DeepSeek-V2-Lite's 16 heads, 6
    of 1,536 at Kimi-Linear's 32, one at the smoke capacity, and never more
    than the combine's 32."""
    assert md.parts(H, cap) == want


def test_flops_count_the_positions_attended():
    """The formula: 2 H (2 R + E) a position attended; positions are
    min(pos + 1, cap) a slot (not the capacity), 10.25 GFLOP at a
    dsv2-lite.decode step's 294,400."""
    pos = torch.tensor([0, 9, 39, 40, 100], dtype=torch.int32)
    assert md.attended(pos, 40) == 1 + 10 + 40 + 40 + 40
    assert md.flops(16, 512, 64, 294_400) == 10_249_830_400
    q_abs, q_rope, ck, cr, _ = inputs(5, 16, 32, 16, torch.bfloat16,
                                      [0] * 5)
    assert md._flop_formula(q_abs, q_rope, ck, cr, pos, 0.1) == \
        md.flops(16, 32, 16, 131)


def test_fake_cuda_tensors_trace_the_whole_capacity():
    """On fake CUDA tensors (a traced program: no data) the op gives the
    output's shape and type and, the positions unknown, counts every
    slot's whole capacity; nothing is built or launched."""
    n = md.mla_decode.launches
    with FakeTensorMode():
        q_abs = torch.empty(128, 16, 512, dtype=torch.bfloat16,
                            device="cuda")
        q_rope = torch.empty(128, 16, 64, dtype=torch.bfloat16,
                             device="cuda")
        ck = torch.empty(128, 8192, 512, dtype=torch.bfloat16,
                         device="cuda")
        cr = torch.empty(128, 8192, 64, dtype=torch.bfloat16, device="cuda")
        pos = torch.empty(128, dtype=torch.int32, device="cuda")
        with OpCost() as cost:
            out = ops.mla_decode(q_abs, q_rope, ck, cr, pos, 0.07)
    assert (out.shape, out.dtype, out.device.type) == (
        (128, 16, 512), torch.bfloat16, "cuda")
    assert cost.flops_by_op()["repro_torch.mla_decode"] == \
        md.flops(16, 512, 64, 128 * 8192)
    assert md.mla_decode.launches == n


@pytest.fixture
def stand_in_card(monkeypatch):
    """``mla_decode`` on CPU tensors as if they were on the card: the
    library a stand-in that records its calls, the device guard a no-op,
    and the plain version raising if anything reaches it."""
    calls = []

    class Lib:
        def __getattr__(self, symbol):
            def fn(*args):
                calls.append((symbol, args))
                return 0
            return fn
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(_build, "on_card", lambda name, *inputs: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    monkeypatch.setattr(md._LIB, "_functions", {})

    def refuse(*args, **kwargs):
        raise AssertionError("a card call reached the plain version")
    monkeypatch.setattr(md, "reference", refuse)
    return calls


@pytest.mark.parametrize("dtype,widths,symbol", [
    (torch.bfloat16, (512, 64), "mla_decode_bf16_tc"),
    (torch.bfloat16, (32, 16), "mla_decode_bf16_tc"),
    (torch.bfloat16, (64, 16), "mla_decode_bf16"),
    (torch.float32, (512, 64), "mla_decode_f32")])
def test_a_card_call_launches_and_never_reaches_the_plain_version(
        stand_in_card, dtype, widths, symbol):
    """One library call a decode, on the symbol the dispatch rule names,
    with the sizes, the part count and chunk of :func:`parts` and the
    scale; counted in ``launches`` (and ``launches_tc`` on the tensor
    cores); q_abs made contiguous first."""
    R, E = widths
    args = inputs(3, 16, R, E, dtype, [0, 5, 90], cap=100)
    n, n_tc = md.mla_decode.launches, md.mla_decode.launches_tc
    out = md.mla_decode(*args, 0.25)
    assert out.shape == (3, 16, R) and out.dtype == dtype
    [(got, call)] = stand_in_card
    assert got == symbol
    assert call[9:] == (3, 16, R, E, 100, 1, 1024, 0.25, 7)
    assert (md.mla_decode.launches, md.mla_decode.launches_tc) == (
        n + 1, n_tc + (symbol == "mla_decode_bf16_tc"))


def test_a_traced_card_call_counts_the_positions_attended(stand_in_card):
    """Under the flop counter (with data: a profiled run on the card) the
    call goes through the op, whose formula reads ``pos``."""
    args = inputs(3, 16, 32, 16, torch.bfloat16, [0, 5, 90], cap=64)
    with FlopCounterMode(display=False) as counter:
        md.mla_decode(*args, 0.25)
    assert counter.get_total_flops() == md.flops(16, 32, 16, 1 + 6 + 64)


@pytest.mark.parametrize("bad,error", [
    (lambda a: (a[0][:, :, :8], *a[1:]), ValueError),
    (lambda a: (*a[:2], a[2].double(), *a[3:]), TypeError),
    (lambda a: (*a[:4], a[4].float()), TypeError),
    (lambda a: (*a[:4], a[4][:2]), ValueError)])
def test_mismatched_inputs_raise(bad, error):
    args = inputs(3, 4, 32, 16, torch.float32, [0, 5, 9])
    with pytest.raises(error):
        ops.mla_decode(*bad(args), 0.1)
