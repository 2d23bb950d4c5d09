"""The port's rwkv6_wkv plain version against the reference package.

The plain version (``reference``) and the op (``ops.rwkv6_wkv`` on CPU
tensors) must match ``repro.kernels.rwkv6_wkv_ref.reference`` (the
recurrence) and the Pallas ``rwkv6_wkv`` run in interpret mode, on the same
numpy inputs, within 2e-4 (the tolerance of tests/test_kernels.py). The
Pallas wrapper shrinks its chunk to a divisor of L (1 for a prime L); the
port takes a ragged last chunk, held to the recurrence alone, as is a
strong decay (w in [1e-4, 0.1]). The port's copies of the model's two WKV
forms (``wkv_naive``, ``wkv_chunked``) are held to the reference model's,
from a non-zero state. The CUDA kernels run only on a card
(``tests/test_torch_cuda.py``); here the tensor-core kernel's rounding is
emulated (``torch_parity.wkv_tc_emulation``) and held to the card bounds,
and its dispatch rule and scratch size are checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import rwkv6_wkv as pallas_kernel
from repro.kernels.rwkv6_wkv_ref import reference as jax_reference
from repro.models import rwkv6 as jax_rw
from repro_torch.kernels import rwkv6_wkv as port
from repro_torch.kernels.ops import rwkv6_wkv
from repro_torch.models import rwkv6 as port_rw
from torch_parity import WKV_SHAPES, wkv_inputs, wkv_tc_emulation

jax_reference = jax.jit(jax_reference)
pallas_wkv = jax.jit(pallas_kernel, static_argnames=("chunk", "interpret"))
CASES = [(s, strong) for s in WKV_SHAPES for strong in (False, True)]


def _run(shape, strong):
    B, L, H, N, chunk = shape
    arrays = wkv_inputs(B, L, H, N, seed=L + N, strong=strong)
    before = port.rwkv6_wkv.launches
    out, s = rwkv6_wkv(*map(torch.from_numpy, arrays), chunk=chunk)
    assert port.rwkv6_wkv.launches == before         # no kernel on the CPU
    assert out.dtype == torch.float32 and s.dtype == torch.float32
    assert out.shape == (B, L, H, N) and s.shape == (B, H, N, N)
    plain = port.reference(*map(torch.from_numpy, arrays), chunk=chunk)
    assert torch.equal(out, plain[0]) and torch.equal(s, plain[1])
    return arrays, out.numpy(), s.numpy()


@pytest.mark.parametrize("shape,strong", CASES, ids=str)
def test_plain_version_matches_recurrence(shape, strong):
    arrays, out, s = _run(shape, strong)
    o_ref, s_ref = jax_reference(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(out, np.asarray(o_ref), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=0, atol=2e-4)


@pytest.mark.parametrize("shape", [s for s in WKV_SHAPES if s[1] % s[4] == 0],
                         ids=str)
def test_plain_version_matches_pallas_interpret(shape):
    arrays, out, s = _run(shape, False)
    o_k, s_k = pallas_wkv(*map(jnp.asarray, arrays), chunk=shape[4],
                          interpret=True)
    np.testing.assert_allclose(out, np.asarray(o_k), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s, np.asarray(s_k), rtol=0, atol=2e-4)


def test_strong_decay_takes_no_positive_exponent():
    """w = 1e-20 gives log w = -46 a step: exp(-lcum) would overflow float32
    within two steps; the pairwise form keeps every value finite and the
    output equals the one-step memory the recurrence gives."""
    r, k, v, _, u = wkv_inputs(1, 40, 2, 8, seed=7)
    w = np.full_like(r, 1e-20)
    out, s = rwkv6_wkv(*map(torch.from_numpy, (r, k, v, w, u)))
    o_ref, s_ref = jax_reference(*map(jnp.asarray, (r, k, v, w, u)))
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(o_ref), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=2e-4)


def test_bfloat16_inputs_give_bfloat16_output_and_float32_state():
    r, k, v, w, u = wkv_inputs(1, 70, 2, 16, seed=5)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    out, s = rwkv6_wkv(*bf, torch.from_numpy(w), torch.from_numpy(u))
    o32, s32 = port.reference(*[t.float() for t in bf], torch.from_numpy(w),
                              torch.from_numpy(u))
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(out, o32.to(torch.bfloat16))
    assert torch.equal(s, s32)


@pytest.mark.parametrize("B,L,H,N,chunk", [
    (2, 64, 3, 8, 16), (1, 60, 2, 16, 16), (1, 37, 2, 8, 16)])
def test_model_wkv_forms_match_reference_model(B, L, H, N, chunk):
    """wkv_naive and wkv_chunked from the same non-zero state s0 as the
    reference model's; chunked equals naive (tests/test_kernels.py:214-224).
    L = 60 shrinks the chunk to 15, L = 37 to 1."""
    r, k, v, w, u = wkv_inputs(B, L, H, N, seed=L)
    s0 = np.random.default_rng(L + 1).standard_normal(
        (B, H, N, N)).astype(np.float32)
    jx = [jnp.asarray(a) for a in (r, k, v, w, u)]
    tx = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    results = {}
    for name, jfn, tfn, kw in [
            ("naive", jax_rw.wkv_naive, port_rw.wkv_naive, {}),
            ("chunked", jax_rw.wkv_chunked, port_rw.wkv_chunked,
             {"chunk": chunk})]:
        o_ref, s_ref = jfn(*jx, jnp.asarray(s0), **kw)
        o, s = tfn(*tx, torch.from_numpy(s0), **kw)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                                   atol=2e-4)
        results[name] = (o.numpy(), s.numpy())
    for a, b in zip(results["naive"], results["chunked"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_zero_state_forms_match_the_plain_kernel_version():
    """From a zero state the model's forms and the kernel's plain version
    compute one function."""
    r, k, v, w, u = map(torch.from_numpy, wkv_inputs(2, 48, 2, 8, seed=3))
    o_k, s_k = port.reference(r, k, v, w, u)
    for fn in (port_rw.wkv_naive, port_rw.wkv_chunked):
        o, s = fn(r, k, v, w, u)
        np.testing.assert_allclose(o.numpy(), o_k.numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(s.numpy(), s_k.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case,error", [
    ("r3d", ValueError), ("u-shape", ValueError), ("w16", TypeError),
    ("u16", TypeError), ("mixed", TypeError), ("chunk", ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    r, k, v, w, u = map(torch.from_numpy, wkv_inputs(1, 8, 2, 4))
    kw = {}
    if case == "r3d":
        r = r[0]
    elif case == "u-shape":
        u = u[:1]
    elif case == "w16":
        w = w.to(torch.bfloat16)
    elif case == "u16":
        u = u.to(torch.bfloat16)
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    else:
        kw["chunk"] = 65
    with pytest.raises(error):
        rwkv6_wkv(r, k, v, w, u, **kw)


#: the card bounds of the bf16 kernel against the plain version run in
#: float32 on the same inputs (tests/test_torch_cuda.py, chip_smoke.py):
#: out within 1e-3 + 2^-7 |ref|, the float32 state within 2e-4 + 1e-5 |ref|
TC_CASES = [((1, 285, 40, 64, 32), "path"), ((1, 1781, 40, 64, 32), "path"),
            ((1, 97, 2, 16, 32), "strong"), ((1, 97, 2, 64, 32), "strong")]


def _tc_excess(shape, decay, split):
    """The worst excess over the card bounds of the emulated tensor-core
    kernel, (out, state); <= 0 is within them."""
    B, L, H, N, chunk = shape
    r, k, v, w, u = map(torch.from_numpy, wkv_inputs(
        B, L, H, N, seed=L + N, strong=decay == "strong",
        path=decay == "path"))
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    o_ref, s_ref = port.reference(r.float(), k.float(), v.float(), w, u,
                                  chunk=chunk)
    out, s = wkv_tc_emulation(r, k, v, w, u, chunk=chunk, split=split)
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(s).all()
    eo = (out.float() - o_ref).abs() - (1e-3 + 2.0 ** -7 * o_ref.abs())
    es = (s - s_ref).abs() - (2e-4 + 1e-5 * s_ref.abs())
    return float(eo.max()), float(es.max())


@pytest.mark.parametrize("shape,decay", TC_CASES, ids=str)
def test_tensor_core_rounding_holds_the_card_bound(shape, decay):
    """The scores, r exp(lprev), the state at each chunk's start and k
    exp(lcum_last - lcum) entering the tensor cores as bf16 pairs hi + lo,
    r, k, v as they are, fp32 sums: out and state within the card bounds
    at rwkv6-3b's widths and under a strong decay at N = 16 and 64."""
    eo, es = _tc_excess(shape, decay, split=True)
    assert eo <= 0 and es <= 0, (eo, es)


def test_single_bf16_rounding_breaks_the_card_bound():
    """Why the kernel splits every float32 operand: rounded once to bf16,
    they put out and the state past the card bounds at L = 1781."""
    eo, es = _tc_excess(TC_CASES[1][0], "path", split=False)
    assert eo > 0 and es > 0, (eo, es)


@pytest.mark.parametrize("dtype,N,chunk,tc", [
    (torch.bfloat16, 64, 32, True), (torch.bfloat16, 16, 64, True),
    (torch.bfloat16, 48, 16, True), (torch.bfloat16, 8, 32, False),
    (torch.bfloat16, 24, 32, False), (torch.bfloat16, 64, 65, False),
    (torch.float32, 64, 32, False)])
def test_dispatch_rule(dtype, N, chunk, tc):
    """bf16 with N a multiple of 16 (at most 64) and chunk <= 64 goes to the
    tensor-core kernel; float32 and other N to the CUDA-core one. On CPU
    tensors the wrapper runs the plain version whatever the rule says."""
    r, k, v, w, u = map(torch.from_numpy, wkv_inputs(1, 8, 2, N))
    r, k, v = (t.to(dtype) for t in (r, k, v))
    assert port.on_tensor_cores(r, k, v, w, chunk) == tc
    n, n_tc = port.rwkv6_wkv.launches, port.rwkv6_wkv.launches_tc
    rwkv6_wkv(r, k, v, w, u, chunk=min(chunk, port.MAX_CHUNK))
    assert (port.rwkv6_wkv.launches, port.rwkv6_wkv.launches_tc) == (n, n_tc)


@pytest.mark.parametrize("B,L,H,N,chunk,n_bytes", [
    (1, 2048, 40, 64, 32, 63_569_920), (1, 1781, 40, 64, 32, 55_623_680),
    (2, 97, 3, 16, 64, 62_208), (1, 1, 1, 16, 32, 2112)])
def test_scratch_size(B, L, H, N, chunk, n_bytes):
    """For each of the ceil(L / chunk) chunks of every (batch row, head):
    the float32 state (N, N) at its start and its decay (N,), and k exp(
    lcum_last - lcum) as two bf16 (QP, N) tiles, QP the chunk padded to 16,
    32 or 64 (a chunk longer than L is cut to L)."""
    assert port.scratch_bytes(B, L, H, N, chunk) == n_bytes
