"""The port's mamba2_scan plain version against the reference package.

The plain version (``reference``) and the op (``ops.mamba2_scan`` on CPU
tensors) must match ``repro.kernels.mamba2_scan_ref.reference`` (the
recurrence) and the Pallas ``mamba2_scan`` run in interpret mode, on the
same numpy inputs, within 2e-4 (the tolerance of tests/test_kernels.py).
The Pallas kernel needs L to be a multiple of the chunk; the port takes a
ragged last chunk, held to the recurrence alone. The port's copies of the
model's two scans (``ssd_naive``, ``ssd_chunked``) are held to the
reference model's. The CUDA kernel runs only on a card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import mamba2_scan as pallas_kernel
from repro.kernels.mamba2_scan_ref import reference as jax_reference
from repro.models import mamba2 as jax_m2
from repro_torch.kernels import mamba2_scan as port
from repro_torch.kernels.ops import mamba2_scan
from repro_torch.models import mamba2 as port_m2
from torch_parity import (SCAN_SHAPES, scan_float64, scan_inputs,
                          scan_tc_emulation)

jax_reference = jax.jit(jax_reference)
pallas_scan = jax.jit(pallas_kernel, static_argnames=("chunk", "interpret"))


def _run(shape):
    B, L, H, P, G, N, chunk = shape
    arrays = scan_inputs(B, L, H, P, G, N, seed=L + P)
    before = port.mamba2_scan.launches
    y, h = mamba2_scan(*map(torch.from_numpy, arrays), chunk=chunk)
    assert port.mamba2_scan.launches == before       # no kernel on the CPU
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == (B, L, H, P) and h.shape == (B, H, P, N)
    return arrays, y.numpy(), h.numpy()


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_plain_version_matches_recurrence(shape):
    arrays, y, h = _run(shape)
    y_ref, h_ref = jax_reference(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(y, np.asarray(y_ref), rtol=0, atol=2e-4)
    np.testing.assert_allclose(h, np.asarray(h_ref), rtol=0, atol=2e-4)


@pytest.mark.parametrize("shape", [s for s in SCAN_SHAPES if s[1] % s[6] == 0],
                         ids=str)
def test_plain_version_matches_pallas_interpret(shape):
    arrays, y, h = _run(shape)
    y_k, h_k = pallas_scan(*map(jnp.asarray, arrays), chunk=shape[6],
                           interpret=True)
    np.testing.assert_allclose(y, np.asarray(y_k), rtol=0, atol=2e-4)
    np.testing.assert_allclose(h, np.asarray(h_k), rtol=0, atol=2e-4)


def test_plain_version_matches_recurrence_under_fast_decay():
    """A = -e^2 on every head: the cumulative log-decay of a chunk of 128
    passes -800, where a float32 step is ~6e-5. The plain version takes
    each decay as a segment sum, never as a difference of two prefix sums,
    and stays within 2e-4 of the recurrence. (The Pallas kernel takes
    differences and misses 2e-4 here, so it is held to the port only at
    the shapes above.)"""
    shape = (1, 256, 4, 16, 1, 16, 128)
    B, L, H, P, G, N, chunk = shape
    x, dt, A, Bm, Cm = scan_inputs(B, L, H, P, G, N, seed=7)
    A = np.full(H, -np.exp(2.0), np.float32)
    assert np.cumsum(dt[0, :chunk] * A, axis=0).min() < -100
    y, h = mamba2_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                       chunk=chunk)
    y_ref, h_ref = jax_reference(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("L", [285, 1781])
def test_plain_version_within_half_the_card_bound_of_float64(L):
    """zamba2's scan widths (112 heads, P 64, N 64, chunk 128), float32:
    the plain version within half the card bound of the recurrence in
    float64, (2e-4 + 1e-5 max |ref|) / 2 for y and for h, the bound
    tests/test_torch_cuda.py holds the kernel to on the card. Decays taken
    as differences of prefix sums missed it in y at L = 1781."""
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           scan_inputs(1, L, 112, 64, 1, 64, seed=L + 64))
    y64, h64 = scan_float64(x, dt, A, Bm, Cm)
    y, h = port.reference(x, dt, A, Bm, Cm, chunk=128)
    for out, ref in ((y, y64), (h, h64)):
        bound = (2e-4 + 1e-5 * float(ref.abs().max())) / 2
        assert float((out.double() - ref).abs().max()) <= bound


def test_segment_sums_are_running_sums_down_each_column():
    a = torch.tensor([[[-1.0], [-2.0], [-4.0], [-8.0]]])      # (1, 4, 1)
    seg = port.segment_sums(a)[0, :, :, 0]
    want = torch.tensor([[0.0, 0.0, 0.0, 0.0],
                         [-2.0, 0.0, 0.0, 0.0],
                         [-6.0, -4.0, 0.0, 0.0],
                         [-14.0, -12.0, -8.0, 0.0]])
    assert torch.equal(seg, want)


#: the tensor-core kernel's bf16 checks on the card: y within 2e-2 plus one
#: bf16 rounding step of each value, h within 2e-2, both against the plain
#: version in float32 on the same bf16 inputs (tests/test_torch_cuda.py)
PATH_WIDTH_SCAN = [(1, L, 112, 64, 1, 64, 128) for L in (285, 129)]


def _tc_excess(shape, split):
    B, L, H, P, G, N, chunk = shape
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           scan_inputs(B, L, H, P, G, N, seed=L + P))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    y_ref, h_ref = port.reference(x.float(), dt, A, Bm.float(), Cm.float(),
                                  chunk=chunk)
    y, h = scan_tc_emulation(x, dt, A, Bm, Cm, chunk=chunk, split=split)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    ey = (y.float() - y_ref).abs() - (2e-2 + 2.0 ** -7 * y_ref.abs())
    eh = (h - h_ref).abs() - 2e-2
    return float(ey.max()), float(eh.max())


@pytest.mark.parametrize("shape", PATH_WIDTH_SCAN, ids=str)
def test_tensor_core_rounding_holds_the_card_bound(shape):
    """M, h and w B entering the tensor cores as bf16 pairs hi + lo, the
    bf16 inputs as they are, fp32 sums: y and h within the card bound at
    zamba2's widths with a ragged last chunk."""
    ey, eh = _tc_excess(shape, split=True)
    assert ey <= 0 and eh <= 0, (ey, eh)


def test_single_bf16_rounding_breaks_the_card_bound():
    """Why the kernel splits every float32 operand: rounded once to bf16,
    M, h and w B put y and h past the card bound."""
    ey, eh = _tc_excess(PATH_WIDTH_SCAN[0], split=False)
    assert ey > 0 and eh > 0, (ey, eh)


def test_bfloat16_inputs_give_bfloat16_output_and_float32_state():
    x, dt, A, Bm, Cm = scan_inputs(1, 96, 4, 16, 2, 8, seed=5)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm)]
    y, h = mamba2_scan(bf[0], torch.from_numpy(dt), torch.from_numpy(A),
                       bf[1], bf[2], chunk=32)
    y32, h32 = port.reference(bf[0].float(), torch.from_numpy(dt),
                              torch.from_numpy(A), bf[1].float(),
                              bf[2].float(), chunk=32)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(h, h32)


@pytest.mark.parametrize("B,L,G,HG,P,N,chunk", [
    (2, 64, 2, 2, 16, 8, 16), (1, 96, 1, 4, 8, 16, 32)])
def test_model_scans_match_reference_model(B, L, G, HG, P, N, chunk):
    rng = np.random.default_rng(L)
    x = rng.standard_normal((B, L, G, HG, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, G, HG)))).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal((G, HG)))).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    jx = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    tx = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    for jfn, tfn, kw in [(jax_m2.ssd_naive, port_m2.ssd_naive, {}),
                         (jax_m2.ssd_chunked, port_m2.ssd_chunked,
                          {"chunk": chunk})]:
        y_ref, h_ref = jfn(*jx, **kw)
        y, h = tfn(*tx, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("case,error", [
    ("x3d", ValueError), ("groups", ValueError), ("dt16", TypeError),
    ("mixed", TypeError), ("chunk", ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    x, dt, A, Bm, Cm = map(torch.from_numpy, scan_inputs(1, 8, 4, 4, 2, 4))
    kw = {}
    if case == "x3d":
        x = x[0]
    elif case == "groups":
        Bm = Cm = torch.zeros(1, 8, 3, 4)
    elif case == "dt16":
        dt = dt.to(torch.bfloat16)
    elif case == "mixed":
        x = x.to(torch.bfloat16)
    else:
        kw["chunk"] = 256
    with pytest.raises(error):
        mamba2_scan(x, dt, A, Bm, Cm, **kw)
