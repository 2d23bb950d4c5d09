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
from torch_parity import SCAN_SHAPES, scan_inputs

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
