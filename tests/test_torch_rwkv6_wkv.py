"""The port's rwkv6_wkv plain version against the reference package.

The plain version (``reference``) and the op (``ops.rwkv6_wkv`` on CPU
tensors) must match ``repro.kernels.rwkv6_wkv_ref.reference`` (the
recurrence) and the Pallas ``rwkv6_wkv`` run in interpret mode, on the same
numpy inputs, within 2e-4 (the tolerance of tests/test_kernels.py). The
Pallas wrapper shrinks its chunk to a divisor of L (1 for a prime L); the
port takes a ragged last chunk, held to the recurrence alone, as is a
strong decay (w in [1e-4, 0.1]). The port's copies of the model's two WKV
forms (``wkv_naive``, ``wkv_chunked``) are held to the reference model's,
from a non-zero state. The CUDA kernel runs only on a card
(``tests/test_torch_cuda.py``).
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
from torch_parity import WKV_SHAPES, wkv_inputs

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
