"""The port's flash_attention plain version against the reference oracle.

The plain version (``reference``) and the op (``ops.flash_attention`` on
CPU tensors) must match ``repro.kernels.flash_attention_ref.reference`` on
the same numpy inputs: float32 within 3e-5 and bfloat16 within 2e-2, the
tolerances of tests/test_kernels.py. The Pallas kernel is not the oracle:
it does not run on this JAX (ROADMAP §3). The CUDA kernel itself runs only
on a card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention_ref import reference as jax_reference
from repro_torch.kernels import flash_attention as port
from repro_torch.kernels.ops import flash_attention
from torch_parity import FLASH_SHAPES, flash_inputs, flash_tc_emulation

jax_reference = jax.jit(jax_reference, static_argnames=("causal", "window",
                                                        "scale"))
TOL = {"float32": 3e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,win", FLASH_SHAPES)
def test_plain_version_matches_oracle(B, S, H, KV, hd, causal, win, dtype):
    arrays = flash_inputs(B, S, H, KV, hd, seed=S + hd)
    ref = jax_reference(*(jnp.asarray(a, dtype) for a in arrays),
                        causal=causal, window=win)
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    before = port.flash_attention.launches
    out = flash_attention(*ts, causal=causal, window=win)
    assert port.flash_attention.launches == before   # no kernel on the CPU
    assert out.dtype == ts[0].dtype and out.shape == ts[0].shape
    assert torch.equal(out, port.reference(*ts, causal=causal, window=win))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad_v", [False, True], ids=["v192", "v128-padded"])
def test_plain_version_matches_oracle_at_mla_width(dtype, pad_v):
    """deepseek-v2-lite's MLA prefill width, 16 heads of 192 causal, at the
    scale 192^-0.5; with v zero-padded from 128 as the model pads it, the
    padded output columns are exactly 0."""
    q, k, v = flash_inputs(1, 77, 16, 16, 192, seed=192)
    if pad_v:
        v[..., 128:] = 0
    arrays = (q, k, v)
    ref = jax_reference(*(jnp.asarray(a, dtype) for a in arrays),
                        causal=True, window=0, scale=192 ** -0.5)
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    out = flash_attention(*ts, causal=True, scale=192 ** -0.5)
    assert out.shape == (1, 77, 16, 192)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=TOL[dtype])
    if pad_v:
        assert not out[..., 128:].any()


def test_explicit_scale_matches_oracle():
    arrays = flash_inputs(1, 64, 4, 2, 32, seed=3)
    ref = jax_reference(*map(jnp.asarray, arrays), causal=True, window=0,
                        scale=0.3)
    out = flash_attention(*map(torch.from_numpy, arrays), scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=3e-5)


def test_first_causal_row_is_its_own_value():
    """Query 0 sees key 0 alone: every head of its kv head returns v[0]."""
    q, k, v = (torch.from_numpy(a) for a in flash_inputs(1, 8, 2, 1, 16))
    out = flash_attention(q, k, v, causal=True)
    assert torch.isfinite(out).all()
    assert torch.allclose(out[0, 0], v[0, 0].expand(2, 16), atol=1e-6)


#: zamba2's attention widths (32 heads of 112) at ragged lengths: 285
#: leaves 29 rows in the last 128-row tile, 129 one row past a tile; then
#: deepseek-v2-lite's MLA prefill widths (16 heads of 192)
PATH_WIDTH_FLASH = [(1, S, 32, 32, 112) for S in (285, 129)] + [
    (1, 285, 16, 16, 192)]


def _tc_excess(shape, split):
    """The card bound's worst excess (<= 0 holds) and the number of
    elements past it: the tensor-core kernel's rounding against the plain
    version in float32 on the same bf16 inputs, 1e-3 + 2^-7 |ref|."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in flash_inputs(*shape, seed=shape[1] + shape[4]))
    ref = port.reference(q.float(), k.float(), v.float())
    out = flash_tc_emulation(q, k, v, split=split)
    assert out.dtype == torch.bfloat16
    excess = (out.float() - ref).abs() - (1e-3 + 2.0 ** -7 * ref.abs())
    return float(excess.max()), int((excess > 0).sum())


@pytest.mark.parametrize("shape", PATH_WIDTH_FLASH, ids=str)
def test_tensor_core_rounding_holds_the_card_bound(shape):
    """P entering the tensor cores as a bf16 pair hi + lo, q, k, v as they
    are, fp32 sums, bf16 out: within the card bound."""
    worst, n_bad = _tc_excess(shape, split=True)
    assert n_bad == 0, worst


def test_single_bf16_rounding_breaks_the_card_bound():
    """Why the kernel splits P: rounded once to bf16 before P V, outputs
    near 0 miss the card bound (the row sum from the rounded P does not
    help either)."""
    worst, n_bad = _tc_excess(PATH_WIDTH_FLASH[0], split=False)
    assert n_bad > 0 and worst > 0


@pytest.mark.parametrize("q,k,v,error", [
    (torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8),
     ValueError),
    (torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
     ValueError),
    (torch.zeros(1, 4, 2, 8), torch.zeros(1, 5, 2, 8), torch.zeros(1, 5, 2, 8),
     ValueError),
    (torch.zeros(1, 4, 2, 8, dtype=torch.float16),
     torch.zeros(1, 4, 2, 8, dtype=torch.float16),
     torch.zeros(1, 4, 2, 8, dtype=torch.float16), TypeError),
    (torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16),
     torch.zeros(1, 4, 2, 8), TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(q, k, v, error):
    with pytest.raises(error):
        flash_attention(q, k, v)
