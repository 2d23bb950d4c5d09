"""The port's hedm_reduce against the reference package, bit for bit.

The port's plain version (``reference``) and its op (``ops.hedm_reduce`` on
CPU tensors) must equal both the JAX oracle and the Pallas kernel run in
interpret mode, on the cases of ``tests/test_kernels.py`` and on uint16
frames. The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hedm_reduce import hedm_reduce as pallas_kernel
from repro.kernels.hedm_reduce_ref import reference
from repro_torch.kernels import _build
from repro_torch.kernels import hedm_reduce as port
from repro_torch.kernels.ops import hedm_reduce
from torch_parity import HEDM_REDUCE_CASES as CASES
from torch_parity import pure_noise_case, spot_case


# the oracle and the Pallas kernel as they are, each compiled once per
# shape instead of dispatched op by op
jax_reference = jax.jit(reference, static_argnames="threshold")
pallas_hedm_reduce = jax.jit(pallas_kernel, static_argnames=(
    "threshold", "interpret", "tile_rows"))


def _assert_same(port_out, jax_out):
    m, c = port_out
    m_ref, c_ref = (np.asarray(a) for a in jax_out)
    assert m.dtype == torch.uint8 and c.dtype == torch.int32
    assert np.array_equal(m.numpy(), m_ref)
    assert np.array_equal(c.numpy(), c_ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax_oracle(case):
    frames, dark, thr, _ = CASES[case]()
    out = port.reference(torch.from_numpy(frames), torch.from_numpy(dark),
                         thr)
    _assert_same(out, jax_reference(jnp.asarray(frames), jnp.asarray(dark),
                                    threshold=thr))


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_pallas_kernel(case):
    """``ops.hedm_reduce`` on CPU tensors against the Pallas kernel in
    interpret mode, row-tiled as its own tests tile it."""
    frames, dark, thr, tile = CASES[case]()
    before = port.hedm_reduce.launches
    out = hedm_reduce(torch.from_numpy(frames), torch.from_numpy(dark), thr)
    assert port.hedm_reduce.launches == before    # CPU: no kernel launch
    _assert_same(out, pallas_hedm_reduce(
        jnp.asarray(frames), jnp.asarray(dark), threshold=thr,
        interpret=True, tile_rows=tile))


def test_spot_is_detected_and_noise_is_not():
    frames, dark, thr, _ = spot_case(np.float32)
    _, counts = hedm_reduce(torch.from_numpy(frames), torch.from_numpy(dark),
                            thr)
    assert counts[1] > 0
    frames, dark, thr, _ = pure_noise_case(np.float32)
    _, counts = hedm_reduce(torch.from_numpy(frames), torch.from_numpy(dark),
                            thr)
    assert int(counts.sum()) == 0


@pytest.mark.parametrize("frames,dark,error", [
    (torch.zeros(2, 8, 8), torch.zeros(8, 9), ValueError),
    (torch.zeros(8, 8), torch.zeros(8, 8), ValueError),
    (torch.zeros(2, 8, 8, dtype=torch.float64), torch.zeros(8, 8), TypeError),
    (torch.zeros(2, 8, 8, dtype=torch.int32), torch.zeros(8, 8), TypeError),
    (torch.zeros(2, 8, 8), torch.zeros(8, 8, dtype=torch.float64), TypeError),
    (torch.zeros(2, 8, 8), torch.zeros(8, 8, device="meta"), ValueError),
    (torch.zeros(2, 8, 8, device="meta"), torch.zeros(8, 8, device="meta"),
     ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(frames, dark, error):
    with pytest.raises(error):
        hedm_reduce(frames, dark, 100.0)


def test_build_targets_sm90a_without_fma_contraction():
    """The kernel's bit-exactness rests on these flags; the library lands in
    the git-ignored build directory under a name that tracks the source."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    path = _build.library_path("hedm_reduce")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("hedm_reduce-") and path.suffix == ".so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
