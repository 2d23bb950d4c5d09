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
    """The kernel's bit-exactness rests on these flags, which no other
    kernel takes; the library lands in the git-ignored build directory under
    a name that tracks the source and its flags."""
    flags = " ".join(_build.flags("hedm_reduce"))
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    for other in ("flash_attention", "mamba2_scan"):
        assert "arch=compute_90a,code=sm_90a" in " ".join(_build.flags(other))
        assert "--fmad=false" not in _build.flags(other)
    path = _build.library_path("hedm_reduce")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("hedm_reduce-") and path.suffix == ".so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


def sorted_column_median(img: torch.Tensor) -> torch.Tensor:
    """The kernel's 3x3 median of (F, H, W) with edge replication: each
    3-row column sorted once, then med3(max of the lows, med3 of the mids,
    min of the highs) over three adjacent columns, all by min and max."""
    p = torch.nn.functional.pad(img[:, None], (1, 1, 1, 1),
                                mode="replicate")[:, 0]
    H, W = img.shape[1:]
    a, b, c = p[:, 0:H], p[:, 1:H + 1], p[:, 2:H + 2]
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    mi = torch.minimum(torch.maximum(a, b),
                       torch.maximum(torch.minimum(a, b), c))

    def med3(x, y, z):
        return torch.maximum(torch.minimum(x, y),
                             torch.minimum(torch.maximum(x, y), z))

    cols = [slice(d, d + W) for d in range(3)]
    return med3(
        torch.maximum(torch.maximum(lo[..., cols[0]], lo[..., cols[1]]),
                      lo[..., cols[2]]),
        med3(mi[..., cols[0]], mi[..., cols[1]], mi[..., cols[2]]),
        torch.minimum(torch.minimum(hi[..., cols[0]], hi[..., cols[1]]),
                      hi[..., cols[2]]))


def _median_inputs(case):
    rng = np.random.default_rng(len(case))
    if case == "u16-small-range":          # heavy ties
        return rng.integers(0, 4, (3, 37, 41)).astype(np.uint16)
    if case == "u16-full-range":
        return rng.integers(0, 65536, (2, 33, 40)).astype(np.uint16)
    if case == "constant-regions":
        f = np.full((2, 40, 48), 7.0, np.float32)
        f[:, 10:20, 5:30] = 3.0
        f[1, 25:, 20:] = 9.0
        f[0, ::7, ::5] = rng.integers(0, 12, f[0, ::7, ::5].shape)
        return f
    if case == "signed-zeros":             # -0.0 and +0.0 mixed with ties
        f = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32),
                       (3, 29, 31))
        return f.astype(np.float32)
    if case == "ragged":
        return rng.standard_normal((2, 5, 3)).astype(np.float32)
    return rng.standard_normal((2, 45, 50)).astype(np.float32)


@pytest.mark.parametrize("case", ["u16-small-range", "u16-full-range",
                                  "constant-regions", "signed-zeros",
                                  "ragged", "normal"])
def test_sorted_column_median_is_the_median(case):
    """The identity the kernel's median rests on: the median of 9 is an
    order statistic, and med3(max of the lows, med3 of the mids, min of the
    highs) of three sorted columns selects it, ties and signed zeros
    included (held by value: -0.0 == +0.0, the only freedom, which no
    compare of the mask can see)."""
    img = torch.from_numpy(_median_inputs(case)).to(torch.float32)
    want = torch.median(port._neighborhood(img), dim=0).values
    got = sorted_column_median(img)
    assert bool((got == want).all())
