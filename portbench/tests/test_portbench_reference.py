"""The plain reference against the program on the CPU, at small sizes: the
reference's stage 1 gives ``reduce_frames``' results exactly, its stage 2
the same orientations as ``fit_grid`` to float32 round-off."""
import numpy as np
import pytest
import torch

from portbench.gen import frames as gen_frames
from portbench.gen import grid as gen_grid
from portbench.reference import fit, stage1
from repro_torch.hedm.pipeline import fit_grid, make_gvectors, reduce_frames

CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
@pytest.mark.parametrize("seed,size", [(1, (96, 80)), (2 ** 33 + 5, (64, 64)),
                                       (77, (40, 130))])
def test_stage1_reference_equals_reduce_frames(dtype, seed, size):
    gen = torch.Generator().manual_seed(seed)
    frames, dark = gen_frames.layer(6, *size, 12, dtype, gen, CPU)
    assert frames.dtype == np.dtype(dtype)
    got = reduce_frames(frames, dark, threshold=200.0, device="cpu")
    want = stage1.reduce_block(frames, dark, 200.0, CPU)
    assert sum(n for _, n, _ in want) > 0
    for r, (count, n, peaks) in zip(got, want):
        assert r.n_signal_pixels == count and r.n_spots == n
        assert np.array_equal(r.peaks, peaks)


def test_components_are_four_connected_in_scan_order():
    mask = torch.tensor([[[1, 0, 1, 1],
                          [1, 0, 0, 1],
                          [0, 1, 0, 1],
                          [1, 1, 0, 0]]], dtype=torch.bool)
    idx, comp, first = stage1.components(mask)
    labels = torch.zeros(16, dtype=torch.long)
    labels[idx] = comp + 1
    assert labels.view(4, 4).tolist() == [[1, 0, 2, 2], [1, 0, 0, 2],
                                          [0, 3, 0, 2], [3, 3, 0, 0]]
    assert first.tolist() == [0, 2, 9]


def test_generators_are_the_programs():
    assert np.array_equal(gen_grid.gvectors(), make_gvectors())
    theta = torch.tensor([[0.1, -0.4, 0.3], [0.5, 0.2, -0.6]])
    R = gen_grid.rotation(theta)
    assert torch.allclose(R @ R.transpose(1, 2), torch.eye(3).expand(2, 3, 3),
                          atol=1e-6)
    assert torch.allclose(R, fit.rotation(theta), atol=0)


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 1])
def test_fit_reference_matches_fit_grid(seed):
    g = torch.from_numpy(gen_grid.gvectors())
    truth, y = gen_grid.observations(3000, g, torch.Generator().manual_seed(
        seed))
    theta0 = torch.zeros(3000, 3)
    got = fit_grid(y, g, theta0, iters=12, device="cpu")
    want = fit.fit_blocks(y, g, theta0, 12, 1e-3, block=1000)
    gap = (fit.rotation(got) - fit.rotation(want)).abs().amax(dim=(1, 2))
    assert float(torch.quantile(gap, 0.99)) < 1e-6
    recovered = (fit.rotation(want) - fit.rotation(truth)).abs().amax(
        dim=(1, 2)) < 0.05
    assert float(recovered.float().mean()) > 0.8


def test_analytic_jacobian_matches_autograd():
    g = torch.from_numpy(gen_grid.gvectors()).double()
    theta = torch.tensor([[0.2, -0.1, 0.4], [-0.5, 0.3, 0.1]],
                         dtype=torch.float64)
    _, J = fit.model_and_jacobian(theta, g)
    for p in range(2):
        auto = torch.autograd.functional.jacobian(
            lambda t: gen_grid.signature(t[None], g)[0], theta[p])
        assert torch.allclose(J[p], auto, atol=1e-10)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 3.0])
    assert fit.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
