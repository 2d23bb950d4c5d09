"""The port on the card: the CUDA kernel against its plain version, and the
pipeline's stages on the card against the CPU.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernel has no CPU
mode) and skips without one. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the reference package; the plain version
it holds the kernel to is itself held bit-exact to the reference on the CPU
(``tests/test_torch_hedm_reduce.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.hedm import pipeline as T
from repro_torch.kernels import hedm_reduce as port
from repro_torch.kernels.ops import hedm_reduce
from torch_parity import HEDM_REDUCE_CASES as CASES

pytestmark = pytest.mark.cuda


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


def test_kernel_rejects_non_contiguous_input(card):
    f = torch.zeros(2, 16, 32, device=card)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        hedm_reduce(f, torch.zeros(16, 16, device=card), 100.0)


def test_stage1_on_card_equals_cpu(card):
    frames, dark = T.simulate_detector_frames(4, size=192, n_spots=8, seed=6)
    on_card = T.reduce_frames(frames, dark, device=card)
    on_cpu = T.reduce_frames(frames, dark, device="cpu")
    assert sum(r.n_spots for r in on_card) >= 4
    assert T.pack_reduced(on_card).tobytes() == \
        T.pack_reduced(on_cpu).tobytes()


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
