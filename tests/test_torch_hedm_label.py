"""``repro_torch.kernels.hedm_label`` on the CPU: the host algorithm (the
reference that the CUDA labeler is held to, ``tests/test_torch_cuda.py``)
against a pixel-by-pixel oracle on every mask kind, and what the wrapper
decides before it launches: its chunks, its scratch and its checks."""
import numpy as np
import pytest
import torch

from repro_torch.hedm import pipeline as T
from repro_torch.kernels import hedm_label as HL
from torch_parity import LABEL_MASKS, label_frames, label_mask

SHAPES = [(3, 37, 29), (2, 1, 40), (2, 40, 1)]


def _oracle(mask, frames):
    """Numbering by `_union_find_label`, sums in plain Python floats over
    each spot's pixels in raster order."""
    n_signal, n_spots, peaks = [], [], []
    for m, v in zip(mask, frames):
        labels, n = HL._union_find_label(m > 0)
        n_signal.append(int((m > 0).sum()))
        n_spots.append(n)
        sums = [[0.0, 0.0, 0.0] for _ in range(n)]
        for y, x in zip(*np.nonzero(labels)):
            s, w = sums[labels[y, x] - 1], float(v[y, x])
            s[0] += w
            s[1] += w * float(y)
            s[2] += w * float(x)
        for s_i, s_y, s_x in sums:
            d = max(s_i, 1e-9)
            peaks.append((s_y / d, s_x / d, s_i))
    return (np.array(n_signal, np.int32), np.array(n_spots, np.int32),
            np.array(peaks, np.float32).reshape(-1, 3))


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.float64,
                                   np.int32], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kind", LABEL_MASKS)
def test_reference_matches_the_pixel_oracle(kind, shape, dtype):
    mask = label_mask(kind, *shape, seed=5)
    frames = label_frames(shape, dtype, seed=6)
    got = HL.reference(mask, frames)
    want = _oracle(mask, frames)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_direct_entry_on_the_cpu_is_the_reference():
    mask = label_mask("random-0.05", 4, 33, 20, seed=1)
    frames = label_frames(mask.shape, np.uint16, seed=2)
    got = HL.hedm_label(torch.from_numpy(mask), torch.from_numpy(frames))
    for g, w in zip(got, HL.reference(mask, frames)):
        assert np.array_equal(g, w)
    assert int(got[1].sum()) == len(got[2]) > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32],
                         ids=str)
def test_reduce_frames_host_path_is_the_reference(dtype):
    frames, dark = T.simulate_detector_frames(3, size=64, n_spots=4, seed=3)
    frames = frames.astype(dtype)
    red = T.reduce_frames(frames, dark, device="cpu")
    from repro_torch.kernels.hedm_reduce import reference
    mask, _ = reference(torch.from_numpy(frames.astype(np.float32)),
                        torch.from_numpy(dark), 200.0)
    n_signal, n_spots, peaks = HL.reference(mask.numpy(), frames)
    assert [r.n_signal_pixels for r in red] == n_signal.tolist()
    assert [r.n_spots for r in red] == n_spots.tolist()
    assert np.concatenate([r.peaks for r in red]).tobytes() == \
        peaks.tobytes()


@pytest.mark.parametrize("F,H,W", [(736, 2048, 2048), (8, 2048, 2048),
                                   (1, 2048, 2048), (40, 192, 192),
                                   (3, 8192, 8192), (70000, 1, 1),
                                   (0, 64, 64), (5, 0, 64)])
def test_chunks_cover_the_stack_in_bounded_pieces(F, H, W):
    chunks = HL._chunks(F, H, W)
    if H * W == 0 or F == 0:
        assert chunks == []
        return
    assert chunks[0][0] == 0 and chunks[-1][1] == F
    assert all(a < b and b == c for (a, b), (c, _) in zip(chunks,
                                                         chunks[1:]))
    step = chunks[0][1] - chunks[0][0]
    assert step <= 65535
    assert step == 1 or step * H * W <= HL.CHUNK_PIXELS
    assert all(b - a <= step for a, b in chunks)


def test_uint16_sums_are_exact_at_detector_sizes():
    # a 2048x2048 frame's sums are integers below 2**49; beyond 2**53 the
    # order of summation would show
    assert HL._exact_sums(2048, 2048) and HL._exact_sums(4096, 4096)
    assert 65535 * 2048 * 2048 * 2048 < 1 << 49
    assert not HL._exact_sums(8192, 8192)
    assert not HL._exact_sums(1, 1 << 30)


def test_the_host_labeler_lives_beside_the_kernel():
    # one host algorithm: the pipeline's host path calls the kernel
    # module's labeler
    assert T.label_components is HL.label_components


def test_scratch_holds_a_slot_a_pixel_a_count_a_row_and_four_a_spot():
    # the most 4-connected components of an H x W frame: a checkerboard's
    assert HL.scratch_ints(1, 3, 3) == 9 + 3 + 4 * 5
    assert HL.scratch_ints(8, 2048, 2048) * 4 == 12 * 8 * 2048 * 2048 \
        + 4 * 8 * 2048
    assert int(label_mask("checkerboard", 1, 3, 3).sum()) == 5


def test_direct_entry_checks_its_inputs():
    mask = torch.zeros((2, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one shape"):
        HL.hedm_label(mask, torch.zeros((2, 4, 5)))
    with pytest.raises(TypeError, match="uint8"):
        HL.hedm_label(mask.bool(), torch.zeros((2, 4, 4)))
    with pytest.raises(ValueError, match="unsupported device"):
        HL.label(mask, torch.zeros((2, 4, 4)))
