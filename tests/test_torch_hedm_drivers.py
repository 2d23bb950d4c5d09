"""The port's streamed and multi-session NF-HEDM drivers against the
reference's runners.

``repro_torch.hedm.streaming.main`` and ``repro_torch.hedm.service.main``
run on the CPU (the filter as its plain version) over the numpy scans of
``examples/hedm_streaming.py`` and ``examples/hedm_service.py``; the
reference's ``run_batch_hedm``, ``run_online_hedm`` and
``run_interactive_hedm`` run over the same scans with the examples'
settings. The packed stage-1 bytes and every simulated time must be equal.
"""
import pytest
import torch

import repro.core.fabric as J_fabric
import repro.hedm.pipeline as J
from repro.core.api import StagingClient as J_StagingClient
from repro.core.streaming import StreamScenario as J_StreamScenario
from repro_torch.hedm import pipeline as T
from repro_torch.hedm import service, streaming
from torch_parity import plain

CPU = "cpu"


@pytest.mark.parametrize("n_frames,size", [(32, 128), (20, 128), (16, 64)])
def test_streaming_driver_matches_reference(n_frames, size):
    """The example's scan, one with a short last window, and a smaller
    one."""
    out = streaming.main(device=CPU, n_frames=n_frames, frame_size=size,
                         verbose=False)
    sc = J_StreamScenario(n_hosts=64, n_frames=n_frames, frame_size=size,
                          n_spots=8, rate_hz=4.0, window_frames=8,
                          cache_frames=16)
    frames, dark = sc.make_frames()
    batch, t_batch, _ = J.run_batch_hedm(
        sc.make_fabric(), frames, dark, rate_hz=sc.rate_hz, use_kernel=False,
        reduce_time_per_frame=streaming.REDUCE_S_PER_FRAME)
    online = J.run_online_hedm(
        sc.make_fabric(), frames, dark, rate_hz=sc.rate_hz,
        window=sc.window_frames, use_kernel=False,
        cache_frames=sc.cache_frames,
        reduce_time_per_frame=streaming.REDUCE_S_PER_FRAME)
    ref = J.pack_reduced(online.reduced)
    assert ref.tobytes() == J.pack_reduced(batch).tobytes()
    assert out["packed"].tobytes() == ref.tobytes()
    assert out["batch_turnaround_s"] == t_batch
    assert out["online_turnaround_s"] == online.turnaround
    assert out["window_done"] == online.window_done
    assert out["first_result_s"] == online.window_done[0]
    assert plain(out["stream"]) == plain(online.stream)
    assert out["n_spots"] == sum(r.n_spots for r in online.reduced)
    assert out["online_turnaround_s"] < out["batch_turnaround_s"]


def _reference_service(n_frames, size):
    """The reference example's run, with its late session."""
    scans, dark = {}, None
    for i, name in enumerate(service.SCANS):
        scans[name], dark = J.simulate_detector_frames(n_frames, size=size,
                                                       n_spots=6, seed=i)
    budget = 2 * n_frames * size * size * 4 + 1024
    fab = J_fabric.Fabric(n_hosts=64, constants=J_fabric.BGQ)
    scripts = [J.SessionScript(s.name, s.datasets, s.t_start)
               for s in service.sessions()]
    res = J.run_interactive_hedm(fab, scans, dark, scripts, budget)
    client = J_StagingClient(fab, service=res.service)
    t_late = res.turnaround + 1.0
    with client.session("emma") as emma:
        lease = emma.acquire("scanA", t_late)
    late = {"t_late": t_late, "t_ready": lease.t_ready,
            "hit": lease.t_ready == t_late,
            "lease_count": res.service.catalog["scanA"].lease_count}
    return res, late


@pytest.mark.parametrize("n_frames,size", [(16, 128), (6, 64)])
def test_service_driver_matches_reference(n_frames, size):
    out = service.main(device=CPU, n_frames=n_frames, frame_size=size,
                       verbose=False)
    res, late = _reference_service(n_frames, size)
    assert plain(out["outputs"]) == plain(res.outputs)
    assert out["turnaround_s"] == res.turnaround
    assert out["session_done"] == res.session_done
    assert plain(out["stats"]) == plain(res.service.stats)
    assert out["late"] == late and late["lease_count"] == 0
    assert out["n_outputs"] == 12
    assert res.service.stats.evictions > 0      # the budget bites


def test_drivers_reduce_once_a_window_and_once_a_scan(monkeypatch):
    """One ``reduce_frames`` call a reduce window and one a batch or direct
    reduction: on a card, one ``hedm_reduce`` launch each."""
    calls = []
    real = T.reduce_frames

    def counting(frames, *a, **k):
        calls.append(len(frames))
        return real(frames, *a, **k)
    monkeypatch.setattr(T, "reduce_frames", counting)
    monkeypatch.setattr(service, "reduce_frames", counting)
    streaming.main(device=CPU, verbose=False)
    assert calls == [32] + [8] * 4
    calls.clear()
    service.main(device=CPU, n_frames=4, frame_size=32, verbose=False)
    assert calls == [4] * (4 * 3 + 3)


@pytest.mark.parametrize("driver", [streaming.main, service.main],
                         ids=["streaming", "service"])
def test_drivers_default_to_the_card(driver, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver(verbose=False)
