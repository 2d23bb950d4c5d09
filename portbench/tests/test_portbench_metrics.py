"""The metric arithmetic: rates over all the work and all the time of the
window, a percentile over every request, phase shares from the program's
clock, and the device readings from a trace."""
import pytest

from portbench import harness, roofline
from portbench.trace import DeviceTrace, union


def _run(requests, cell_name="nf-f32.stage1", **kw):
    cell = harness.find_cell(cell_name)
    run = harness.Run(cell=cell, seconds=10.0,
                      setup_s=12.5, **kw)
    run.requests = [harness.Request(*r) for r in requests]
    run.t0 = min(r.sent for r in run.requests)
    run.t1 = max(r.done for r in run.requests)
    return run


def read(name, run):
    return harness.find_module("metrics", name).read(run)


def test_rate_is_all_the_work_over_all_the_time():
    reqs = [("reduce_frames", t, t, t + 0.5, 8) for t in (0.0, 0.5, 1.0)]
    reqs.append(("reduce_frames", 1.5, 1.5, 4.0, 8))     # one slow call
    assert read("frames_per_s", _run(reqs)) == pytest.approx(32 / 4.0)
    failed = _run(reqs)
    failed.requests[0].ok = False
    assert read("frames_per_s", failed) == pytest.approx(24 / 4.0)


def test_points_per_s():
    reqs = [("fit_grid", 0.0, 0.0, 0.2, 100_000),
            ("fit_grid", 0.2, 0.2, 0.5, 100_000)]
    assert read("points_per_s", _run(reqs, "nf-f32.refit")) == \
        pytest.approx(400_000)


def test_p95_is_over_every_request_and_a_stall_moves_it():
    steady = [("reduce_frames", i * 0.2, i * 0.2, i * 0.2 + 0.1, 1)
              for i in range(200)]
    assert read("frame_latency_p95_ms", _run(steady, "nf-u16.frame1")) == \
        pytest.approx(100.0)
    # a 2 s stall at frame 100: the frames due during it wait (from due)
    stalled, free = [], 0.0
    for i in range(200):
        due = i * 0.2
        sent = max(due, free)
        free = sent + (2.0 if i == 100 else 0.1)
        stalled.append(("reduce_frames", due, sent, free, 1))
    p95 = read("frame_latency_p95_ms", _run(stalled, "nf-u16.frame1"))
    assert p95 > 1000.0


def test_nearest_rank_percentile():
    pct = harness.find_module("metrics", "frame_latency_p95_ms").percentile
    values = list(range(1, 201))
    assert pct(values, 95) == 190 and pct(values, 50) == 100
    assert pct([7.0], 95) == 7.0


def test_setup_s_is_the_runs():
    run = _run([("reduce_frames", 0.0, 0.0, 1.0, 8)])
    assert read("setup_s", run) == 12.5


def test_phase_shares_and_rate_from_the_programs_clock():
    run = _run([("reduce_frames", 0.0, 0.0, 1.0, 8, {"bytes_in": 4e9})],
               timings={"h2d": 1.0, "kernel": 0.5, "d2h": 0.5,
                        "labeling": 8.0})
    assert read("labeling_share.stage1", run) == pytest.approx(80.0)
    assert read("h2d_GBps.stage1", run) == pytest.approx(4.0)
    bare = _run([("reduce_frames", 0.0, 0.0, 1.0, 8)])
    assert read("labeling_share.stage1", bare) is None
    assert read("h2d_GBps.stage1", bare) is None


def test_device_readings_from_a_trace():
    meta = {"frames": 8, "height": 2048, "width": 2048, "itemsize": 4}
    run = _run([("reduce_frames", 0.0, 0.0, 0.4, 8, meta),
                ("reduce_frames", 0.4, 0.4, 0.8, 8, meta)])
    k1 = roofline.hedm_reduce_seconds(8, 2048, 2048, 4)
    run.trace = DeviceTrace(0.0, 1.0, [
        ("Memcpy HtoD (Pageable -> Device)", "memcpy", 0.01, 0.05),
        ("hedm_reduce_kernel<float>", "kernel", 0.06, 0.06 + 2 * k1),
        ("fill", "kernel", 0.059, 0.0595),
        ("hedm_reduce_kernel<float>", "kernel", 0.46, 0.46 + 2 * k1)])
    assert read("hedm_reduce_roofline", run) == pytest.approx(50.0)
    busy = 4 * k1 + 0.0005
    assert read("device_idle.stage1", run) == pytest.approx(
        100 * (1 - busy))
    assert run.trace.busy_s() == pytest.approx(busy + 0.04)
    bd = run.trace.breakdown(run.spans + [("reduce_frames", 0.0, 0.4),
                                          ("reduce_frames", 0.4, 0.6)])
    assert bd["device_ops"][0][0] == "Memcpy HtoD (Pageable -> Device)"
    hosts = dict(bd["idle_gaps"])
    assert set(hosts) == {"reduce_frames", "harness"}
    assert sum(hosts.values()) == pytest.approx(1.0 - run.trace.busy_s())


def test_device_readings_without_a_kernel_are_absent():
    run = _run([("reduce_frames", 0.0, 0.0, 0.4, 8,
                 {"frames": 8, "height": 64, "width": 64, "itemsize": 4})])
    assert read("hedm_reduce_roofline", run) is None
    run.trace = DeviceTrace(0.0, 1.0, [("Memcpy HtoD", "memcpy", 0.1, 0.2)])
    assert read("hedm_reduce_roofline", run) is None
    assert read("device_idle.stage1", run) == pytest.approx(100.0)


def test_fit_readings_from_a_trace():
    meta = {"points": 100_000, "n_gvec": 24, "iters": 12}
    run = _run([("fit_grid", 0.0, 0.0, 0.1, 100_000, meta),
                ("fit_grid", 0.1, 0.1, 0.2, 100_000, meta)], "nf-f32.refit")
    ops = [(f"k{i}", "kernel", 0.001 * i, 0.001 * i + 0.0004)
           for i in range(200)]
    run.trace = DeviceTrace(0.0, 0.2, ops)
    assert read("kernels_per_fit.refit", run) == pytest.approx(100)
    bound = roofline.fit_seconds(100_000, 24, 12)
    assert read("fit_grid_roofline", run) == pytest.approx(
        100 * bound / 0.04)
    assert read("device_idle.refit", run) == pytest.approx(60.0)


def test_roofline_counts():
    assert roofline.hedm_reduce_bytes(736, 2048, 2048, 4) == \
        736 * 2048 * 2048 * 5 + 2048 * 2048 * 4 + 736 * 4
    assert roofline.hedm_reduce_bytes(1, 2048, 2048, 2) == \
        2048 * 2048 * 3 + 2048 * 2048 * 4 + 4
    assert roofline.fit_flops_per_iteration(24) == 132 * 24 + 412
    # 4.30 GFLOP at 67 TFLOP/s outweighs 21.6 MB at 3.35 TB/s
    assert roofline.fit_seconds(100_000, 24, 12) == pytest.approx(
        100_000 * 12 * 3580 / 67e12)


def test_union_merges_overlaps():
    assert union([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]
