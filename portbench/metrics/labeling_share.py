"""Share of stage 1's time spent labeling and taking centroids on the host:
``labeling`` over the sum of ``h2d``, ``kernel``, ``d2h`` and ``labeling``
of ``reduce_frames``' own phase clock (host clock after a synchronise),
summed over the traced run's window."""
UNIT, SOURCE = "%", "program_span"
LAYER = "stage 1: hedm.pipeline.reduce_frames"
PHASES = ("h2d", "kernel", "d2h", "labeling")


def read(run):
    t = run.timings or {}
    total = sum(t.get(p, 0.0) for p in PHASES)
    return 100.0 * t["labeling"] / total if total > 0 and "labeling" in t \
        else None
