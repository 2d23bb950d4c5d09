"""CUDA kernels a ``fit_grid`` call launches, averaged over the traced
calls."""
UNIT, SOURCE = "kernels", "device_trace"
LAYER = "stage 2: hedm.pipeline.fit_grid"


def read(run):
    if run.trace is None:
        return None
    calls = run.trace.within(run.requests, "fit_grid")
    return sum(len(ops) for _, ops in calls) / len(calls) if calls else None
