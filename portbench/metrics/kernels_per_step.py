"""CUDA kernels an engine step launches, averaged over the traced
steps."""
UNIT, SOURCE = "kernels", "device_trace"
LAYER = "serve: serve.engine.ServeSession"


def read(run):
    if run.trace is None:
        return None
    steps = run.trace.within(run.requests, "step")
    return sum(len(ops) for _, ops in steps) / len(steps) if steps else None
