"""Set-up: process start to the first timed request (CUDA's start, the
kernels' build or load, the inputs made from the seed, the warm-up)."""
UNIT, SOURCE = "s", "host_clock"


def read(run):
    return run.setup_s
