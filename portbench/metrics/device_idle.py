"""Share of the traced window in which no kernel ran on the card (copies
and fills do not count as kernels)."""
UNIT, SOURCE, LAYER = "%", "device_trace", "device"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(("kernel",)) / run.trace.window_s)
