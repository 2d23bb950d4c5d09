"""Grid points whose fitted orientations came back to the host in the
window, over the window: from the first request sent to the last answer."""
UNIT, SOURCE = "points/s", "host_clock"


def read(run):
    done = sum(r.items for r in run.requests if r.ok)
    return done / run.window_s if run.window_s > 0 else None
