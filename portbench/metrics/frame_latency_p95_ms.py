"""95th percentile of every frame's latency in the window, from the frame's
due time in the open-loop schedule to its reduced frame on the host; the
nearest rank, so always a frame's own latency."""
import math

UNIT, SOURCE = "ms", "host_clock"


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def read(run):
    lat = [(r.done - r.due) * 1e3 for r in run.requests]
    return percentile(lat, 95) if lat else None
