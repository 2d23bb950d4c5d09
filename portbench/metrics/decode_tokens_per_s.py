"""Tokens the serving session returned to the host in the window (each
request's first token, from its prefill, included), over the window: from
the first engine step sent to the last one's answer."""
UNIT, SOURCE = "tokens/s", "host_clock"


def read(run):
    done = sum(r.items for r in run.requests if r.ok)
    return done / run.window_s if run.window_s > 0 else None
