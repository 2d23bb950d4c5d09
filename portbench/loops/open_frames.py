"""Open loop of single frames at a fixed cadence, frames in order: frame
``i`` is due ``i / rate_hz`` seconds after the window opens, and is sent
then or, when the last call is still running, as soon as it returns. A
frame's latency runs from its due time to its reduced frame on the host.
Every frame due in the window is answered and counted, also those that a
backlog pushes past its end.

Mix parameters: ``rate_hz``.
"""
from __future__ import annotations

from portbench.loops.closed_windows import (Layer, call, judge,  # noqa: F401
                                            prepare, warmup)


def window(sess, layer: Layer) -> None:
    rate = float(sess.run.cell.traffic["rate_hz"])
    n = layer.frames.shape[0]
    t0 = sess.start()
    prev_done = t0
    i = 0
    while True:
        due = t0 + i / rate
        if due >= sess.t_end:
            break
        sess.wait_until(due)
        call(sess, layer, i % n, due=due)
        req = sess.run.requests[-1]
        sess.run.lateness.append(max(0.0, req.sent - max(due, prev_done)))
        prev_done = req.done
        i += 1
