"""Host-to-device rate of stage 1: the frame and dark bytes handed to
``reduce_frames`` over its ``h2d`` phase seconds, in 1e9 bytes a second."""
UNIT, SOURCE = "GB/s", "program_span"
LAYER = "stage 1: hedm.pipeline.reduce_frames"


def read(run):
    t = (run.timings or {}).get("h2d", 0.0)
    moved = sum(r.meta.get("bytes_in", 0) for r in run.requests if r.ok)
    return moved / t / 1e9 if t > 0 and moved else None
