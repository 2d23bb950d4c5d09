"""Stage 2's share of its roofline: the least time of the traced fits
(``roofline.fit_seconds``: the larger of their counted FLOPs at the fp32
peak and their bytes at HBM's) over the device time of the kernels that
ran in those calls."""
from portbench import roofline

UNIT, SOURCE, LAYER = "%", "device_trace", "stage 2: hedm.pipeline.fit_grid"


def read(run):
    if run.trace is None:
        return None
    bound = spent = 0.0
    for req, ops in run.trace.within(run.requests, "fit_grid"):
        if ops:
            m = req.meta
            bound += roofline.fit_seconds(m["points"], m["n_gvec"],
                                          m["iters"])
            spent += sum(b - a for _, _, a, b in ops)
    return 100.0 * bound / spent if spent > 0 else None
