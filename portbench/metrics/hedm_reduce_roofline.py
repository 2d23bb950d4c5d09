"""The stage-1 filter kernel's share of its roofline: the least time of the
traced calls' filters at HBM's rate (``roofline.hedm_reduce_seconds``,
from shapes and dtypes) over the device time of the kernels named
``hedm_reduce`` that ran in those calls. Nothing when no such kernel ran."""
from portbench import roofline

UNIT, SOURCE, LAYER = "%", "device_trace", "kernels: kernels.hedm_reduce"


def read(run):
    if run.trace is None:
        return None
    bound = spent = 0.0
    for req, ops in run.trace.within(run.requests, "reduce_frames",
                                     match="hedm_reduce"):
        if ops:
            m = req.meta
            bound += roofline.hedm_reduce_seconds(
                m["frames"], m["height"], m["width"], m["itemsize"])
            spent += sum(b - a for _, _, a, b in ops)
    return 100.0 * bound / spent if spent > 0 else None
