"""``decode_mfu`` for Kimi-Linear: the whole step's model FLOPs
(``kimi_linear_flops.flops``: the held share of the experts, the KDA
state products, MLA over the positions attended) of the engine steps
inside the traced window, over that window's seconds at
``roofline.BF16_FLOPS``."""
from portbench import kimi_linear_flops, roofline

UNIT, SOURCE = "%", "device_trace"
LAYER = "serve: serve.engine.ServeSession"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    steps = [r for r in run.requests if r.name == "step" and r.ok
             and tr.t0 <= r.sent and r.done <= tr.t1]
    if not steps:
        return None
    work = sum(kimi_linear_flops.flops(run.cell.config, r.meta["processed"],
                                       r.meta["attended"]) for r in steps)
    return 100.0 * work / (tr.window_s * roofline.BF16_FLOPS)
