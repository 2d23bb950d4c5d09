"""The KDA decode's share of its byte bound: the least time of the traced
window's decode steps' KDA bytes (the port's ``serve.kda_state_bytes``
counter, which the loop copies into ``kda_state_bytes``: a step's float32
state read and written once a slot and layer, and the KDA weights once)
at ``roofline.HBM_BYTES_PER_S``, over the device seconds of the
``serve.decode.kda`` spans (CUDA events around each KDA layer's mixer)."""
from portbench import roofline

UNIT, SOURCE = "%", "program_span"
LAYER = "serve: models.kda"


def read(run):
    t = run.timings or {}
    if not t.get("kda_device_s") or not t.get("kda_state_bytes"):
        return None
    return (100.0 * t["kda_state_bytes"] / roofline.HBM_BYTES_PER_S
            / t["kda_device_s"])
