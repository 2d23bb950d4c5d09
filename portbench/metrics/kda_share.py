"""The KDA layers' share of the decode step on the card: the device
seconds of the ``serve.decode.kda`` spans over those of their
``serve.decode`` steps, over the window."""
UNIT, SOURCE = "%", "program_span"
LAYER = "serve: models.kda"


def read(run):
    t = run.timings or {}
    if not t.get("kda_device_s") or not t.get("decode_device_s"):
        return None
    return 100.0 * t["kda_device_s"] / t["decode_device_s"]
