"""Share of the window the session spent prefilling: the seconds of its
own ``timings["prefill"]`` entries (each to the first token on the host)
of the window's steps, over the window."""
UNIT, SOURCE = "%", "program_span"
LAYER = "serve: serve.engine.ServeSession"


def read(run):
    t = (run.timings or {}).get("prefill")
    return 100.0 * t / run.window_s if t and run.window_s > 0 else None
