"""Device time a force pass (K1, K2, the update and the advance), in ms:
the operations launched inside the harness's span around
solver._physics_step in the traced window, over the steps there."""

from portbench import trace


def read(ctx):
    tr = ctx.trace
    count = tr.spans.get("physics", 0) if tr else 0
    ms = 1e3 * trace.device_seconds(tr, "physics") if count else 0.0
    return ms / count if ms > 0 else None
