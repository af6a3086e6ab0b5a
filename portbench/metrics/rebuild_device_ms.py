"""Device time a rebuild, in ms: the operations launched inside the
harness's span around solver._rebuild in the traced window, over the
rebuilds there."""

from portbench import trace


def read(ctx):
    tr = ctx.trace
    count = tr.spans.get("rebuild", 0) if tr else 0
    ms = 1e3 * trace.device_seconds(tr, "rebuild") if count else 0.0
    return ms / count if ms > 0 else None
