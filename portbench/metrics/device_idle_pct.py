"""Share of the traced window's wall time with no operation on the
device, in %."""

from portbench import trace


def read(ctx):
    if not ctx.trace or not ctx.trace.ops or ctx.trace_window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / ctx.trace_window_s)
