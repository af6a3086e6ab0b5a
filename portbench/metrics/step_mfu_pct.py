"""The whole step's share of the chip's roofline peak, in %: the least
time of the traced window's steps (counts/roofline.step_least_seconds:
the state at its stored dtypes read and written once a step and once
more on a rebuild, and the pair operations over the pairs inside the
support) over the traced window's wall time."""

from portbench.counts import roofline


def read(ctx):
    if not ctx.trace or not ctx.trace.ops or ctx.trace_pairs <= 0 or ctx.trace_steps <= 0:
        return None
    least = roofline.step_least_seconds(ctx.conf, ctx.n, ctx.trace_pairs,
                                        ctx.trace_steps, ctx.trace_rebuilds)
    return 100.0 * least / ctx.trace_window_s
