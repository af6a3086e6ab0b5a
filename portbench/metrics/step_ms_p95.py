"""The 95th percentile of the host-clock time between step boundaries in
the window, in ms; read where the window holds 200 steps or more, so that
ten or more lie beyond it."""

import math


def read(ctx):
    s = sorted(ctx.step_s)
    if len(s) < 200:
        return None
    return 1e3 * s[math.ceil(0.95 * len(s)) - 1]
