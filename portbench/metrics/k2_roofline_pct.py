"""K2's share of its roofline, in %: the least time of one force pass
(counts/roofline.force_least_seconds: the pairs inside the support that
the reference counted on the traced window's first input, each field
read once and drho and the acceleration written once) over K2's device
time a pass, taken by its kernels' names (csrc/rcll_force.cu) among the
operations of the force pass's span."""

from portbench import trace
from portbench.counts import roofline

#: The kernels of K2: its staging pass and its force pass.
K2_KERNELS = ("stage_kernel", "force_kernel")


def read(ctx):
    tr = ctx.trace
    count = tr.spans.get("physics", 0) if tr else 0
    k2 = trace.device_seconds(tr, "physics", K2_KERNELS) / count if count else 0.0
    if k2 <= 0 or ctx.trace_pairs <= 0:
        return None
    return 100.0 * roofline.force_least_seconds(ctx.conf, ctx.n, ctx.trace_pairs) / k2
