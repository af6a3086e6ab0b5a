"""Host syncs a step: the calls in which the host waited for the device's
queue to drain (``cudaStreamSynchronize`` and the like, as the profiler's
runtime trace records them) begun inside the program's spans in the traced
window, over the window's steps (``spans.py``). On the card they are as
many as ``torch.cuda.set_sync_debug_mode("warn")`` warns of."""

from portbench import spans


def read(ctx):
    tr = ctx.trace
    if not tr or not tr.ops or ctx.trace_steps <= 0 or not spans.intervals(tr):
        return None
    return spans.syncs(tr) / ctx.trace_steps
