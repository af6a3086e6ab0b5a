"""torch.cuda.max_memory_allocated() over set-up and window, per particle."""


def read(ctx):
    return ctx.peak_bytes / ctx.n if ctx.peak_bytes > 0 else None
