"""Particles times steps completed in the window, over the window's
host-clock seconds (the window ends in a device synchronize), in millions."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.steps == 0:
        return None
    return ctx.n * ctx.steps / ctx.window_s / 1e6
