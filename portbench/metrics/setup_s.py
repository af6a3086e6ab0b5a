"""Seconds from the start of the process to the start of the window:
imports, loading the kernel library, the inputs, init_persistent and the
warm-up. The library's nvcc build, on a checkout's first run, is left
out and printed on its own line."""


def read(ctx):
    return ctx.setup_seconds
