"""Device time of a rebuild's permutation (the ``cell_xy`` clone and the
one-gather ``_permute_state_fused``), in ms: the operations launched inside
the program's ``sph.rebuild.permute`` spans in the traced window, over its
``sph.rebuild`` spans (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx.trace, "sph.rebuild.permute", "sph.rebuild")
