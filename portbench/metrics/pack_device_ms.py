"""Device time of a rebuild's pack (``rcll.pack_state``: the counting
sort, its ``bincount``s, the packed table), in ms: the operations launched
inside the program's ``sph.rebuild.pack`` spans in the traced window, over
its ``sph.rebuild`` spans (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx.trace, "sph.rebuild.pack", "sph.rebuild")
