"""Device idle time inside a rebuild, in ms: the time within the host
intervals of the program's ``sph.rebuild`` spans in the traced window in
which no operation ran on the device, over those spans (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms_per(ctx.trace, "sph.rebuild")
