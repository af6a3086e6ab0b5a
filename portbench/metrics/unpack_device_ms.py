"""Device time of a force pass's unpack (K2's two outputs gathered back
per particle, ``cells.from_cell_major``), in ms: the operations launched
inside the program's ``rcll.unpack`` spans in the traced window, over its
``sph.force`` spans (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx.trace, "rcll.unpack", "sph.force")
