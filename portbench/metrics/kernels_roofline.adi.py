"""The ADI cell's kernels' share of their roofline: the least time the
traced slice's solves need (cell updates x 18 FLOP over the FLOP rate,
``yardstick_adi``, or each solve's input and output grid over the
bandwidth, the larger) over the device time of every kernel in the
slice."""

from portbench.metrics._roofline import roofline_pct

UNIT = "%"


def read(ctx):
    return roofline_pct(ctx, "adi")
