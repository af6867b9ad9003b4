"""The inverse cell's kernels' share of their roofline: the least time
the traced slice's Adam iterations need (cell updates x 21 FLOP over the
FLOP rate, ``yardstick_inverse``, or the iteration's six grids over the
bandwidth, the larger) over the device time of every kernel in the
slice."""

from portbench.metrics._roofline import roofline_pct

UNIT = "%"


def read(ctx):
    return roofline_pct(ctx, "inverse")
