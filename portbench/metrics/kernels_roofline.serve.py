"""The serving cell's kernels' share of their roofline: the least time
of the requests' members launched in the traced slice (each member's
cell updates and grids, a launch weighted by its share inside the
slice; pad members are not work) over the device time of every kernel
in the slice."""

from portbench.metrics._roofline import roofline_pct

UNIT = "%"


def read(ctx):
    return roofline_pct(ctx, "serve")
