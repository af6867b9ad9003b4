"""The share of the inverse cell's traced slice in which no operation
ran on the card (the mean over the cell's cards; each card's is
noted)."""

from portbench.metrics._roofline import idle_pct

UNIT = "%"


def read(ctx):
    return idle_pct(ctx, "inverse")
