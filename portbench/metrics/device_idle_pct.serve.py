"""The share of the traced slice in which no operation ran on the card,
in the serving cell."""

from portbench.metrics._roofline import idle_pct

UNIT = "%"


def read(ctx):
    return idle_pct(ctx, "serve")
