"""Host time a solve spends around its run, in ms: the program's spans
``solve.construct`` (the solver), ``solve.prepare`` (its runner and
initial grid) and ``solve.gather`` (the final grid to the host and its
crop), over the solves gathered in the traced slice."""

from portbench.metrics._spans import count, seconds, shares, spans

UNIT = "ms"
PARTS = ("solve.construct", "solve.prepare", "solve.gather")


def read(ctx):
    if ctx.get("kind") != "solve":
        return None
    got = spans()
    n = count(got, "solve.gather")
    if not n:
        return None
    return (1e3 * seconds(got, PARTS) / n,
            f"over {n:g} solves: " + shares(got, PARTS, n, 1e3, "ms"))
