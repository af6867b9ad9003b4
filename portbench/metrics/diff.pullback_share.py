"""Share of an Adam iteration's host time spent in the backward, in %:
the program's spans ``diff.recompute`` and ``diff.pullback`` (one entry
a segment each) over ``inverse.iteration`` (one entry an iteration), in
the traced slice; the note gives each span's time an iteration and
``diff.forward``'s. Empty where the program has no such spans."""

from portbench.metrics._spans import count, seconds, shares, spans

UNIT = "%"
PARTS = ("diff.forward", "diff.recompute", "diff.pullback")


def read(ctx):
    if ctx.get("kind") != "inverse":
        return None
    got = spans()
    n = count(got, "inverse.iteration")
    total = seconds(got, ("inverse.iteration",))
    if not n or total <= 0:
        return None
    back = seconds(got, ("diff.recompute", "diff.pullback"))
    return (100.0 * back / total,
            f"over {n:g} iterations of {1e3 * total / n:.6g} ms: "
            + shares(got, PARTS, n, 1e3, "ms"))
