"""Host time of one step of the pullback, in us: the program's span
``diff.pullback`` (one entry a segment of the backward) over the steps
those entries pulled back, in the traced slice: the configuration's
``steps`` for each entry of ``inverse.iteration`` (an Adam iteration
pulls the whole solve back once). Empty where the program keeps no such
spans."""

from portbench.metrics._spans import count, seconds, spans

UNIT = "us"


def read(ctx):
    if ctx.get("kind") != "inverse":
        return None
    got = spans()
    steps = ctx["steps"] * count(got, "inverse.iteration")
    if not steps or not count(got, "diff.pullback"):
        return None
    return (1e6 * seconds(got, ("diff.pullback",)) / steps,
            f"over {steps:g} steps in {count(got, 'diff.pullback'):g} "
            f"segments")
