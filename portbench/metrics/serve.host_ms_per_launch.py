"""The scheduler thread's host time a launch, in ms, outside the run:
the program's spans ``serve.engine.prepare`` (batch, pads, runner),
``serve.engine.readback`` (members to the host),
``serve.engine.account`` (the launch row and counters) and
``serve.resolve`` (cache and futures, the clients' callbacks), over the
``serve.dispatch`` spans of the traced slice."""

from portbench.metrics._spans import count, seconds, shares, spans

UNIT = "ms"
PARTS = ("serve.engine.prepare", "serve.engine.readback",
         "serve.engine.account", "serve.resolve")


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    got = spans()
    n = count(got, "serve.dispatch")
    if not n:
        return None
    return (1e3 * seconds(got, PARTS) / n,
            f"over {n:g} launches: " + shares(got, PARTS, n, 1e3, "ms"))
