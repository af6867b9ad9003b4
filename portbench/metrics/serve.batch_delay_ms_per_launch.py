"""Time the scheduler waits a launch for a partial bucket to age toward
the batcher's ``max_delay``, in ms: the program's span
``serve.batcher.wait_delay`` over the ``serve.dispatch`` spans of the
traced slice; the note gives its waits with nothing queued
(``serve.batcher.wait_empty``) too."""

from portbench.metrics._spans import count, seconds, spans

UNIT = "ms"


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    got = spans()
    n = count(got, "serve.dispatch")
    if not n:
        return None
    delay = seconds(got, ("serve.batcher.wait_delay",))
    empty = seconds(got, ("serve.batcher.wait_empty",))
    return (1e3 * delay / n,
            f"over {n:g} launches: wait_delay {1e3 * delay / n:.6g} ms "
            f"({count(got, 'serve.batcher.wait_delay'):g} waits), "
            f"wait_empty {1e3 * empty / n:.6g} ms "
            f"({count(got, 'serve.batcher.wait_empty'):g} waits)")
