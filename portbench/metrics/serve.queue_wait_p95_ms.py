"""The 95th percentile of the batcher's ``serve_queue_wait_s`` (a
request's admission to its launch's dispatch) over the window, in ms."""

from portbench import yardstick

UNIT = "ms"


def read(ctx):
    waits = ctx.get("queue_wait_s")
    if ctx.get("kind") != "serve" or not waits:
        return None
    return 1e3 * yardstick.percentile_missing_inf(waits, 95.0)
