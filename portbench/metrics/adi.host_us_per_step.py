"""Host time of one ADI step, in us: the program's spans ``adi.half_x``
and ``adi.half_y`` (each half's right-hand side, its solve's launch and
the held edges), over the entries of ``adi.half_x``; the note gives each
half's share."""

from portbench.metrics._spans import count, seconds, shares, spans

UNIT = "us"
PARTS = ("adi.half_x", "adi.half_y")


def read(ctx):
    if ctx.get("kind") != "adi":
        return None
    got = spans()
    n = count(got, "adi.half_x")
    if not n:
        return None
    return (1e6 * seconds(got, PARTS) / n,
            f"over {n:g} steps: " + shares(got, PARTS, n, 1e6, "us"))
