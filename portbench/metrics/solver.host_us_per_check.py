"""Host time a convergence check costs apart from its wait, in us: the
program's span ``solve.launch`` (the runner's whole call) less its
``solver.residual_read`` spans (each blocking read of a residual), over
the reads; the card waits for the host that long after each chunk.
Only where the convergence check is on."""

from portbench.metrics._spans import count, seconds, spans

UNIT = "us"


def read(ctx):
    if ctx.get("kind") != "solve" or not ctx.get("convergence"):
        return None
    got = spans()
    reads = count(got, "solver.residual_read")
    solves = count(got, "solve.launch")
    if not reads or not solves:
        return None
    wait = seconds(got, ("solver.residual_read",))
    host = seconds(got, ("solve.launch",)) - wait
    return (1e6 * host / reads,
            f"over {reads:g} reads in {solves:g} solves: the reads' wait "
            f"{1e3 * wait / solves:.6g} ms a solve, the rest of the "
            f"launch {1e3 * host / solves:.6g} ms a solve")
