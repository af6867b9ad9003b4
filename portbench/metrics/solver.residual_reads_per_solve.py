"""Host reads of the convergence residual a solve made
(``RunResult.residual_reads``), the mean over the window's solves; only
where the convergence check is on."""

UNIT = "count"


def read(ctx):
    reads = ctx.get("residual_reads")
    if ctx.get("kind") != "solve" or not ctx.get("convergence") or not reads:
        return None
    return sum(reads) / len(reads)
