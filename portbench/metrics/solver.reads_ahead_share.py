"""Share of the convergence residual's host reads that the solver loop
took with the next chunk already issued, in %: the program's counters
``solver_reads_ahead_total`` over ``solver_residual_reads_total``
(``models/engine.py``'s one-chunk pipeline), over every solve of the
process, the warm-up's included; the note gives the speculative chunks
dropped at a stop (``solver_chunks_discarded_total``). Only where the
convergence check is on; empty where the program keeps no such
counters."""

UNIT = "%"


def _total(reg, name: str):
    got = reg.find_counters(name)
    return sum(got.values()) if got else None


def read(ctx):
    if ctx.get("kind") != "solve" or not ctx.get("convergence"):
        return None
    try:
        from heat2d_tpu_torch.obs import get_registry
        reg = get_registry()
        reads = _total(reg, "solver_residual_reads_total")
        ahead = _total(reg, "solver_reads_ahead_total")
        dropped = _total(reg, "solver_chunks_discarded_total")
    except (ImportError, AttributeError):
        return None
    if not reads or ahead is None:
        return None
    return (100.0 * ahead / reads,
            f"{ahead:g} of {reads:g} reads with the next chunk issued; "
            f"{dropped or 0:g} speculative chunks dropped at a stop")
