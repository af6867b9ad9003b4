"""Share of the ADI step loop's halves that ran as one launch each, in %:
the program's counters ``adi_halves_fused_total`` over
``adi_halves_total`` (``ops/tridiag.py``: a half's right-hand side and
held edges inside H10's or H11's right-hand-side build), over every
solve of the process, the warm-up's included. Only in the ADI cell;
empty where the program keeps no such counters."""

UNIT = "%"


def _total(reg, name: str):
    got = reg.find_counters(name)
    return sum(got.values()) if got else None


def read(ctx):
    if ctx.get("kind") != "adi":
        return None
    try:
        from heat2d_tpu_torch.obs import get_registry
        reg = get_registry()
        halves = _total(reg, "adi_halves_total")
        fused = _total(reg, "adi_halves_fused_total")
    except (ImportError, AttributeError):
        return None
    if not halves or fused is None:
        return None
    return (100.0 * fused / halves,
            f"{fused:g} of {halves:g} halves one launch each")
