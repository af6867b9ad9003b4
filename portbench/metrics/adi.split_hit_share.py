"""Share of H10's speculative segments whose join needed no replay, in %:
100 x (1 - ``td_split_replays_total`` / ``td_split_segments_total``), the
program's counters (``ops/tridiag.py``: each split launch counts its
segments past the first of each sweep; the replays are a word on the
card, read into the registry by ``tridiag.collect_split_replays``, which
this reader runs after the window), over every solve of the process, the
warm-up's included. Only in the ADI cell; empty where the program keeps
no such counters or ran no split launch."""

UNIT = "%"


def _total(reg, name: str):
    got = reg.find_counters(name)
    return sum(got.values()) if got else None


def read(ctx):
    if ctx.get("kind") != "adi":
        return None
    try:
        from heat2d_tpu_torch.obs.metrics import get_registry
        from heat2d_tpu_torch.ops.tridiag import collect_split_replays
        collect_split_replays()
        reg = get_registry()
        segments = _total(reg, "td_split_segments_total")
        replays = _total(reg, "td_split_replays_total")
    except (ImportError, AttributeError):
        return None
    if not segments or replays is None:
        return None
    return (100.0 * (1.0 - replays / segments),
            f"{replays:g} replays in {segments:g} speculative segments")
