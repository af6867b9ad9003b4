"""The readers' shared arithmetic: a cell's kernels' share of the least
time its traced work needs (``yardstick.least_time`` over the work the
drivers mark), and the device's idle share."""

from portbench import yardstick


def roofline_pct(ctx, kind: str):
    """(share in %, note) for a cell of ``kind``, or None."""
    dig, peaks = ctx.get("digest"), ctx.get("peaks")
    if ctx.get("kind") != kind or dig is None or peaks is None:
        return None
    work = dig["work"]
    if dig["kernel_s"] <= 0 or work["updates"] <= 0:
        return None
    t, bound = yardstick.least_time(work["flops"], work["bytes"], peaks)
    return (100.0 * t / dig["kernel_s"],
            f"bound by {bound}; least {t:.6g} s (flops {work['flops']:.6g}, "
            f"bytes {work['bytes']:.6g}) over kernels {dig['kernel_s']:.6g} "
            f"s in a {dig['window_s']:.6g} s slice")


def idle_pct(ctx, kind: str):
    """(the cards' mean idle share in %, each card's), or None."""
    dig = ctx.get("digest")
    if ctx.get("kind") != kind or dig is None or ctx.get("peaks") is None:
        return None
    per = dig["idle_pct"]
    if not per or any(v is None for v in per.values()):
        return None
    cards = ", ".join(f"card{i} {v:.6g}%" for i, v in sorted(per.items()))
    return sum(per.values()) / len(per), f"idle by card: {cards}"
