"""The ADI cell's tridiagonal solves' share of their roofline: the least
time the two solves of the traced slice's updates need (10 FLOP and 16
bytes an update, ``yardstick_adi.tridiag_work``) over the device time of
H10 ``k_td_rows`` and H11 ``k_td_lanes`` in the slice."""

from portbench import yardstick, yardstick_adi

UNIT = "%"
KERNELS = ("H10 k_td_rows", "H11 k_td_lanes")


def read(ctx):
    dig, peaks = ctx.get("digest"), ctx.get("peaks")
    if ctx.get("kind") != "adi" or dig is None or peaks is None:
        return None
    ops = dict(dig["device_ops"])
    updates = dig["work"]["updates"]
    if updates <= 0 or not all(ops.get(k, 0) > 0 for k in KERNELS):
        return None
    solve_s = sum(ops[k] for k in KERNELS)
    flops, nbytes = yardstick_adi.tridiag_work(updates)
    t, bound = yardstick.least_time(flops, nbytes, peaks)
    return (100.0 * t / solve_s,
            f"bound by {bound}; least {t:.6g} s over H10 {ops[KERNELS[0]]:.6g}"
            f" s + H11 {ops[KERNELS[1]]:.6g} s")
