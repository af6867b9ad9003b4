"""H10's split schedule in plain PyTorch on the CPU: what ``k_td_rows``'
SPLIT builds (``heat2d_tpu_torch/csrc/tridiag.cu``) do, segment by
segment, so that the tests can hold the schedule to the unsplit sweep bit
for bit and count its replays as the card counts them, as
``ops/resident.emulate_resident`` mirrors H4.

Each system of a member is cut into segments of ``plan.seg_rows`` rows.
Forward, a segment's chain starts W rows before its first row from 0 and
its value at the row before its first is checked against the verified
last d of the segment before; back, its chain starts from 0 at row
``own_hi + W`` (from the exact d[n-1] where that reaches row n-1) over
the next segment's d, and its value at the next segment's first row is
checked against that segment's verified first x. A lane whose check fails
replays its rows from the verified value; a panel of 32 columns with a
failing live lane counts one replay (a warp's ``atomicAdd``).
"""

from __future__ import annotations

import torch

from heat2d_tpu_torch.ops import tridiag as td


def _bits(t):
    return t.view(torch.int32)


def emulate_split(x, c, coef, plan, s=None):
    """``td_rows(x, c, coef)`` (or with ``s``, the stencil's diffusion
    numbers, ``td_rows_rhs(x, c, s, coef)``) by ``plan``'s split schedule:
    returns (the batch, the replays counted). ``plan.segments`` 1 runs
    the unsplit sweep."""
    nb, n, m = x.shape
    rhs = x if s is None else td._rhs_half(x, s.reshape(-1, 1, 1), 1)
    a, cp, mi = td._unpack(c, n, coef)
    cols = torch.arange(m)
    # the lanes checked: every column, or the grid's inner ones
    live = (torch.ones(m, dtype=torch.bool) if s is None
            else (cols >= 1) & (cols <= m - 2))
    seg_rows = plan.seg_rows if plan.segments > 1 else n
    nseg = -(-n // seg_rows)
    out = torch.empty_like(x)
    replays = 0

    def count(miss):
        nonlocal replays
        padded = torch.zeros(-(-m // 32) * 32, dtype=torch.bool)
        padded[:m] = miss
        replays += int(padded.reshape(-1, 32).any(dim=1).sum())

    for b in range(nb):
        r = rhs[b]
        W = min(seg_rows, td.warm_rows(float(coef[b, 0, max(n - 2, 0)]),
                                       plan.warm_bits))

        def fwd(i, prev):
            return (r[i] - a[i, b] * prev) * mi[i, b]

        def back(i, d, nxt):
            return d - cp[i, b] * nxt

        bounds = [(k * seg_rows, min(n, (k + 1) * seg_rows))
                  for k in range(nseg)]
        # forward: each segment's chain from W rows before it, from 0
        d = [None] * n
        spec = []
        for lo_own, hi_own in bounds:
            prev = torch.zeros(m)
            at = prev
            for i in range(max(0, lo_own - W), hi_own):
                if i == lo_own:
                    at = prev
                prev = fwd(i, prev)
                if i >= lo_own:
                    d[i] = prev
            spec.append(at)
        # the joins in order: replay from the verified carry where it
        # differs
        for k, (lo_own, hi_own) in enumerate(bounds[1:], 1):
            carry = d[lo_own - 1]
            miss = live & (_bits(carry) != _bits(spec[k]))
            count(miss)
            prev = carry
            for i in range(lo_own, hi_own):
                prev = fwd(i, prev)
                d[i] = torch.where(miss, prev, d[i])
        # back: each segment's chain from W rows past it, over the final d
        xs_spec, xv = [], [None] * n
        for k, (lo_own, hi_own) in enumerate(bounds):
            last = k == nseg - 1
            exact = hi_own + W >= n
            top = min(hi_own + W, n - 1) - 1
            nxt = d[n - 1] if exact else torch.zeros(m)
            at = nxt
            for i in range(top, lo_own - 1, -1):
                nxt = back(i, d[i], nxt)
                if i == hi_own:
                    at = nxt
                if i < hi_own:
                    xv[i] = nxt
            xs_spec.append(None if last else at)
        if n >= 1:
            xv[n - 1] = d[n - 1]
        for k in range(nseg - 2, -1, -1):
            lo_own, hi_own = bounds[k]
            xt = xv[hi_own]
            miss = live & (_bits(xt) != _bits(xs_spec[k]))
            count(miss)
            nxt = xt
            for i in range(hi_own - 1, lo_own - 1, -1):
                nxt = back(i, d[i], nxt)
                xv[i] = torch.where(miss, nxt, xv[i])
        out[b] = torch.stack(xv)
    if s is not None:
        out = td._hold_edges(out, x)
    return out, replays


def split_plan(nb: int, n: int, m: int, p: int, warm_bits=None,
               rhs: bool = False):
    """H10's plan at (nb, n, m) with each system in ``p`` segments
    (``tridiag.split_rows``), whatever the planner would choose."""
    plan = td.plan_td_rows(nb, n, m, rhs=rhs)
    plan = plan._replace(segments=1, seg_rows=0, warm_bits=0,
                         blocks=nb * -(-m // 32))
    assert plan.warps == 1, plan
    bits = td.WARM_BITS if warm_bits is None else warm_bits
    return plan if p == 1 else td.split_rows(plan, nb, n, m, p, bits)
