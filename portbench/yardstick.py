"""The benchmark's frozen arithmetic: the card's peaks, the work a solve
needs, the least time that work takes, and the percentile the serving
metrics are made of.

Nothing here reads the program: the work of a solve is counted from its
sizes alone (cell updates x FLOPs an update; each solve's input and
output grid read and written once), so a kernel that changes its tiles,
its route or its plan is held to the same count.
"""

from __future__ import annotations

import math

#: Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W):
#: device-memory bandwidth and the float32 rate outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}

#: FLOPs of one heat5 update counted in its factored form,
#: ``(1 - 2cx - 2cy)*u + cx*(n + s) + cy*(e + w)``: two adds inside the
#: brackets, three multiplies, two adds; the least any evaluation needs.
FLOPS_PER_UPDATE = {"heat5": 7}

#: Bytes of one float32 cell.
CELL_BYTES = 4


def peaks_for(kind: str) -> dict | None:
    """The peaks of a card of ``kind`` (``torch.cuda.get_device_name``),
    or None for a card with no row: then no roofline is reported."""
    return PEAKS.get(kind)


def solve_work(nx: int, ny: int, steps: int, stencil: str = "heat5"):
    """(cell updates, FLOPs, bytes) one solve needs: ``nx*ny*steps``
    updates (the Report's count), ``FLOPS_PER_UPDATE`` each, and its
    input and output grid once each."""
    updates = nx * ny * steps
    return (updates, updates * FLOPS_PER_UPDATE[stencil],
            2 * nx * ny * CELL_BYTES)


def least_time(flops: float, nbytes: float, peaks: dict):
    """(seconds, bound): the larger of FLOPs over the FLOP rate and bytes
    over the bandwidth, and which of the two (``"flops"`` or
    ``"bytes"``) it is."""
    t_f = flops / peaks["flops_per_s"]
    t_b = nbytes / peaks["bytes_per_s"]
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")


def percentile_missing_inf(latencies, q: float) -> float:
    """The ``q``-th percentile (nearest rank, 0 < q <= 100) of
    ``latencies``, where a request that failed, was refused or never
    answered is given as None and counts as missing any limit
    (infinite). Returns inf when the rank falls on such a request."""
    vals = sorted(math.inf if v is None else float(v) for v in latencies)
    if not vals:
        raise ValueError("no requests")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]
