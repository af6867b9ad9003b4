"""The two-point marginal step-time protocol: the port's copy of
``two_point_estimate`` of ``heat2d_tpu/tune/measure.py`` (the estimator
``bench.py`` times its headline with), with its two constants; and the
link model the mesh scheduler prices cross-process seams with
(``link_bytes_per_s``, ``route_bytes_per_s``).

The marginal step time is (t_hi - t_lo) / (hi - lo), which cancels the
fixed cost of a timed call (the fence and the launches around the step
loop). A marginal is believed only when its window clears the noise:
more than 5x the jitter (the spread of the best two of three ``lo``
runs) and more than ``NOISE_FLOOR_S``, and when the estimate of the next
decade agrees within ``AGREE_FACTOR``. At ``max_hi`` an unconfirmed
estimate is accepted only if its window also clears twice the floor;
otherwise there is no marginal, and the caller reports its end-to-end
figure and says so.
"""

from __future__ import annotations

#: Absolute floor of the timed window (seconds): a smaller window can be
#: pure fence noise even when it clears 5x the measured jitter.
NOISE_FLOOR_S = 0.05

#: Two marginal estimates a decade apart must agree within this factor
#: for either to be believed.
AGREE_FACTOR = 1.5

#: The card's memory bandwidth (NVIDIA H100 80GB HBM3 at its 700 W
#: power limit, data sheet): what a 'local' seam, on-chip traffic of the
#: kernel's own stream, prices as.
HBM_BYTES_PER_S = 3.35e12

#: Per-direction link bandwidths by class (``DistWorld.link_kind``'s
#: vocabulary), the NVIDIA H100 80GB HBM3's data-sheet figures at its
#: 700 W power limit: 'ici' is two cards of one host over NVLink 4
#: (900 GB/s both ways, 450 GB/s each); 'dcn' is a strip leaving the
#: card for another host, which crosses the card's PCIe Gen5 x16 link
#: first (128 GB/s both ways, 64 GB/s each), the ceiling of any route
#: off the card. The ~7x asymmetry is what the seam pricing must see.
LINK_BYTES_PER_S = {"ici": 450e9, "dcn": 64e9}


#: The port's only route between processes, whatever their link class:
#: strips staged through pinned host buffers and moved by gloo
#: (``parallel/halo.py``). The rate of leg (a) of ``chip_smoke.py``'s
#: multi_process phase (bytes over seconds of the timed run's exchanges,
#: 64 KiB strips, 2 ranks on one card: 3.38e8 and 3.40e8 B/s), on an
#: NVIDIA H100 80GB HBM3 at its 700 W power limit, the slower rank's.
HOST_STAGED_BYTES_PER_S = 3.38e8


def link_bytes_per_s(kind: str) -> float:
    """Bandwidth of a link CLASS ('local' prices as HBM: on-chip traffic
    is the kernel's own stream, not a seam)."""
    if kind == "local":
        return HBM_BYTES_PER_S
    try:
        return LINK_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(
            f"unknown link kind {kind!r}; expected 'local' or one of "
            f"{sorted(LINK_BYTES_PER_S)}") from None


def route_bytes_per_s(kind: str, same_process: bool) -> float:
    """What a seam of link class ``kind`` moves per second on the port's
    route: the link's figure between slots of one process (a peer copy),
    at most the host-staged rate between processes (gloo through host
    buffers, the port's only route there)."""
    rate = link_bytes_per_s(kind)
    return rate if same_process else min(rate, HOST_STAGED_BYTES_PER_S)


def two_point_estimate(timed_run, lo, hi0, max_hi,
                       floor=NOISE_FLOOR_S, agree=AGREE_FACTOR):
    """Adaptive two-point marginal step time: ``(step_time | None, hi,
    result)``. ``timed_run(n)`` runs n steps and returns an object with
    ``.elapsed`` (seconds); ``lo`` is timed 3 times, each ``hi`` twice,
    and ``hi`` grows x10 from ``hi0`` up to ``max_hi`` until an estimate
    is confirmed (module docstring). ``result`` is the faster of the
    last two ``hi`` runs."""
    lo_ts = sorted(timed_run(lo).elapsed for _ in range(3))
    t_lo = lo_ts[0]
    # The spread of the best two of three: one outlier can neither fake
    # a tiny jitter nor poison t_lo.
    jitter = lo_ts[1] - lo_ts[0]
    prev = None
    hi = hi0
    while True:
        ra, rb = timed_run(hi), timed_run(hi)
        result = ra if ra.elapsed <= rb.elapsed else rb
        dt = result.elapsed - t_lo
        cand = dt / (hi - lo) if dt > max(5 * jitter, floor) else None
        if cand is not None and prev is not None:
            if max(cand, prev) <= agree * min(cand, prev):
                return cand, hi, result      # confirmed across a decade
        if hi >= max_hi:
            if cand is not None and dt > max(5 * jitter, 2 * floor):
                return cand, hi, result      # fully amortized window
            return None, hi, result
        prev = cand
        hi = min(hi * 10, max_hi)
