"""The two-point marginal step-time protocol: the port's copy of
``two_point_estimate`` of ``heat2d_tpu/tune/measure.py`` (the estimator
``bench.py`` times its headline with), with its two constants.

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
