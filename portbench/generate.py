"""The traffic generator every driver draws from: the coefficients of each
solve or request, and the arrival times of an open loop, all from the
run's seed.

- ``pairs``: distinct ``(cx, cy)`` pairs, each coefficient uniform in the
  mix's range and rounded to 6 decimals (the program's load generator's
  draw, ``load/synth.py``); distinct, so that no request is answered
  from the server's result cache or coalesced with another.
- ``arrivals``: the due times of an open loop at ``rate`` over
  ``seconds``: ``round(rate * seconds)`` requests whose gaps are the
  quantiles of the exponential distribution (a Poisson process's gaps),
  dealt in an order drawn from the seed, and scaled so that they add up
  to ``seconds``. Every seed offers the same gaps, so the same load and
  the same bursts in another order.
"""

from __future__ import annotations

import math

import numpy as np

#: Streams of one seed: the coefficients and the arrivals' order.
PAIRS, ORDER, SAMPLE = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([abs(int(seed)) % 2**64,
                                  int(int(seed) < 0), stream])


class Pairs:
    """Distinct ``(cx, cy)`` pairs from the seed, in the range
    ``[lo, hi]`` for each coefficient; ``next()`` gives the next."""

    def __init__(self, seed: int, lo: float, hi: float):
        self._rng = rng(seed, PAIRS)
        self._lo, self._hi = lo, hi
        self._seen: set = set()

    def next(self) -> tuple:
        while True:
            cx, cy = (round(self._lo + (self._hi - self._lo) * float(u), 6)
                      for u in self._rng.random(2))
            if (cx, cy) not in self._seen:
                self._seen.add((cx, cy))
                return cx, cy

    def take(self, n: int) -> list:
        return [self.next() for _ in range(n)]


def arrivals(seed: int, rate: float, seconds: float) -> list:
    """Due times (seconds from the window's start, the first at 0) of
    ``round(rate * seconds)`` requests."""
    n = max(1, round(rate * seconds))
    gaps = np.array([-math.log1p(-(i + 0.5) / n) for i in range(n)])
    gaps = gaps[rng(seed, ORDER).permutation(n)]
    gaps *= seconds / gaps.sum()
    return [0.0] + np.cumsum(gaps[:-1]).tolist()


class Reservoir:
    """A sample of ``k`` items of a stream of unknown length, drawn from
    the seed (Algorithm R): every item has the same chance to be kept,
    and the same seed and stream keep the same items."""

    def __init__(self, seed: int, k: int):
        self._rng = rng(seed, SAMPLE)
        self.k = k
        self.seen = 0
        self.items: list = []

    def index(self):
        """Counts one more item of the stream: the slot of ``items`` it is
        kept in, or None where it is not kept."""
        if len(self.items) < self.k:
            self.items.append(None)
            j = len(self.items) - 1
        else:
            j = int(self._rng.integers(0, self.seen + 1))
            j = j if j < self.k else None
        self.seen += 1
        return j


def sample(seed: int, population: int, k: int) -> list:
    """``min(k, population)`` distinct indices of ``range(population)``,
    drawn from the seed, sorted."""
    k = min(k, population)
    return sorted(rng(seed, SAMPLE).choice(population, size=k,
                                           replace=False).tolist())
