"""Open loop over a shared parameter study: ``open_loop``'s requests to
the program's in-process server (``serve.SolveServer`` at its defaults:
a result cache of 256 entries, single-flight on), at their due times,
with each request's ``(cx, cy)`` drawn from a study grid that many users
ask of again.

The study is ``study_points`` x ``study_points`` points, each
coefficient evenly spaced over ``cx_range`` and rounded to 6 decimals.
The points are ranked in an order drawn from the seed, and each request
takes the point of rank k with probability proportional to
``1 / k**zipf_s`` (Zipf), so popular points come again and are answered
from the result cache, or coalesced onto a solve already in flight; the
misses are solved. The warm-up before the window (``warm_batches``, as
``open_loop``'s) draws distinct pairs off the study grid, so that it
warms each launch capacity and leaves the cache nothing the window asks
for.

Traffic parameters: ``open_loop``'s, with ``study_points`` and
``zipf_s``. The check is ``open_loop``'s over the sampled answers, hits
among them, and adds ``hit_mismatches``: the sampled answers served from
the cache or coalesced whose grid is not bit for bit the answer of the
first request of their point in the window (its cold solve). After the
window it writes the cache's counts (``serve_cache_hits_total``,
``serve_cache_misses_total``, ``serve_coalesced_total``) of the window
and the answered requests' latency percentiles to standard error.
"""

from __future__ import annotations

import sys

import numpy as np

from portbench import generate
from portbench.drivers import open_loop

#: The seed's stream of the study's ranking and draws.
STUDY = 4
CACHE_COUNTERS = ("serve_cache_hits_total", "serve_cache_misses_total",
                  "serve_coalesced_total")


class Study:
    """``(cx, cy)`` points of the study grid drawn by Zipf over a ranking
    from the seed; ``next()`` and ``take(n)`` as ``generate.Pairs``."""

    def __init__(self, seed: int, lo: float, hi: float, points: int,
                 s: float):
        rng = generate.rng(seed, STUDY)
        axis = [round(lo + (hi - lo) * i / (points - 1), 6)
                for i in range(points)]
        grid = [(cx, cy) for cx in axis for cy in axis]
        order = rng.permutation(len(grid))
        self.ranked = [grid[i] for i in order]
        w = 1.0 / np.arange(1, len(grid) + 1, dtype=np.float64) ** s
        self._p = w / w.sum()
        self._rng = rng

    def take(self, n: int) -> list:
        ranks = self._rng.choice(len(self.ranked), size=n, p=self._p)
        return [self.ranked[r] for r in ranks]

    def next(self) -> tuple:
        return self.take(1)[0]


class Driver(open_loop.Driver):
    def __init__(self, cell, seed: int, devices):
        super().__init__(cell, seed, devices)
        t = cell.traffic
        lo, hi = t["cx_range"]
        self.study = Study(seed, lo, hi, int(t["study_points"]),
                           float(t["zipf_s"]))
        self.watched = {}       # arrival index -> its future
        self.planned = []       # the window's points, in arrival order
        self.cache_counts = {}

    def setup(self) -> None:
        super().setup()
        submit = self.server.submit
        calls = [0]

        def recording(req, *a, **kw):
            fut = submit(req, *a, **kw)
            i = calls[0]
            calls[0] += 1
            if i in self.watched:
                self.watched[i] = fut
            return fut
        self.server.submit = recording
        self._calls = calls

    def _counts(self) -> dict:
        return {n: sum(self.reg.find_counters(n).values())
                for n in CACHE_COUNTERS}

    def run_rate(self, rate: float, seconds: float, capture=None) -> dict:
        """``open_loop``'s run, its requests' points drawn from the
        study; the sampled requests and the first request of each of
        their points are watched for the check."""
        n = len(generate.arrivals(self.seed, rate, seconds))
        self.planned = self.study.take(n)
        keep = generate.sample(self.seed, n,
                               self.cell.check.get("samples", 0))
        first = {}
        for i, pt in enumerate(self.planned):
            first.setdefault(pt, i)
        self.first = {i: first[self.planned[i]] for i in keep}
        self.watched = {i: None for i in set(keep) | set(self.first.values())}
        self._calls[0] = 0
        self.pairs = _Planned(self.planned)
        before = self._counts()
        r = super().run_rate(rate, seconds, capture)
        after = self._counts()
        self.cache_counts = {k: after[k] - before[k] for k in after}
        asked = (self.cache_counts["serve_cache_hits_total"]
                 + self.cache_counts["serve_cache_misses_total"])
        share = {k: 100.0 * v / asked if asked else 0.0
                 for k, v in self.cache_counts.items()}
        done = sorted(x for x in r["latencies"] if x is not None)
        if done:
            pct = {q: 1e3 * done[min(len(done) - 1, int(q / 100 * len(done)))]
                   for q in (50, 90, 93, 95, 97, 99)}
            print("latency ms of the answered: " + ", ".join(
                f"p{q} {v:.2f}" for q, v in pct.items()), file=sys.stderr)
        print(f"cache over the window's {asked:g} lookups: "
              + ", ".join(f"{k} {self.cache_counts[k]:g} ({share[k]:.4g}%)"
                          for k in CACHE_COUNTERS), file=sys.stderr)
        return r

    def check(self) -> dict:
        """``open_loop``'s gaps, and the sampled hits that are not bit for
        bit their point's cold solve."""
        out = super().check()
        if not out:
            return out
        mismatches = 0
        for i, j in self.first.items():
            fut, cold = self.watched.get(i), self.watched.get(j)
            if fut is None or cold is None or not fut.done() \
                    or fut.exception() is not None:
                continue
            res = fut.result()
            if i == j or not (res.cache_hit or res.coalesced):
                continue
            if cold.exception() is not None or not np.array_equal(
                    np.asarray(res.u), np.asarray(cold.result().u)):
                mismatches += 1
        out["hit_mismatches"] = float(mismatches)
        return out

    def layer_ctx(self) -> dict:
        return dict(super().layer_ctx(), cache_counts=self.cache_counts)


class _Planned:
    """The window's points, handed out in order as ``Pairs.take``
    would."""

    def __init__(self, points: list):
        self._points = points

    def take(self, n: int) -> list:
        if n != len(self._points):
            raise ValueError(f"planned {len(self._points)} points, "
                             f"asked for {n}")
        return list(self._points)
