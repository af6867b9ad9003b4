"""The port's headline protocol against bench.py's: the two-point
estimator (``heat2d_tpu_torch.tune.measure``) against
``heat2d_tpu.tune.measure.two_point_estimate`` on scripted timings, and
``bench_torch.py``'s record against ``bench.py``'s."""

import importlib
import os
import sys
import types

import pytest

from heat2d_tpu.tune import measure as jmeasure
from heat2d_tpu_torch.tune import measure as tmeasure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scripted(times):
    """``timed_run(n)`` answering the scripted seconds for n in order,
    and the log of the counts it was asked for."""
    queues = {n: list(ts) for n, ts in times.items()}
    asked = []

    def timed_run(n):
        asked.append(n)
        return types.SimpleNamespace(elapsed=queues[n].pop(0), n=n)
    return timed_run, asked


#: (lo, hi0, max_hi, {n: elapsed seconds in call order})
CASES = {
    # window 0.03 s: under the 0.05 s floor, no marginal
    "within_floor": (20, 100, 100, {20: [0.50, 0.51, 0.52],
                                    100: [0.53, 0.54]}),
    # window 0.2 s clears the floor but not 5x a 0.1 s jitter
    "jitter_faked": (4800, 24000, 24000, {4800: [1.0, 1.1, 1.3],
                                          24000: [1.2, 1.25]}),
    # a decade apart, 1e-5 and 1.1e-5 s a step: confirmed at 10x
    "confirmed": (10, 1000, 10000, {10: [0.10, 0.1001, 0.11],
                                    1000: [0.1099, 0.12],
                                    10000: [0.2099, 0.22]}),
    # one decade only: the window clears the floor but not 2x it
    "unconfirmed_at_max_hi": (4800, 24000, 24000,
                              {4800: [1.0, 1.001, 1.01],
                               24000: [1.08, 1.09]}),
    # ... and one that clears 2x the floor: accepted unconfirmed
    "amortized_at_max_hi": (4800, 24000, 24000,
                            {4800: [1.0, 1.001, 1.01],
                             24000: [1.5, 1.51]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_point_estimate_matches_jax(case):
    """Same scripted timings, same verdict, same ``hi``, same result run
    and the same sequence of timed step counts; the constants equal."""
    assert tmeasure.NOISE_FLOOR_S == jmeasure.NOISE_FLOOR_S
    assert tmeasure.AGREE_FACTOR == jmeasure.AGREE_FACTOR
    lo, hi0, max_hi, times = CASES[case]
    tr, tasked = _scripted(times)
    jr, jasked = _scripted(times)
    got = tmeasure.two_point_estimate(tr, lo, hi0, max_hi)
    want = jmeasure.two_point_estimate(jr, lo, hi0, max_hi)
    assert tasked == jasked
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2].elapsed == want[2].elapsed
    expect_none = case in ("within_floor", "jitter_faked",
                           "unconfirmed_at_max_hi")
    assert (got[0] is None) == expect_none


def _load(name, quick, monkeypatch):
    if quick:
        monkeypatch.setenv("BENCH_QUICK", "1")
    else:
        monkeypatch.delenv("BENCH_QUICK", raising=False)
    monkeypatch.syspath_prepend(REPO)
    sys.modules.pop(name, None)
    return importlib.import_module(name)


@pytest.mark.parametrize("quick", [False, True])
def test_bench_torch_metric_equals_bench_py(quick, monkeypatch):
    """``metric`` and the two step counts are bench.py's for both
    ``BENCH_QUICK`` settings (24000 / 4800 and 100 / 20)."""
    from heat2d_tpu.models import solution as jsolution
    monkeypatch.setattr(jsolution, "bench_tts", lambda **kw: {})
    bench = _load("bench", quick, monkeypatch)
    tbench = _load("bench_torch", quick, monkeypatch)
    try:
        want = bench.build_record(1000.0, "two-point", 1.0)
        got = tbench.build_record(1000.0, "two-point", 1.0, {}, "pallas",
                                  "cpu")
        assert got["metric"] == want["metric"]
        assert (tbench.STEPS, tbench.STEPS_LO) == (
            bench.STEPS, max(bench.STEPS // 5, 1))
        assert got["metric"] == ("Mcells/s/chip 1024x1024x100 (pallas)"
                                 if quick else
                                 "Mcells/s/chip 4096x4096x24000 (pallas)")
    finally:
        sys.modules.pop("bench", None)
        sys.modules.pop("bench_torch", None)


def test_bench_torch_tts_failure_keeps_the_headline(monkeypatch, capsys):
    """A time-to-solution failure becomes an error string in the record;
    the headline line is still printed and the exit is 0 (bench.py's
    guard)."""
    import json

    import torch

    from heat2d_tpu_torch.models import solution, solver
    tbench = _load("bench_torch", True, monkeypatch)
    try:
        u = torch.zeros(8, 8)
        u[1:-1, 1:-1] = 1.0
        result = types.SimpleNamespace(u=u, elapsed=0.5, mcells_per_s=1.0)
        monkeypatch.setattr(solver, "two_point_headline",
                            lambda *a, **k: {"step_s": 1e-3,
                                             "result": result})

        def boom(**kw):
            raise RuntimeError("tts broke")
        monkeypatch.setattr(solution, "bench_tts", boom)
        assert tbench.main(["--device", "cpu"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["time_to_solution"] == {
            "error": "RuntimeError: tts broke"}
        assert rec["method"] == "two-point"
        assert rec["value"] == round(1024 * 1024 / 1e-3 / 1e6, 1)
    finally:
        sys.modules.pop("bench_torch", None)
