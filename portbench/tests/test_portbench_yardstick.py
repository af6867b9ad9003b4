"""The frozen arithmetic: the work of a solve, the least time on the
H100's published peaks, and the p95 over due times with failures counted as
missing."""

import math

import pytest

from portbench import yardstick

H100 = "NVIDIA H100 80GB HBM3"


def test_peaks_are_the_published_ones():
    assert yardstick.peaks_for(H100) == {"bytes_per_s": 3.35e12,
                                         "flops_per_s": 67e12}
    assert yardstick.peaks_for("cpu") is None


def test_solve_work_at_the_cells_sizes():
    upd, flops, nbytes = yardstick.solve_work(2560, 2048, 10000)
    assert upd == 52_428_800_000
    assert flops == 7 * 52_428_800_000
    assert nbytes == 2 * 2560 * 2048 * 4
    upd, flops, nbytes = yardstick.solve_work(640, 1024, 10000)
    assert (upd, nbytes) == (6_553_600_000, 5_242_880)


def test_least_time_names_its_bound():
    peaks = yardstick.peaks_for(H100)
    _, flops, nbytes = yardstick.solve_work(2560, 2048, 10000)
    t, bound = yardstick.least_time(flops, nbytes, peaks)
    assert bound == "flops"
    assert t == pytest.approx(7 * 52_428_800_000 / 67e12, rel=1e-12)
    # one step of a big grid is bound by its bytes
    _, flops, nbytes = yardstick.solve_work(8192, 8192, 1)
    t, bound = yardstick.least_time(flops, nbytes, peaks)
    assert bound == "bytes"
    assert t == pytest.approx(2 * 8192 * 8192 * 4 / 3.35e12, rel=1e-12)


def test_p95_counts_failures_as_missing():
    lat = [0.01 * (i + 1) for i in range(100)]        # 10 ms .. 1000 ms
    assert yardstick.percentile_missing_inf(lat, 95) == pytest.approx(0.95)
    # five failures (None) take the top five ranks
    lat5 = lat[:95] + [None] * 5
    assert yardstick.percentile_missing_inf(lat5, 95) == pytest.approx(0.95)
    # six push the 95th percentile past every answer
    lat6 = lat[:94] + [None] * 6
    assert yardstick.percentile_missing_inf(lat6, 95) == math.inf
    # nearest rank: 20 requests, p95 is the 19th
    assert yardstick.percentile_missing_inf(list(range(1, 21)), 95) == 19
