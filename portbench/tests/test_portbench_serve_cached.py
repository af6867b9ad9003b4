"""The cached serving cell on the CPU: the study's draws, a whole run of
the cell's files at a small size with its hits checked bit for bit
against their cold solves, and a cache that hands back a grid one ulp
off its cold solve, which only ``hit_mismatches`` sees."""

import dataclasses

import numpy as np
import pytest

from portbench import controls, harness
from portbench.tests._small import small_cell

CELL = "serve-640x1024-cached"


def _cell():
    """The small copy with the cell's own 16 samples, hits among them."""
    cell = small_cell(CELL, rate=200.0)
    return dataclasses.replace(cell, check=dict(cell.check, samples=16,
                                                block=16))


def _study(seed):
    from portbench.drivers import open_loop_study
    return open_loop_study.Study(seed, 0.05, 0.2, 64, 1.0)


def test_study_draws_zipf_over_a_seeded_ranking_of_the_grid():
    a, b = _study(5), _study(5)
    pts = a.take(5000)
    assert pts == b.take(5000)
    assert pts != _study(6).take(5000)
    axis = {round(0.05 + 0.15 * i / 63, 6) for i in range(64)}
    assert all(cx in axis and cy in axis for cx, cy in pts)
    assert len(a.ranked) == len(set(a.ranked)) == 4096
    # rank 1 drawn with probability 1 / H_4096 ~ 11.2%
    top = pts.count(a.ranked[0]) / len(pts)
    assert 0.09 < top < 0.135, top
    assert a.ranked != _study(6).ranked


def test_whole_small_run_is_correct_with_hits():
    errs = []

    def on_driver(drv):
        check = drv.check

        def recording():
            got = check()
            errs.append(drv.cache_counts)
            return got
        drv.check = recording

    r = harness.run_cell(CELL, 2**31 + 99, 2.0, False, device="cpu",
                         cell=_cell(), on_driver=on_driver)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"grid_gap", "grid_rms_gap", "steps_gap",
                                "hit_mismatches"}
    counts = errs[0]
    assert counts["serve_cache_hits_total"] > 0
    assert counts["serve_cache_misses_total"] > 0
    assert r["checks"]["hit_mismatches"]["value"] == 0


def _ulp_off_cache(drv):
    setup = drv.setup

    def off():
        setup()
        cache = drv.server.cache
        get = cache.get

        def shifted(key):
            res = get(key)
            if res is None:
                return None
            u = np.array(res.u, copy=True)
            u[1, 1] = np.nextafter(u[1, 1], np.float32(np.inf))
            return dataclasses.replace(res, u=u)
        cache.get = shifted
    drv.setup = off


@pytest.mark.parametrize("seed", [3, 2**31 + 1])
def test_a_hit_off_its_cold_solve_is_not_correct(seed):
    r = harness.run_cell(CELL, seed, 2.0, False, device="cpu",
                         cell=_cell(), on_driver=_ulp_off_cache)
    assert not r["correct"]
    assert r["checks"]["hit_mismatches"]["value"] >= 1
    # an ulp is far inside the grid gaps' limits
    assert r["checks"]["grid_gap"]["value"] < 1e-3


@pytest.mark.parametrize("variant", ["control", "half_steps", "unchanged"])
def test_control_and_faults_are_not_correct(variant):
    r = controls.run_variant(CELL, variant, 2**31 + 3, 1.0, device="cpu",
                             cell=small_cell(CELL, rate=200.0))
    assert not r["correct"], r["readings"]
