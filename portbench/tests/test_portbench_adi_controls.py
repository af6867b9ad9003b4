"""The ADI cell's control (the ADI reference in bfloat16 in the
program's place) and the faults ``controls_adi.py`` plants (half the
steps, the state unchanged), each through a whole run of the harness on
the CPU at the small copy's size, where a solve changes the field by a
few thousandths of its largest value as at the cell's own: every one
comes out not correct, and the sound program correct."""

import pytest

from portbench import controls_adi
from portbench.reference import adi, heat5
from portbench.tests._small_adi import CELL, CX_RANGE, SMALL, small_cell


def test_small_copy_changes_the_field_as_little_as_the_cell():
    for c in CX_RANGE:
        ref, _ = adi.solve(*SMALL, [c], [c])
        init = heat5.inidat(*SMALL[:2])
        share = float((ref[0] - init).abs().max() / init.abs().max())
        assert 1e-3 < share < 7e-3, (c, share)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
@pytest.mark.parametrize("variant", ["control", "half_steps", "unchanged"])
def test_control_and_faults_are_not_correct(variant, seed):
    r = controls_adi.run_variant(CELL, variant, seed, 0.5, device="cpu",
                                 cell=small_cell())
    assert not r["correct"], r["readings"]
    assert set(r["checks"]) == set(small_cell().limits)
    # a grid left as it started reads 1, one that did half its steps
    # about a half
    if variant == "unchanged":
        assert r["readings"]["grid_gap"] == pytest.approx(1.0, rel=1e-6)
    if variant == "half_steps":
        assert 0.4 < r["readings"]["grid_rms_gap"] < 0.6


def test_sound_run_is_correct():
    r = controls_adi.run_variant(CELL, "sound", 2**31 + 11, 0.5,
                                 device="cpu", cell=small_cell())
    assert r["correct"], r["readings"]
    assert r["readings"]["grid_gap"] < 1e-3
