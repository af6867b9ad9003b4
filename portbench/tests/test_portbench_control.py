"""The control (the reference in the program's place, one precision
below the configuration's: bfloat16) and the faults ``controls.py``
plants, each through a whole run of the harness on the CPU: every one
comes out not correct, at a size where one solve changes the field by a
few thousandths of its largest value, as at the cells' own sizes."""

import pytest
import torch

from portbench import controls
from portbench.reference import heat5
from portbench.tests._small import SMALL, small_cell

CELLS = ["solve-2560x2048", "converge-2560x2048", "serve-640x1024"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_control_run_is_not_correct(name, seed):
    r = controls.run_variant(name, "control", seed, 0.5, device="cpu",
                             cell=small_cell(name))
    assert not r["correct"], r["checks"]
    assert set(r["checks"]) == set(small_cell(name).limits)


def test_small_copies_change_the_field_as_little_as_the_cells():
    for c in (0.05, 0.2):
        ref, _ = heat5.solve(*SMALL, [c], [c])
        init = heat5.inidat(*SMALL[:2])
        share = float((ref[0] - init).abs().max() / ref.abs().max())
        assert 1e-3 < share < 7e-3, (c, share)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("variant", ["half_steps", "unchanged", "control"])
def test_fault_is_caught_where_a_solve_changes_little(name, variant):
    cell = small_cell(name)
    r = controls.run_variant(name, variant, 2**31 + 11, 0.5, device="cpu",
                             cell=cell)
    assert not r["correct"], r["readings"]
    # a grid left as it started reads 1, one that did half its steps
    # about a half, whatever share of the field the solve changes
    if variant == "unchanged":
        assert r["readings"]["grid_gap"] == pytest.approx(1.0, rel=1e-6)
    if variant == "half_steps":
        assert 0.4 < r["readings"]["grid_rms_gap"] < 0.6


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_where_a_solve_changes_little(name):
    r = controls.run_variant(name, "sound", 2**31 + 11, 0.5, device="cpu",
                             cell=small_cell(name))
    assert r["correct"], r["readings"]
    assert r["readings"]["grid_gap"] < 1e-3
    assert torch.isfinite(torch.tensor(r["readings"]["grid_rms_gap"]))
