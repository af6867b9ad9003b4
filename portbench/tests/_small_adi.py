"""A small copy of the ADI cell, for runs on the CPU."""

import dataclasses

from portbench import harness

#: (nx, ny, steps) and the (cx, cy) range of the small copy: a solve
#: changes the field by 0.16-0.65% of its largest value, as a solve of
#: the cell changes it at 2560x2048 x 40 steps in [12.5, 50] (0.16-0.63%:
#: the physical time t = cx * steps shrunk with the grid's area), so that
#: a gap measured as a share of the change reads as it does at the
#: cell's own sizes.
SMALL = (160, 128, 4)
CX_RANGE = [0.5, 2.0]
CELL = "adi-2560x2048"


def small_cell(name: str = CELL):
    cell = harness.load_cell(name)
    nx, ny, steps = SMALL
    return dataclasses.replace(
        cell, config=dict(cell.config, nxprob=nx, nyprob=ny, steps=steps),
        check=dict(cell.check, block=2),
        traffic=dict(cell.traffic, cx_range=CX_RANGE))


def run_small(seed: int = 2**31 + 99, seconds: float = 1.0,
              trace: bool = False, on_driver=None):
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu",
                            cell=small_cell(), on_driver=on_driver)
