"""A small copy of the inverse cell, for runs on the CPU."""

import dataclasses

from portbench import harness

#: (nx, ny, steps) of the small copy; its segments follow the steps
#: (K = round(sqrt(40)) = 6: six segments of 6 steps and one of 4).
SMALL = (160, 128, 40)
CELL = "inverse-2560x2048"


def small_cell(name: str = CELL):
    cell = harness.load_cell(name)
    nx, ny, steps = SMALL
    return dataclasses.replace(
        cell, config=dict(cell.config, nxprob=nx, nyprob=ny, steps=steps),
        traffic=dict(cell.traffic, pool=3))


def run_small(seed: int = 2**31 + 99, seconds: float = 1.0,
              trace: bool = False, on_driver=None):
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu",
                            cell=small_cell(), on_driver=on_driver)
