"""Small copies of the benchmark's cells, for runs on the CPU."""

import dataclasses

from portbench import harness

#: (nx, ny, steps) of the small copies: a solve with coefficients in the
#: cells' range changes the field by 0.16-0.65% of its largest value, as
#: at 2560x2048 x 10000 steps (0.16-0.63%), so that a gap measured as a
#: share of the change reads as it does at the cells' own sizes.
SMALL = (160, 128, 40)


def small_cell(name: str, **traffic):
    cell = harness.load_cell(name)
    nx, ny, steps = SMALL
    config = dict(cell.config, nxprob=nx, nyprob=ny, steps=steps)
    check = dict(cell.check, samples=min(cell.check["samples"], 4),
                 block=4)
    return dataclasses.replace(cell, config=config, check=check,
                               traffic=dict(cell.traffic, **traffic))


def run_small(name: str, seed: int = 2**31 + 99, seconds: float = 1.0,
              trace: bool = False, on_driver=None, **traffic):
    return harness.run_cell(name, seed, seconds, trace, device="cpu",
                            cell=small_cell(name, **traffic),
                            on_driver=on_driver)
