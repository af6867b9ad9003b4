"""Closed loop, one client, implicit time stepping: ``closed_loop``'s
back-to-back solves through ``Heat2DSolver(config).run(timed=False)``,
with the configuration's ``method`` (``"adi"``: Crank-Nicolson ADI,
route ``adi-kernel`` in mode ``pallas``) passed to the program, each
solve's ``portbench.work`` range labelled with ADI's count
(``yardstick_adi``), and the check against ``reference/adi.py``.

Parameters as ``closed_loop``'s (``cx_range``, ``warm_solves``;
``check.samples``, ``check.block``, ``trace.solves``); ``convergence``
must be false. ``mcells_per_s`` is the cell updates (nx x ny x steps) of
every solve in the window over its whole length.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import yardstick_adi
from portbench.drivers import closed_loop
from portbench.reference import adi


class Driver(closed_loop.Driver):
    kind = "adi"

    def __init__(self, cell, seed: int, devices):
        super().__init__(cell, seed, devices)
        if self.conv:
            raise ValueError("closed_loop_implicit runs fixed steps: "
                             "convergence must be false")

    def _config(self, cx: float, cy: float):
        from heat2d_tpu_torch.config import HeatConfig
        c = self.cell.config
        return HeatConfig(
            nxprob=self.nx, nyprob=self.ny, steps=self.steps, cx=cx, cy=cy,
            method=c["method"], mode=c["mode"], interval=c["interval"],
            sensitivity=c["sensitivity"])

    def window(self, seconds: float, capture) -> dict:
        """``closed_loop``'s window, each solve's work range labelled with
        ADI's count in place of heat5's."""
        upd, flops, nbytes = yardstick_adi.solve_work(self.nx, self.ny,
                                                      self.steps)
        lead = seconds / 3
        traced, in_slice = 0, False
        n_trace = self.cell.trace.get("solves", 1)
        attempted = 0
        t0 = time.perf_counter()
        t = t0
        while t - t0 < seconds:
            if (capture is not None and not capture.started
                    and t - t0 >= lead):
                capture.start()
                in_slice = True
            cx, cy = self.pairs.next()
            attempted += 1
            try:
                with torch.profiler.record_function(
                        f"portbench.work:{upd}:{flops}:{nbytes}"):
                    r = self._solve(cx, cy)
            except Exception as e:  # noqa: BLE001 — counted, reported
                self.errors += 1
                print(f"solve ({cx}, {cy}) failed: {e!r}",
                      file=sys.stderr)
                t = time.perf_counter()
                continue
            t = time.perf_counter()
            self.solved.append((r.steps_done, r.residual_reads))
            j = self.sample.index()
            if j is not None:
                np.copyto(self.kept[j], r.u, casting="no")
                self.sample.items[j] = (cx, cy, self.kept[j],
                                        r.steps_done)
            del r
            if in_slice:
                traced += 1
                if traced >= n_trace:
                    capture.stop()
                    in_slice = False
        if in_slice:
            capture.stop()
        window_s = t - t0
        cells = sum(self.nx * self.ny * k for k, _ in self.solved)
        return {"metrics": {"mcells_per_s": (cells / window_s / 1e6,
                                             "Mcells/s")},
                "attempted": attempted, "failed": self.errors,
                "errors": self.errors, "unanswered": 0}

    def check(self) -> dict:
        """The widest grid gaps over the sampled solves, against the ADI
        reference in float64."""
        items = self.sample.items
        if not items:
            return {}
        return adi.check_answers(items, self.nx, self.ny, self.steps,
                                 block=self.cell.check.get("block", 1),
                                 device=self.devices[0])
