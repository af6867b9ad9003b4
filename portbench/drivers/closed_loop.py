"""Closed loop, one client: back-to-back solves through the program's
entry, ``Heat2DSolver(config).run(timed=False)``, each with its own
``(cx, cy)`` from the seed and its final grid returned to the host
(gathered from every card on a mesh).

Traffic parameters (``traffic/<mix>.json``): ``cx_range`` (each
coefficient's range), ``convergence`` (the configuration's
INTERVAL/SENSITIVITY check on), ``warm_solves``. Cell parameters
(``workloads/<cell>.json``): ``check.samples`` (solves compared with the
reference, drawn from the seed), ``check.block`` (members the
reference steps together), ``trace.solves`` (the traced slice).

The window runs solves until ``seconds`` have passed and the solve in
flight then has finished; ``mcells_per_s`` is the cell updates of every
solve in it over its whole length. A traced run profiles
``trace.solves`` whole solves in the middle third of the window.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import generate, yardstick
from portbench.reference import heat5


class Driver:
    kind = "solve"

    def __init__(self, cell, seed: int, devices):
        self.cell = cell
        self.devices = devices
        c = cell.config
        self.nx, self.ny, self.steps = c["nxprob"], c["nyprob"], c["steps"]
        self.conv = bool(cell.traffic.get("convergence", False))
        lo, hi = cell.traffic["cx_range"]
        self.pairs = generate.Pairs(seed, lo, hi)
        self.sample = generate.Reservoir(seed, cell.check["samples"])
        self.solved = []        # (steps_done, residual_reads) per solve
        self.errors = 0
        self.kept = None        # the sampled grids' copies, one slot each

    # -- the program ------------------------------------------------------ #

    def _config(self, cx: float, cy: float):
        from heat2d_tpu_torch.config import HeatConfig
        c = self.cell.config
        return HeatConfig(
            nxprob=self.nx, nyprob=self.ny, steps=self.steps, cx=cx, cy=cy,
            mode=c["mode"], gridx=c.get("gridx", 1), gridy=c.get("gridy", 1),
            convergence=self.conv, interval=c["interval"],
            sensitivity=c["sensitivity"])

    def _solve(self, cx: float, cy: float):
        from heat2d_tpu_torch.models.solver import Heat2DSolver
        cfg = self._config(cx, cy)
        if cfg.mode in ("dist1d", "dist2d", "hybrid"):
            n = cfg.gridx * cfg.gridy
            devs = [self.devices[i % len(self.devices)] for i in range(n)]
            solver = Heat2DSolver(cfg, device=self.devices[0], devices=devs)
        else:
            solver = Heat2DSolver(cfg, device=self.devices[0])
        return solver.run(timed=False)

    def setup(self) -> None:
        for _ in range(int(self.cell.traffic.get("warm_solves", 1))):
            r = self._solve(*self.pairs.next())
        # The grids sampled for the check are copied into slots made
        # here, and every answer is dropped as its solve ends: answers
        # kept alive hold the host's heap in a pattern that each seed
        # draws anew, which made the window's rate differ by seed by up
        # to 5% at 2560x2048.
        u = np.asarray(r.u)
        self.kept = np.zeros((self.sample.k,) + u.shape, u.dtype)

    def window(self, seconds: float, capture) -> dict:
        upd, flops, nbytes = yardstick.solve_work(self.nx, self.ny,
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

    def release(self) -> None:
        if self.devices[0].type == "cuda":
            for d in self.devices:
                torch.cuda.synchronize(d)
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------- #

    def check(self) -> dict:
        """The widest grid gaps over the sampled solves and, with the
        convergence check on, the widest difference in steps done."""
        items = self.sample.items
        if not items:
            return {}
        out = heat5.check_answers(
            items, self.nx, self.ny, self.steps,
            block=self.cell.check.get("block", 1), device=self.devices[0],
            interval=self.cell.config["interval"] if self.conv else 0,
            sensitivity=self.cell.config["sensitivity"])
        if not self.conv:
            del out["steps_gap"]
        return out

    def layer_ctx(self) -> dict:
        return {"kind": self.kind, "convergence": self.conv,
                "residual_reads": [r for _, r in self.solved]}
