"""Closed loop, one client, inverse problems: back-to-back recoveries of
the initial field through the program's entry,
``InverseProblem(nx, ny, steps, "init", mask, obs, cx=, cy=,
device=).solve(iterations=, lr=)``, each job's ``InverseSolution`` on the
host at its end.

Before the window the driver draws a pool of ``pool`` pairs ``(cx,
cy)`` from the seed, each coefficient in ``cx_range``, and for each
computes the observations with the plain reference
(``reference/inverse.py``): the float64 forward of the truth field (the
configuration's ``truth``, ``inidat`` at a unit peak) over ``steps``
steps, kept on every ``observe_every``-th interior cell. The jobs cycle
through the pool in that order. In set-up ``warm_jobs`` jobs of one
Adam iteration each warm the memoized runner, H6's plan and the
allocator: one iteration runs every operation a job runs. No
answer can come from a cache: the direct path keeps none, and its
loss-and-gradient runner is memoized by signature alone.

Traffic parameters (``traffic/<mix>.json``): ``cx_range``, ``pool``,
``warm_jobs``. Configuration: ``iterations`` and ``lr`` of a job,
``observe_every``, ``adjoint``, ``segment``, ``method``, ``reg``. Cell
parameters (``workloads/<cell>.json``): ``check.samples`` (jobs
compared with the reference, drawn from the seed), ``trace.iterations``
(the traced slice: whole Adam iterations, from one iteration boundary
to a later one, once a third of the window has passed).

Each Adam iteration's ``portbench.work`` range, from one iteration
boundary of the optimizer to the next (its ``pause`` poll) or to the
job's end, carries ``yardstick_inverse``'s count. ``mcells_per_s``
counts ``nx*ny*steps`` cell updates for each Adam iteration of every
job whose answer reached the host in the window, over the window's whole
length; the window ends when the job in flight at ``seconds`` has
finished. Each job's seconds go to standard error.

The check, per sampled job: the gradient at the job's first iterate
from the problem's own ``value_and_grad()`` (the timed path's memoized
runner) against the reference's float64 gradient (``grad_gap``,
``grad_rms_gap``); the job's first loss and its best loss, each
against the reference's float64 loss at the same parameters
(``loss_gap``, the wider); and the job's move, its best iterate less
its first, against the move of the reference's float64 Adam over the
same iterations from the same first iterate (``step_gap``): an update
dropped or wrong shows there, where the losses, taken at whatever
parameters come out, cannot see it.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import yardstick_inverse
from portbench.drivers import closed_loop
from portbench.reference import inverse


class Driver(closed_loop.Driver):
    kind = "inverse"

    def __init__(self, cell, seed: int, devices):
        super().__init__(cell, seed, devices)
        c = cell.config
        if c["target"] != "init":
            raise ValueError("closed_loop_inverse recovers the initial "
                             f"field: target must be 'init', got "
                             f"{c['target']!r}")
        self.iterations = int(c["iterations"])
        self.lr = float(c["lr"])
        self.every = int(c["observe_every"])
        self.jobs = []          # Adam iterations of each job in the window
        self.job_s = []         # each of those jobs' seconds
        self.cursor = 0         # the next job's index into the pool
        self._range = None      # the open iteration's work range
        self._trace = None      # the window's slice state

    # -- the program ------------------------------------------------------ #

    def _problem(self, k: int):
        """The program's problem of pool entry ``k``."""
        from heat2d_tpu_torch.diff.inverse import InverseProblem
        c = self.cell.config
        cx, cy = self.draws[k]
        return InverseProblem(
            self.nx, self.ny, self.steps, "init", self.mask_np,
            self.obs[k], cx=cx, cy=cy, reg=float(c["reg"]),
            adjoint=c["adjoint"], segment=c["segment"], method=c["method"],
            device=str(self.devices[0]))

    def _job(self, problem, pause=None):
        return problem.solve(iterations=self.iterations, lr=self.lr,
                             pause=pause)

    def _gradient(self, problem):
        """The gradient at the problem's first iterate, by its own
        ``value_and_grad()``."""
        p0 = torch.as_tensor(problem.initial_params(),
                             device=self.devices[0])
        _, g = problem.value_and_grad()(p0)
        return g

    def setup(self) -> None:
        dev = self.devices[0]
        t = self.cell.traffic
        self.draws = self.pairs.take(int(t["pool"]))
        self.mask = inverse.observation_mask(self.nx, self.ny, self.every,
                                             dev)
        self.mask_np = self.mask.cpu().numpy()
        truth = inverse.unit_init(self.nx, self.ny, dev)
        # one member at a time: the pool's float64 grids stay small
        self.obs = [inverse.observe(truth, self.steps, [cx], [cy],
                                    self.mask)[0].float().cpu().numpy()
                    for cx, cy in self.draws]
        for _ in range(int(t.get("warm_jobs", 1))):
            self._problem(self._next()).solve(iterations=1, lr=self.lr)
        # the sampled jobs' best iterates are copied into slots made here
        self.kept = np.zeros((self.sample.k, self.nx, self.ny), np.float32)

    def _next(self) -> int:
        k = self.cursor % len(self.draws)
        self.cursor += 1
        return k

    # -- the window: work ranges and the traced slice at iteration bounds  #

    def _end_iteration(self, ended: bool) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        tr = self._trace
        if ended and tr is not None and tr["in_slice"]:
            tr["traced"] += 1
            if tr["traced"] >= tr["n"]:
                tr["capture"].stop()
                tr["in_slice"] = False

    def _begin_iteration(self) -> None:
        tr = self._trace
        if (tr is not None and not tr["capture"].started
                and time.perf_counter() - tr["t0"] >= tr["lead"]):
            tr["capture"].start()
            tr["in_slice"] = True
        self._range = torch.profiler.record_function(self._label)
        self._range.__enter__()

    def _boundary(self, completed: int) -> bool:
        """The optimizer's ``pause`` poll, at each iteration's start:
        closes the last iteration's work range and opens the next one's.
        Never pauses."""
        self._end_iteration(completed > 0)
        self._begin_iteration()
        return False

    def window(self, seconds: float, capture) -> dict:
        upd, flops, nbytes = yardstick_inverse.iteration_work(
            self.nx, self.ny, self.steps)
        self._label = f"portbench.work:{upd}:{flops}:{nbytes}"
        attempted = 0
        t0 = time.perf_counter()
        self._trace = None if capture is None else {
            "capture": capture, "t0": t0, "lead": seconds / 3,
            "n": self.cell.trace.get("iterations", 1), "traced": 0,
            "in_slice": False}
        t = t0
        while t - t0 < seconds:
            k = self._next()
            attempted += 1
            try:
                problem = self._problem(k)
                sol = self._job(problem, self._boundary)
                self._end_iteration(True)
            except Exception as e:  # noqa: BLE001 — counted, reported
                self._end_iteration(False)
                self.errors += 1
                print(f"job {k} {self.draws[k]} failed: {e!r}",
                      file=sys.stderr)
                t = time.perf_counter()
                continue
            self.job_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            self.jobs.append(sol.iterations)
            j = self.sample.index()
            if j is not None:
                np.copyto(self.kept[j], sol.params, casting="no")
                self.sample.items[j] = (k, sol.loss_history[0],
                                        sol.final_loss, self.kept[j])
            del sol
        if self._trace is not None and self._trace["in_slice"]:
            capture.stop()
        print("jobs' seconds: " + ", ".join(f"{s:.4f}" for s in self.job_s),
              file=sys.stderr)
        window_s = t - t0
        cells = sum(self.nx * self.ny * self.steps * n for n in self.jobs)
        return {"metrics": {"mcells_per_s": (cells / window_s / 1e6,
                                             "Mcells/s")},
                "attempted": attempted, "failed": self.errors,
                "errors": self.errors, "unanswered": 0}

    # -- the check -------------------------------------------------------- #

    def check(self) -> dict:
        """The widest gaps over the sampled jobs (module docstring)."""
        items = self.sample.items
        if not items:
            return {}
        dev = self.devices[0]
        out = {"grad_gap": 0.0, "grad_rms_gap": 0.0, "loss_gap": 0.0,
               "step_gap": 0.0}
        for k, first_loss, best_loss, best in items:
            cx, cy = self.draws[k]
            obs = torch.as_tensor(self.obs[k], device=dev)
            g = self._gradient(self._problem(k))
            p0 = inverse.first_iterate(self.mask, obs)
            refs, g_ref = inverse.value_and_grad(
                p0[None], self.steps, [cx], [cy], self.mask, obs)
            for name, v in inverse.gaps(g, g_ref[0]).items():
                out[name] = max(out[name], v)
            del g
            best = torch.as_tensor(best, device=dev)
            best_ref = inverse.losses(best[None], self.steps, [cx], [cy],
                                      self.mask, obs)
            out["loss_gap"] = max(out["loss_gap"],
                                  inverse.loss_gap(first_loss, refs[0]),
                                  inverse.loss_gap(best_loss, best_ref[0]))
            moved, _ = inverse.adam(
                p0, self.steps, cx, cy, self.mask, obs,
                iterations=self.iterations, lr=self.lr,
                first=(refs[0], g_ref[0]))
            del g_ref
            out["step_gap"] = max(out["step_gap"],
                                  inverse.step_gap(best, moved, p0))
        return out

    def layer_ctx(self) -> dict:
        return {"kind": self.kind, "jobs": list(self.jobs),
                "steps": self.steps}
