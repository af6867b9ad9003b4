"""Serve-side ensemble engine: one bucket -> one ensemble launch. The
port's copy of ``heat2d_tpu/serve/engine.py``.

A dispatched bucket is a list of same-signature requests whose (cx, cy)
differ, the heterogeneous batch the ensemble runners take:

- **One runner per signature.** The runner comes from
  ``models.ensemble.batch_runner``, memoized per signature.
- **Padded batch shapes.** Launches pad the member axis to the next power
  of two (capped at ``max_batch``), replicating the last member's (cx,
  cy): a pad member's trajectory is its twin's, so it cannot hold a
  convergence loop open longer than the batch would, and the results are
  cropped on return. The JAX package pads so that a signature compiles
  O(log max_batch) programs; here the ladder keeps the launch shapes
  (and the per-member work) the same on both stacks.

Each launch appends a row to ``launch_log`` with its occupancy and
capacity, the route and problem family it ran, and where its host time
went: ``setup_s``
(padding, the initial batch, the coefficient vectors on the device),
``run_s`` (the runner until the device is done) and ``readback_s`` (the
copy of the batch to the host). Metrics: ``serve_launches_total``,
``serve_launch_s`` (run + readback), ``problem_requests_total{problem=}``
(launches per family) and ``serve_compile_cache_size`` (the runner
cache's size).

Every row carries ``perf``, its roofline stamp (``obs/roofline``: the
achieved Mcells/s over ``run_s`` against the card's bound for the
route's bytes and FLOPs at the launch's plan; the bound is None off the
H100), and the ``perf_*`` gauges; with the perf observer armed
(``obs/perf``), a signature's first launch at a capacity also makes its
cost card.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import List, Tuple

import torch

from heat2d_tpu_torch.models import ensemble
from heat2d_tpu_torch.resil import chaos
from heat2d_tpu_torch.utils.device import resolve_device

log = logging.getLogger("heat2d_tpu_torch.serve")


def _pad_capacity(n: int, cap: int) -> int:
    """Next power of two >= n, capped at ``cap`` (cap wins even when it
    is not itself a power of two: a bucket never exceeds max_batch)."""
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


class EnsembleEngine:
    """Executes buckets through the batched ensemble runners on one
    device (``cuda`` unless given ``device="cpu"``). Holds no queue
    state: the batcher schedules, this owns the numerics and the launch
    accounting.

    ``spatial_grid``/``halo``: a deployment-level decomposition; when set,
    every signature's halo route (``ensemble.spatial_halo_plan``) is
    resolved before its first launch and rides the launch rows as
    ``halo_plan``, ``compiled: False`` until a mesh program runs it (the
    mesh engine, ``mesh/engine.py``, flips it)."""

    def __init__(self, registry=None, max_batch: int = 8, device=None,
                 spatial_grid=None, halo: str = "collective"):
        self.registry = registry
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self.spatial_grid = spatial_grid
        self.halo = halo
        self.launches = 0
        self.launch_log: List[dict] = []
        #: launch keys that have run in this process (a row's
        #: ``first_launch`` flag)
        self._launched: set = set()
        #: signature -> the tuning db's config (a dict) or None, resolved
        #: before the signature's first launch
        self.tuned: dict = {}
        #: signature -> pre-resolved halo plan (spatial engines only)
        self.halo_plans: dict = {}

    def _preresolve_tuned(self, req0, spatial: bool = False):
        """Resolve a signature's plans once, before its first launch: the
        tuning db's answer for the kernel its batch runner takes (heat5
        only: H5's chunk depth K on route pallas, H6/H7's depth and tile
        height on route band; the batch runner consults the same answer
        at each launch) and, for spatial engines, the halo plan. The
        answer rides every launch row as ``tuned_config``, as the launch
        takes it (``ensemble.tuned_for_launch``: H5 takes the db's K on
        one member only); it is None with no db, and for a ``spatial``
        launch (the sharded golden loop
        takes no tuned kernel plan; a tuned fused depth rides its halo
        plan)."""
        sig = req0.signature()
        if sig in self.tuned:
            return self.tuned[sig]
        from heat2d_tpu_torch.tune import runtime as tune_runtime
        tuned = None
        if (not spatial and tune_runtime.active_db() is not None
                and getattr(req0, "problem", "heat5") == "heat5"):
            route = ensemble._pick_method(req0.method, req0.nx, req0.ny,
                                          self.device)
            cfg = ensemble.tuned_config(route, req0.nx, req0.ny,
                                        self.device)
            if cfg is not None:
                tuned = cfg.to_dict()
        self.tuned[sig] = tuned
        if self.spatial_grid is not None:
            gx, gy = self.spatial_grid
            self.halo_plans[sig] = dict(
                ensemble.spatial_halo_plan(req0.nx, req0.ny, gx, gy,
                                           halo=self.halo,
                                           device=self.device),
                compiled=False)
        if self.registry is not None:
            self.registry.counter("tune_serve_signatures_total",
                                  tuned=str(tuned is not None).lower())
        return tuned

    def solve_batch(self, requests) -> List[Tuple["object", int]]:
        """Solve same-signature ``requests`` in one ensemble launch.
        Returns one (u, steps_done) pair per request, in order, with u
        the member's grid on the host.

        May raise transients (including an injected ``ChaosError``); the
        server's retry policy absorbs them."""
        chaos.launch_point()
        return self._solve_on(requests, self.device)

    def _solve_on(self, requests, device) -> List[Tuple["object", int]]:
        """``solve_batch``'s launch on ``device``."""
        t0 = time.perf_counter()
        req0 = requests[0]
        tuned = self._preresolve_tuned(req0)
        n = len(requests)
        capacity = _pad_capacity(n, self.max_batch)
        cxs = [r.cx for r in requests]
        cys = [r.cy for r in requests]
        cxs += [cxs[-1]] * (capacity - n)
        cys += [cys[-1]] * (capacity - n)
        cxs, cys, u0 = ensemble._validated_batch(
            req0.nx, req0.ny, cxs, cys, None, device)
        # Fixed-step requests hand the runner cache (0, 0.0), never their
        # unused interval/sensitivity: one signature, one runner.
        interval, sensitivity = req0.schedule()
        runner = ensemble.batch_runner(
            req0.nx, req0.ny, req0.steps, req0.method,
            convergence=req0.convergence, interval=interval,
            sensitivity=sensitivity, problem=req0.problem,
            device=str(device))
        from heat2d_tpu_torch.obs import perf, roofline
        meta = None
        watch = None
        if perf.enabled():
            meta = {"signature": str(req0.signature()), "nx": req0.nx,
                    "ny": req0.ny, "steps": req0.steps,
                    "method": req0.method,
                    "convergence": req0.convergence, "capacity": capacity,
                    "dtype": "float32", "problem": req0.problem,
                    "route": "batch"}
            watch = perf.launch_watch(meta, device)
        t1 = time.perf_counter()

        timer = (self.registry.timer("serve_launch_s")
                 if self.registry is not None else contextlib.nullcontext())
        with timer:
            out = runner(u0, cxs, cys)
            u = out[0] if req0.convergence else out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            # Only the real members go to the host: the pads' copies
            # would be readback time for results nobody asked for.
            if req0.convergence:
                steps_done = [int(k) for k in out[1][:n].cpu()]
            else:
                steps_done = [req0.steps] * n
            u = u[:n].cpu().numpy()
        t3 = time.perf_counter()

        self.launches += 1
        compile_key = (req0.signature(), capacity)
        first_launch = compile_key not in self._launched
        self._launched.add(compile_key)
        row = {"signature": req0.signature(), "occupancy": n,
               "capacity": capacity, "method": runner.method,
               "problem": req0.problem,
               "tuned_config": ensemble.tuned_for_launch(tuned, capacity),
               "first_launch": first_launch,
               "setup_s": t1 - t0, "run_s": t2 - t1, "readback_s": t3 - t2}
        if self.spatial_grid is not None:
            row["halo_plan"] = self.halo_plans.get(req0.signature())
        card = None
        if meta is not None:
            card = perf.observe_launch(runner, (u0, cxs, cys), meta=meta,
                                       outputs=out, watch=watch)
        roofline.stamp_launch_row(
            row, self.registry, nx=req0.nx, ny=req0.ny,
            steps=(sum(steps_done) / n if req0.convergence
                   else req0.steps),
            members=capacity, elapsed_s=t2 - t1, method=req0.method,
            signature=str(req0.signature()), card=card,
            problem=req0.problem, device=device)
        self.launch_log.append(row)
        if self.registry is not None:
            self.registry.counter("serve_launches_total")
            self.registry.counter("problem_requests_total",
                                  problem=req0.problem)
            self.registry.gauge("serve_compile_cache_size",
                                ensemble.batch_runner.cache_info().currsize)
        log.debug("launch %d: %dx%d steps=%d occupancy=%d/%d route=%s",
                  self.launches, req0.nx, req0.ny, req0.steps, n, capacity,
                  runner.method)
        return [(u[i], steps_done[i]) for i in range(n)]
