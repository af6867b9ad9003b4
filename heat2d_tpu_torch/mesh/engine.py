"""``MeshEnsembleEngine``: the mesh-aware serve engine. The port of
``heat2d_tpu/mesh/engine.py``.

A drop-in for ``serve.engine.EnsembleEngine`` (the server takes either
through ``engine=``): the same ``solve_batch`` contract and launch
accounting, but each bucket routes through the mesh scheduler:

- **batch** buckets launch the mesh batch runner (``mesh/runner.py``) at
  a slot-multiple capacity, the members split over every slot;
- **spatial** buckets launch the memoized batch x spatial program
  (``ensemble.spatial_batch_runner``), and the signature's pre-resolved
  halo plan is stamped ``compiled: True`` with the mesh shape when that
  program is first built;
- **single** buckets (one slot, request kinds other than solve,
  ``tier="unplannable"`` shapes) fall through to the inherited
  single-device path with a ``mesh_fallback_total{reason}`` counter:
  served, never rejected, and still through the hand kernels.

Results equal the single-device engine's bit for bit on the batch route
at every occupancy rung; the spatial route runs the golden step of the
``jnp`` route (as the JAX package runs jnp there), bit for bit that
route's answer.

Each launch row carries ``setup_s`` (padding, the batch and its
coefficients on the device), ``run_s`` (the runner until every slot's
card is done) and ``readback_s`` (the copy to the host), as the
single-device engine's rows do.

**Fault tolerance** (opt-in, ``fault=FaultPolicy(...)``): batch launches
run under the stall watchdog (``mesh/health.py``, warm launches only);
device losses, stalls and ABFT checksum mismatches quarantine the
culprit and relaunch the same batch over the surviving slots, re-padded
to their slot multiple; spatial signatures degrade onto the survivor
batch mesh; no result of a failed attempt is ever served
(``mesh/degrade.serving_invariant``). On one card the slots share a
stream and run one after another, so a stall deadline is meaningful only
well above one warm launch.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Tuple

import torch

from heat2d_tpu_torch.mesh.health import MeshStallError
from heat2d_tpu_torch.resil import chaos
from heat2d_tpu_torch.serve.engine import EnsembleEngine
from heat2d_tpu_torch.serve.schema import Rejected


def _sync(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class MeshEnsembleEngine(EnsembleEngine):
    """Mesh-aware ensemble engine (module docstring) over ``n_devices``
    slots of ``devices`` (default: the visible cards).

    ``max_batch`` is the total per-launch bound; it defaults to
    ``max_batch_per_chip * n_devices`` and is rounded up to a slot
    multiple. ``scheduler`` defaults to a ``MeshScheduler`` over the same
    slots. ``fault``: a ``degrade.FaultPolicy`` arming quarantine, the
    stall watchdog and ABFT; ``fault_clock``: the stall deadline's clock
    (injectable; None = the wall)."""

    def __init__(self, registry=None, max_batch: Optional[int] = None,
                 n_devices: Optional[int] = None, halo: str = "fused",
                 scheduler=None, max_batch_per_chip: int = 8,
                 fault=None, fault_clock=None, devices=None):
        from heat2d_tpu_torch.mesh.runner import attached_devices
        from heat2d_tpu_torch.mesh.scheduler import MeshScheduler

        slots = attached_devices(n_devices, devices)
        nd = len(slots)
        self.devices = tuple(slots)
        self.health = None
        self.degrader = None
        if fault is not None:
            from heat2d_tpu_torch.mesh.degrade import MeshDegrader
            from heat2d_tpu_torch.mesh.health import HealthMonitor
            self.health = HealthMonitor(
                registry=registry, clock=fault_clock or time.monotonic,
                devices=slots)
            self.degrader = MeshDegrader(fault, self.health,
                                         registry=registry,
                                         clock=fault_clock)
        if max_batch is None:
            max_batch = max(1, max_batch_per_chip) * nd
        max_batch = -(-max_batch // nd) * nd
        self.scheduler = (scheduler if scheduler is not None
                          else MeshScheduler(registry=registry, halo=halo,
                                             devices=slots))
        self.n_devices = nd
        super().__init__(
            registry=registry, max_batch=max_batch, device=slots[0],
            spatial_grid=(self.scheduler.spatial_grid()
                          if nd > 1 else None),
            halo=halo)
        #: signature -> memoized spatial runner (built on first launch)
        self._spatial_runners: dict = {}
        #: launch keys that have run once: the stall watchdog guards only
        #: these warm launches (a first launch builds the kernels)
        self._mesh_warm: set = set()
        #: host times of the launch about to be accounted, consumed by
        #: ``_account`` (engine calls are serialized by the dispatcher)
        self._launch_times: Optional[dict] = None
        #: the last launch's roofline inputs, consumed by ``_account``
        self._launch_perf: Optional[dict] = None
        #: voluntary slot-count target (``resize``); None = all slots
        self._resize_target: Optional[int] = None
        #: one row per ``resize`` call
        self.resize_log: List[dict] = []

    # -- voluntary resize ---------------------------------------------- #

    def resize(self, n: int) -> dict:
        """Serve on the first ``n`` surviving slots from the next launch
        on (either direction, up to all slots); results stay bitwise the
        same at every size. The row carries the health fence when a fault
        policy is armed."""
        n = int(n)
        if not 1 <= n <= self.n_devices:
            raise ValueError(
                f"resize target must be in [1, {self.n_devices}], "
                f"got {n}")
        prev = (self._resize_target if self._resize_target is not None
                else self.n_devices)
        self._resize_target = None if n == self.n_devices else n
        row = {"from": prev, "to": n,
               "health_seq": (self.health.seq()
                              if self.health is not None else None)}
        self.resize_log.append(row)
        if self.registry is not None:
            self.registry.counter(
                "mesh_resize_total",
                direction=("up" if n > prev
                           else "down" if n < prev else "hold"))
            self.registry.gauge("mesh_target_devices", float(n))
        return row

    def active_devices(self) -> Tuple[int, ...]:
        """The slot indices the next launch forms its mesh over: the
        quarantine survivors, truncated to the resize target."""
        devs = (self.health.survivors() if self.health is not None
                else tuple(range(self.n_devices)))
        t = self._resize_target
        return devs if t is None else devs[:t]

    # -- dispatch ------------------------------------------------------ #

    def solve_batch(self, requests) -> List[Tuple["object", int]]:
        req0 = requests[0]
        decision = self.scheduler.decide(req0)
        route = decision["route"]
        if (self.health is not None and route == "spatial"
                and self.health.quarantined()):
            # The spatial program spans every slot, quarantined ones
            # included: the signature rides the survivor batch mesh.
            if self.registry is not None:
                self.registry.counter("mesh_fallback_total",
                                      reason="quarantined")
            decision = dict(decision, route="batch",
                            reason="quarantined")
            route = "batch"
        if route == "spatial" and self._resize_target is not None:
            if self.registry is not None:
                self.registry.counter("mesh_fallback_total",
                                      reason="resized")
            decision = dict(decision, route="batch", reason="resized")
            route = "batch"
        if route == "batch":
            return self._solve_batch_mesh(requests, decision)
        if route == "spatial":
            return self._solve_spatial(requests, decision)
        if self.registry is not None:
            self.registry.counter("mesh_fallback_total",
                                  reason=decision.get("reason",
                                                      "unknown"))
        return self._solve_single(requests, decision)

    def _solve_single(self, requests,
                      decision) -> List[Tuple["object", int]]:
        """The inherited single-device launch; with a fault policy armed
        it is pinned to the first surviving slot and its row stamps that
        slot and the health fence."""
        if self.health is None:
            out = super().solve_batch(requests)
            self._tag_launch(decision)
            return out
        seq = self.health.seq()
        survivors = self.health.survivors()
        if not survivors:
            raise Rejected(
                "mesh_degraded",
                "every device in the mesh is quarantined",
                quarantined=list(self.health.quarantined()))
        chaos.launch_point()
        out = self._solve_on(requests, self.devices[survivors[0]])
        self._tag_launch(decision)
        mesh_row = self.launch_log[-1]["mesh"]
        mesh_row["devices"] = [survivors[0]]
        mesh_row["health_seq"] = seq
        return out

    def _tag_launch(self, decision, capacity=None) -> None:
        row = self.launch_log[-1]
        row["mesh"] = {"route": decision["route"],
                       "reason": decision.get("reason"),
                       "n_devices": self.n_devices}
        if capacity is not None:
            row["mesh"]["capacity"] = capacity
        if self.registry is not None:
            self.registry.counter("mesh_launches_total",
                                  route=decision["route"])

    # -- batch-axis route ---------------------------------------------- #

    def _solve_batch_mesh(self, requests,
                          decision) -> List[Tuple["object", int]]:
        chaos.launch_point()
        req0 = requests[0]
        tuned = self._preresolve_tuned(req0)
        n = len(requests)
        if self.degrader is None:
            active = self.active_devices()
            subset = (None if len(active) == self.n_devices
                      else active)
            u, steps_done, capacity, _ab = self._launch_batch(
                requests, subset, False)
            self._account(req0, n, capacity, tuned, decision,
                          devices=subset)
            return [(u[i], steps_done[i]) for i in range(n)]
        return self._solve_batch_guarded(requests, decision, tuned)

    def _launch_batch(self, requests, device_indices, abft: bool):
        """One mesh launch attempt over the slots ``device_indices`` (None
        = all slots), without accounting: ``(u, steps_done, capacity,
        abft_block)`` with ``u`` on the host. The real members are read
        back; with ``abft`` the whole padded batch (the verify tier checks
        the pads too)."""
        chaos.mesh_launch_point()
        from heat2d_tpu_torch.mesh.runner import (mesh_batch_runner,
                                                  mesh_capacity)
        from heat2d_tpu_torch.models import ensemble

        t0 = time.perf_counter()
        req0 = requests[0]
        n = len(requests)
        nd = (self.n_devices if device_indices is None
              else len(device_indices))
        capacity = mesh_capacity(n, self.max_batch, nd)
        cxs = [r.cx for r in requests]
        cys = [r.cy for r in requests]
        # Pads replicate the last real member (the single-device
        # engine's rule), up to a slot-multiple capacity.
        cxs += [cxs[-1]] * (capacity - n)
        cys += [cys[-1]] * (capacity - n)
        first = self.devices[0 if device_indices is None
                             else device_indices[0]]
        cxs, cys, u0 = ensemble._validated_batch(
            req0.nx, req0.ny, cxs, cys, None, first)
        interval, sensitivity = req0.schedule()
        runner = mesh_batch_runner(
            req0.nx, req0.ny, req0.steps, req0.method,
            convergence=req0.convergence, interval=interval,
            sensitivity=sensitivity,
            n_devices=(None if device_indices is not None
                       else self.n_devices),
            device_indices=device_indices, abft=abft,
            problem=req0.problem, devices=self.devices)
        timer = (self.registry.timer("serve_launch_s")
                 if self.registry is not None
                 else contextlib.nullcontext())
        ab = None
        meta, watch = self._perf_meta(req0, capacity, "mesh_batch", first)
        t1 = time.perf_counter()
        with timer:
            out = runner(u0, cxs, cys)
            _sync(runner.devices)
            t2 = time.perf_counter()
            if abft:
                u, k, s_obs, s_pred, scale = out
                u = u.cpu().numpy()
                steps_done = [int(x) for x in k.cpu()]
                ab = {"s_obs": s_obs.cpu().numpy(),
                      "s_pred": s_pred.cpu().numpy(),
                      "scale": scale.cpu().numpy()}
            elif req0.convergence:
                u, k = out
                steps_done = [int(x) for x in k[:n].cpu()]
                u = u[:n].cpu().numpy()
            else:
                u = out[:n].cpu().numpy()
                steps_done = [req0.steps] * n
        self._launch_times = {"setup_s": t1 - t0, "run_s": t2 - t1,
                              "readback_s": time.perf_counter() - t2}
        self._launch_perf = self._perf_of(
            runner, (u0, cxs, cys), out, meta, watch, req0, steps_done,
            t2 - t1, None, runner.devices)
        return u, steps_done, capacity, ab

    # -- the guarded (fault-tolerant) batch route ---------------------- #

    def _solve_batch_guarded(self, requests, decision,
                             tuned) -> List[Tuple["object", int]]:
        """Shrink-and-requeue (module docstring): each attempt runs on the
        current survivors under the stall watchdog; a device loss, stall
        or checksum mismatch quarantines the culprit and relaunches the
        same batch over the smaller mesh."""
        import numpy as np

        from heat2d_tpu_torch.mesh.degrade import CorruptionError
        from heat2d_tpu_torch.mesh.health import is_device_loss
        from heat2d_tpu_torch.mesh.runner import mesh_capacity
        from heat2d_tpu_torch.models import ensemble
        from heat2d_tpu_torch.ops import abft as abft_lib

        policy = self.degrader.policy
        req0 = requests[0]
        n = len(requests)
        problem = req0.problem
        if problem == "heat5":
            method = ensemble._pick_method(req0.method, req0.nx, req0.ny,
                                           self.devices[0])
            abft_armed = (policy.abft
                          and abft_lib.supported_family(method)
                          is not None)
            unsupported_reason = method
        else:
            # The recurrence is derived for heat5; the families declare
            # abft=False and serve unverified, counted.
            abft_armed = False
            unsupported_reason = f"problem_{problem}"
        if (policy.abft and not abft_armed
                and self.registry is not None):
            self.registry.counter("mesh_abft_unsupported_total",
                                  reason=unsupported_reason)
        requeues = 0
        first_cause: Optional[str] = None
        casualties: List[int] = []
        t_detect: Optional[float] = None

        while True:
            seq = self.health.seq()
            devices = self.active_devices()
            if not devices:
                raise Rejected(
                    "mesh_degraded",
                    "every device in the mesh is quarantined",
                    quarantined=list(self.health.quarantined()))
            warm_key = (req0.signature(),
                        mesh_capacity(n, self.max_batch, len(devices)),
                        devices, abft_armed)
            launch = (lambda d=devices: self._launch_batch(
                requests, d, abft_armed))
            try:
                if warm_key in self._mesh_warm:
                    u, steps_done, capacity, ab = \
                        self.degrader.guarded(launch)
                else:
                    # first launch: the kernels build, so no deadline
                    # tuned for warm launches applies
                    u, steps_done, capacity, ab = launch()
                self._mesh_warm.add(warm_key)
                bit = chaos.flip_bit_point()
                if bit is not None:
                    # injected readback corruption: one exponent bit of
                    # member 0's centre cell, on the host
                    u = u.copy()
                    u.view(np.uint32)[0, req0.nx // 2,
                                      req0.ny // 2] ^= np.uint32(1 << bit)
                if abft_armed:
                    self._abft_verify(req0, u, steps_done, ab,
                                      devices, capacity, policy)
                break
            except BaseException as e:  # noqa: BLE001 — classified
                if isinstance(e, MeshStallError):
                    cause, newly = "mesh_stall", self.degrader.on_stall()
                elif isinstance(e, CorruptionError):
                    cause = "silent_corruption"
                    newly = self.degrader.on_corruption(e)
                elif is_device_loss(e):
                    cause = "device_fail"
                    newly = self.degrader.on_device_lost(e)
                    if not newly:
                        # names no slot and the probes convict nobody:
                        # not a device fault, so a requeue would rerun
                        # the same failing launch
                        raise
                else:
                    raise       # not a device-domain failure
                if t_detect is None:
                    t_detect = self.degrader.now()
                first_cause = first_cause or cause
                casualties.extend(d for d in newly
                                  if d not in casualties)
                if (requeues >= policy.max_requeues
                        or not self.health.survivors()):
                    if cause == "mesh_stall":
                        raise Rejected(
                            "mesh_stall",
                            f"mesh launch stalled past the "
                            f"{policy.stall_deadline_s}s deadline "
                            f"({requeues} requeues spent)",
                            quarantined=list(
                                self.health.quarantined())) from e
                    raise
                requeues += 1
                self.degrader.record_requeue(cause)
        recovery = None
        if first_cause is not None:
            recovery = self.degrader.record_recovery(
                first_cause, casualties, t_detect, devices, requeues)
        self._account(req0, n, capacity, tuned, decision,
                      devices=devices, health_seq=seq,
                      recovery=recovery)
        return [(u[i], steps_done[i]) for i in range(n)]

    def _abft_verify(self, req0, u, steps_done, ab, devices,
                     capacity, policy) -> None:
        """The verify tier's host half: the checksum of the buffer about
        to be served and the on-device observation, both against the
        on-device prediction. A mismatch raises ``CorruptionError``
        naming the owning slots."""
        import numpy as np

        from heat2d_tpu_torch.mesh.degrade import (CorruptionError,
                                                   member_owner)
        from heat2d_tpu_torch.ops import abft

        s_pred = ab["s_pred"]
        scale = ab["scale"]
        k = np.asarray(steps_done, np.float64)
        f = policy.abft_tol_factor
        bad = (abft.classify(abft.host_checksum(u), s_pred, scale, k,
                             factor=f)
               | abft.classify(ab["s_obs"], s_pred, scale, k,
                               factor=f))
        if self.registry is not None:
            self.registry.counter("mesh_abft_checked_total",
                                  value=float(capacity))
        members = [int(m) for m in np.nonzero(bad)[0]]
        if not members:
            return
        owners = sorted({member_owner(m, capacity, devices)
                         for m in members})
        if self.registry is not None:
            self.registry.counter("mesh_abft_mismatch_total",
                                  value=float(len(members)))
        raise CorruptionError(members, owners)

    # -- spatial route ------------------------------------------------- #

    def _spatial_runner(self, req0, decision):
        from heat2d_tpu_torch.models import ensemble

        sig = req0.signature()
        runner = self._spatial_runners.get(sig)
        if runner is not None:
            return runner
        gx, gy = decision["spatial_grid"]
        interval, sensitivity = req0.schedule()
        runner = ensemble.spatial_batch_runner(
            req0.nx, req0.ny, req0.steps, gx, gy,
            convergence=req0.convergence, interval=interval,
            sensitivity=sensitivity, halo=self.halo,
            n_devices=self.n_devices, devices=self.devices)
        self._spatial_runners[sig] = runner
        # the plan row now records that the mesh program was built, and
        # on what mesh
        plan = self.halo_plans.get(sig)
        if plan is not None:
            plan["compiled"] = True
            plan["mesh"] = (gx, gy)
            plan["local_batch"] = runner.nb
        if self.registry is not None:
            self.registry.counter("mesh_spatial_compiled_total")
        return runner

    def _solve_spatial(self, requests,
                       decision) -> List[Tuple["object", int]]:
        chaos.launch_point()
        from heat2d_tpu_torch.mesh.runner import mesh_capacity
        from heat2d_tpu_torch.models import ensemble

        req0 = requests[0]
        tuned = self._preresolve_tuned(req0, spatial=True)
        runner = self._spatial_runner(req0, decision)
        n = len(requests)
        # one wave advances nb members (a submesh row each), so the
        # capacities are nb multiples
        capacity = mesh_capacity(n, self.max_batch, runner.nb)

        def launch():
            chaos.mesh_launch_point()
            t0 = time.perf_counter()
            cxs = [r.cx for r in requests]
            cys = [r.cy for r in requests]
            cxs += [cxs[-1]] * (capacity - n)
            cys += [cys[-1]] * (capacity - n)
            cxs, cys, u0 = ensemble._validated_batch(
                req0.nx, req0.ny, cxs, cys, None, self.devices[0])
            meta, watch = self._perf_meta(req0, capacity, "mesh_spatial",
                                          self.devices[0])
            t1 = time.perf_counter()
            out = u, k = runner(u0, cxs, cys)
            _sync(self.devices)
            t2 = time.perf_counter()
            steps_done = [int(s) for s in k[:n].cpu()]
            u = u[:n].cpu().numpy()
            self._launch_times = {"setup_s": t1 - t0, "run_s": t2 - t1,
                                  "readback_s": time.perf_counter() - t2}
            # the spatial route steps the golden loop in torch ops
            self._launch_perf = self._perf_of(
                runner, (u0, cxs, cys), out, meta, watch, req0,
                steps_done, t2 - t1, "jnp", self.devices)
            return u, steps_done

        timer = (self.registry.timer("serve_launch_s")
                 if self.registry is not None
                 else contextlib.nullcontext())
        if self.degrader is None:
            with timer:
                u, steps_done = launch()
            self._account(req0, n, capacity, tuned, decision)
            return [(u[i], steps_done[i]) for i in range(n)]
        return self._spatial_guarded(requests, decision, tuned,
                                     capacity, launch, timer)

    def _spatial_guarded(self, requests, decision, tuned, capacity,
                         launch, timer) -> List[Tuple["object", int]]:
        """The spatial route's fault tier: the launch runs under the stall
        watchdog (warm launches only) and a device-domain failure is
        classified: the culprit is quarantined and the same batch
        re-dispatches through ``solve_batch``, which then reroutes it onto
        the survivor batch mesh."""
        from heat2d_tpu_torch.mesh.health import is_device_loss

        req0 = requests[0]
        n = len(requests)
        warm_key = (req0.signature(), capacity, "spatial")
        try:
            if warm_key in self._mesh_warm:
                with timer:
                    u, steps_done = self.degrader.guarded(launch)
            else:
                with timer:
                    u, steps_done = launch()
            self._mesh_warm.add(warm_key)
        except BaseException as e:  # noqa: BLE001 — classified
            t_detect = self.degrader.now()
            if isinstance(e, MeshStallError):
                cause, newly = "mesh_stall", self.degrader.on_stall()
                if not newly:
                    raise Rejected(
                        "mesh_stall",
                        "spatial mesh launch stalled past the "
                        f"{self.degrader.policy.stall_deadline_s}s "
                        "deadline and the probe sweep convicted no "
                        "device") from e
            elif is_device_loss(e):
                cause = "device_fail"
                newly = self.degrader.on_device_lost(e)
                if not newly:
                    raise
            else:
                raise
            self.degrader.record_requeue(cause)
            out = self.solve_batch(requests)
            self.degrader.record_recovery(
                cause, newly, t_detect,
                tuple(self.health.survivors()), 1)
            return out
        self._account(req0, n, capacity, tuned, decision)
        return [(u[i], steps_done[i]) for i in range(n)]

    # -- roofline and cost cards --------------------------------------- #

    @staticmethod
    def _perf_meta(req0, capacity, route, device):
        """The cost card's meta of a launch and the ``LaunchWatch`` to take
        before it, or (None, None) when the perf observer is off."""
        from heat2d_tpu_torch.obs import perf
        if not perf.enabled():
            return None, None
        meta = {"signature": str(req0.signature()), "nx": req0.nx,
                "ny": req0.ny, "steps": req0.steps, "method": req0.method,
                "convergence": req0.convergence, "capacity": capacity,
                "dtype": "float32", "problem": req0.problem,
                "route": route}
        return meta, perf.launch_watch(meta, device)

    @staticmethod
    def _perf_of(runner, args, out, meta, watch, req0, steps_done,
                 run_s, route, devices) -> dict:
        """What ``_account``'s roofline stamp needs of a launch: its
        seconds to the device's end, the mean steps done, the route the
        byte model takes (None: as the dispatch resolves it), the cards
        its slots span and the cost card when perf is armed."""
        from heat2d_tpu_torch.obs import perf
        card = None
        if meta is not None:
            if route is not None:
                meta = dict(meta, model_method=route)
            card = perf.observe_launch(runner, args, meta=meta,
                                       outputs=out, watch=watch)
        return {"elapsed_s": run_s,
                "steps": (sum(steps_done) / len(steps_done)
                          if req0.convergence else req0.steps),
                "route": route, "card": card,
                "device": args[0].device, "cards": len(set(devices))}

    # -- shared accounting --------------------------------------------- #

    def _account(self, req0, n, capacity, tuned, decision,
                 devices=None, health_seq=None,
                 recovery=None) -> None:
        """The launch bookkeeping of both mesh routes (launch_log,
        first_launch, serve metrics, the launch's host times). Guarded
        launches also stamp the slots they ran on, the health fence taken
        when those were chosen (``degrade.serving_invariant`` checks it)
        and the recovery row when the launch survived a requeue."""
        from heat2d_tpu_torch.models import ensemble
        self.launches += 1
        compile_key = (req0.signature(), capacity, decision["route"],
                       devices)
        first_launch = compile_key not in self._launched
        self._launched.add(compile_key)
        slots = self.n_devices if devices is None else len(devices)
        row = {"signature": req0.signature(), "occupancy": n,
               "capacity": capacity, "problem": req0.problem,
               "tuned_config": ensemble.tuned_for_launch(
                   tuned, -(-capacity // slots)),
               "first_launch": first_launch}
        times, self._launch_times = self._launch_times, None
        if times is not None:
            row.update(times)
        if self.spatial_grid is not None:
            row["halo_plan"] = self.halo_plans.get(req0.signature())
        lp, self._launch_perf = self._launch_perf, None
        if lp is not None:
            from heat2d_tpu_torch.obs import roofline
            roofline.stamp_launch_row(
                row, self.registry, nx=req0.nx, ny=req0.ny,
                steps=lp["steps"], members=capacity,
                elapsed_s=lp["elapsed_s"], method=req0.method,
                signature=str(req0.signature()), card=lp["card"],
                problem=req0.problem, device=lp["device"],
                route=lp["route"], cards=lp["cards"])
        self.launch_log.append(row)
        if self.registry is not None:
            self.registry.counter("serve_launches_total")
            self.registry.counter("problem_requests_total",
                                  problem=req0.problem)
        self._tag_launch(decision, capacity=capacity)
        if devices is not None:
            mesh_row = self.launch_log[-1]["mesh"]
            mesh_row["devices"] = list(devices)
            mesh_row["health_seq"] = health_seq
            mesh_row["degraded"] = len(devices) < self.n_devices
            if recovery is not None:
                mesh_row["recovery"] = dict(recovery)

    def fault_snapshot(self) -> Optional[dict]:
        """The run record's ``mesh_fault`` block: policy, recovery
        episodes, quarantine book and the serving invariant over this
        engine's launch log (None without a fault policy)."""
        if self.degrader is None:
            return None
        from heat2d_tpu_torch.mesh.degrade import serving_invariant
        snap = self.degrader.snapshot()
        snap["invariant"] = serving_invariant(self.health,
                                              self.launch_log)
        return snap
