"""The mesh scheduler: the batch-vs-spatial split per signature, and
admission control on modeled mesh capacity. The port of
``heat2d_tpu/mesh/scheduler.py``.

- ``MeshScheduler.decide(req0)``: one routing decision per serve
  signature, memoized:

  * **batch**: the member fits one card's on-chip memory, so the win is
    throughput: split the padded member axis over the slots
    (``mesh/runner.py``);
  * **spatial**: the member's grid exceeds ``spatial_bytes_threshold``,
    so the win is latency: decompose each member over a near-square
    submesh (``ensemble.spatial_batch_runner``, its halo plan from
    ``spatial_halo_plan``);
  * **single**: what the mesh cannot take (one slot, a request kind other
    than solve, a family other than heat5 past the threshold, a
    ``tier="unplannable"`` shape), served by the single-device engine and
    counted in ``mesh_fallback_total{reason}``, never rejected.

  The threshold defaults to the card's on-chip total, one block's shared
  memory on every SM (``ops.resident.on_chip_bytes``: 132 SMs x 227 KiB
  on the H100), the largest member one card keeps on chip, the role the
  JAX package gives its own accelerator's on-chip memory.
  ``spatial_bytes_threshold=`` sets it explicitly (tests).

- ``MeshAdmission``: charges every admitted solve its cell updates
  (``nx * ny * steps``, the convergence budget an upper bound) to a
  sliding window, and sheds a leader whose work would push the window's
  offered rate past ``headroom x`` the modeled mesh capacity (slots x
  per-slot rate) with ``Rejected("mesh_saturated")`` before it queues.
  Cache hits and coalesced followers never reach it.

With a multi-process ``world`` (``dist.runtime.DistWorld``) the spatial
row also prices its seams (``links``): the census of the submesh's
xy-adjacent slot pairs by link class over the world's host-major order
(``dist/mesh.py``) and the modeled seconds one step's edge traffic costs
on the port's route (``tune/measure.route_bytes_per_s``: the H100's link
figures between slots of one process, the host-staged rate measured on
the H100 between processes).

Both read the tuning db's measured rate for a request's shape on the
slots' device kind (``tuned_rate_mcells``), when a db is active.
"""

from __future__ import annotations

import time
from typing import Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock
from heat2d_tpu_torch.config import ConfigError
from heat2d_tpu_torch.serve.schema import Rejected

#: The admission model's per-slot rate when none is given: deliberately
#: conservative, since an overestimate would never shed.
DEFAULT_PER_CHIP_MCELLS_PER_S = 500.0


def grid_bytes(nx: int, ny: int, itemsize: int = 4,
               problem: str = "heat5") -> int:
    """One member's bytes, the resource model's unit: the grid times the
    family's state-array count (``problems.base.state_arrays``)."""
    from heat2d_tpu_torch.problems.base import state_arrays
    return int(nx) * int(ny) * itemsize * state_arrays(problem)


def tuned_rate_mcells(nx: int, ny: int, dtype: str = "float32",
                      device=None) -> Optional[float]:
    """The tuning db's measured Mcells/s for this shape on ``device``'s
    kind (``tune.runtime.measured_rate``: the lookup ladder of every
    consult), or None without a db or an entry: the admission model's
    per-slot rate source."""
    from heat2d_tpu_torch.tune import runtime as tune_runtime
    return tune_runtime.measured_rate(nx, ny, dtype, device=device)


def _check_world(world) -> None:
    from heat2d_tpu_torch.dist.runtime import DistWorld
    if world is not None and not isinstance(world, DistWorld):
        raise ConfigError(
            f"world= takes a dist.runtime.DistWorld, got "
            f"{type(world).__name__}")


class MeshScheduler:
    """Per-signature routing decisions over the slots (``n_devices`` of
    ``devices``, default the visible cards). ``demand_source``: an
    optional ``(registry, prefix)`` naming the per-signature request
    counters demand is read from (``serve_signature_requests_total``
    in-process). ``halo`` is the spatial route's requested halo."""

    def __init__(self, n_devices: Optional[int] = None, registry=None,
                 halo: str = "fused",
                 spatial_bytes_threshold: Optional[int] = None,
                 demand_source=None, world=None, devices=None):
        from heat2d_tpu_torch.mesh.runner import attached_devices
        from heat2d_tpu_torch.obs.metrics import CounterDeltas

        _check_world(world)
        slots = attached_devices(n_devices, devices)
        self.n_devices = len(slots)
        #: the slots' device: the tuning db's consults read its kind
        self.device = slots[0]
        self.registry = registry
        self.halo = halo
        if spatial_bytes_threshold is None:
            from heat2d_tpu_torch.ops.resident import on_chip_bytes
            spatial_bytes_threshold = on_chip_bytes(slots[0])
        self.spatial_bytes_threshold = int(spatial_bytes_threshold)
        self.demand_source = demand_source
        self.world = world
        self._deltas = CounterDeltas()
        self._decisions: dict = {}
        self._lock = AuditedLock("mesh.scheduler")

    def _demand(self, sig_str: str) -> Optional[float]:
        """Requests of this signature since the last decision (a window),
        or None without a demand source."""
        if self.demand_source is None:
            return None
        registry, prefix = self.demand_source
        if registry is None:
            return None
        total = 0.0
        for k, d in self._deltas.tick(
                registry, prefix + "_signature_requests_total").items():
            if dict(k).get("signature") == sig_str:
                total += d
        return total

    def spatial_grid(self) -> tuple:
        """The near-square submesh a spatial member decomposes over: all
        the slots (one member in flight at a time)."""
        from heat2d_tpu_torch.parallel.scaling import square_mesh
        return square_mesh(self.n_devices)

    def decide(self, req0) -> dict:
        """The memoized routing decision for ``req0``'s signature."""
        sig = req0.signature()
        with self._lock:
            hit = self._decisions.get(sig)
        if hit is not None:
            return hit
        d = self._decide(req0)
        with self._lock:
            d = self._decisions.setdefault(sig, d)
        if self.registry is not None:
            self.registry.counter("mesh_route_total", route=d["route"])
        return d

    def _decide(self, req0) -> dict:
        problem = getattr(req0, "problem", "heat5")
        bytes_ = grid_bytes(req0.nx, req0.ny, problem=problem)
        out = {
            "signature": str(req0.signature()),
            "n_devices": self.n_devices,
            "member_bytes": bytes_,
            "spatial_bytes_threshold": self.spatial_bytes_threshold,
            "demand": self._demand(str(req0.signature())),
            "tuned_mcells_per_s": tuned_rate_mcells(
                req0.nx, req0.ny, getattr(req0, "dtype", "float32"),
                device=self.device),
        }
        if getattr(req0, "request_kind", "solve") != "solve":
            return dict(out, route="single", reason="request_kind")
        if self.n_devices < 2:
            return dict(out, route="single", reason="one_device")
        if bytes_ <= self.spatial_bytes_threshold:
            return dict(out, route="batch", reason="fits_chip",
                        spatial_grid=None)
        if problem != "heat5":
            # The spatial decomposition is built on the heat5 stencil;
            # larger members of the other families are served on one
            # device, never rejected.
            return dict(out, route="single", reason="problem_spatial")
        from heat2d_tpu_torch.models import ensemble

        gx, gy = self.spatial_grid()
        plan = ensemble.spatial_halo_plan(req0.nx, req0.ny, gx, gy,
                                          halo=self.halo,
                                          device=self.device)
        if plan.get("tier") == "unplannable":
            return dict(out, route="single", reason="unplannable",
                        plan=plan)
        return dict(out, route="spatial", reason="exceeds_chip",
                    spatial_grid=(gx, gy), plan=plan,
                    links=self._seam_links(gx, gy, req0.ny))

    def _seam_links(self, gx: int, gy: int, ny: int) -> Optional[dict]:
        """The spatial row's cross-process seam pricing (module
        docstring): the seam census over the (gx, gy) arrangement of the
        world's host-major slot order, plus the bytes that cross
        processes and the modeled seconds one step's edge traffic costs
        on the port's route for each seam. None without a
        world (the one-process schedulers lose nothing) or when the
        submesh does not cover the world exactly (no arrangement to
        census)."""
        if self.world is None:
            return None
        from heat2d_tpu_torch.dist.mesh import (arrange_pod, seam_profile,
                                                seams)
        from heat2d_tpu_torch.tune.measure import route_bytes_per_s

        if gx * gy != self.world.n_devices:
            return None
        rows = arrange_pod(self.world, gx, gy)
        prof = seam_profile(self.world, rows, ny)
        per_seam = 2 * ny * 4
        procs = self.world.device_process
        cross, seconds = 0, 0.0
        for a, b in seams(rows):
            same = procs[a] == procs[b]
            cross += 0 if same else per_seam
            seconds += per_seam / route_bytes_per_s(
                self.world.link_kind(a, b), same)
        prof["cross_process_bytes_per_step"] = cross
        prof["seam_s_per_step"] = seconds
        return prof

    def decisions(self) -> dict:
        """signature -> decision row (a copy; run-record provenance)."""
        with self._lock:
            return dict(self._decisions)


class MeshAdmission:
    """Modeled-saturation admission control (module docstring). ``clock``
    is injectable so shedding scenarios are deterministic."""

    def __init__(self, n_devices: Optional[int] = None, registry=None,
                 per_chip_mcells_per_s: Optional[float] = None,
                 window_s: float = 2.0, headroom: float = 1.25,
                 clock=None, devices=None):
        from heat2d_tpu_torch.mesh.runner import attached_devices

        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if headroom <= 0:
            raise ValueError(f"headroom must be > 0, got {headroom}")
        slots = attached_devices(n_devices, devices)
        self.n_devices = len(slots)
        self.device = slots[0]
        self.registry = registry
        self.per_chip_mcells_per_s = per_chip_mcells_per_s
        self.window_s = window_s
        self.headroom = headroom
        self.clock = clock if clock is not None else time.monotonic
        self._window: list = []     # (t, cells) of admitted work
        self._lock = AuditedLock("mesh.admission")

    @staticmethod
    def work_cells(req) -> float:
        """Cell updates one request costs: nx * ny * steps (a convergence
        run's budget, the conservative side)."""
        return float(req.nx) * float(req.ny) * float(max(req.steps, 1))

    def capacity_cells_per_s(self, req=None) -> float:
        """Modeled mesh capacity: slots x per-slot rate (the explicit
        rate, else the tuning db's, else the conservative default)."""
        rate = self.per_chip_mcells_per_s
        if rate is None and req is not None:
            rate = tuned_rate_mcells(req.nx, req.ny,
                                     getattr(req, "dtype", "float32"),
                                     device=self.device)
        if rate is None:
            rate = DEFAULT_PER_CHIP_MCELLS_PER_S
        return rate * 1e6 * self.n_devices

    def admit(self, req) -> Optional[Rejected]:
        """Charge ``req`` to the window, or return
        ``Rejected("mesh_saturated")`` without charging it. Request kinds
        other than solve pass unpriced: the scheduler routes them off the
        mesh."""
        if getattr(req, "request_kind", "solve") != "solve":
            return None
        now = self.clock()
        work = self.work_cells(req)
        capacity = self.capacity_cells_per_s(req)
        limit = capacity * self.headroom * self.window_s
        with self._lock:
            cut = now - self.window_s
            self._window = [(t, w) for t, w in self._window if t > cut]
            pending = sum(w for _, w in self._window)
            ok = pending + work <= limit
            if ok:
                self._window.append((now, work))
            offered = (pending + work) / self.window_s
        self._emit(offered, capacity, shed=not ok)
        if ok:
            return None
        return Rejected(
            "mesh_saturated",
            f"modeled mesh saturation: offered {offered:.3g} cells/s "
            f"over a {self.window_s}s window exceeds {self.headroom}x "
            f"the modeled {capacity:.3g} cells/s mesh capacity "
            f"({self.n_devices} chips)",
            offered_cells_per_s=offered,
            capacity_cells_per_s=capacity)

    def _emit(self, offered: float, capacity: float, shed: bool) -> None:
        if self.registry is None:
            return
        self.registry.gauge("mesh_offered_cells_per_s", offered)
        self.registry.gauge("mesh_capacity_cells_per_s", capacity)
        if shed:
            self.registry.counter("mesh_admission_shed_total")
