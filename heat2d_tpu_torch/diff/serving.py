"""Optimization loops as serving requests (the port of
``heat2d_tpu/diff/serving.py``).

An ``InverseRequest`` takes the serving path a ``SolveRequest`` takes
(validated at the door, content-hashed into the result cache and
single-flight, queued in the micro-batcher's signature buckets,
dispatched under the retry, watchdog and breaker), because it speaks the
same protocol:

- ``request_kind = "inverse"`` routes its bucket to the
  ``InverseEngine`` on the server's inverse lane (``serve/server.py``);
- ``content_hash()`` is the sha256 of the canonical spec, observations
  included, the same hash as the JAX package's for the same fields, so
  cache keys agree across the two packages;
- ``signature()`` buckets by grid, steps, target, adjoint schedule and
  iteration budget: the members of a bucket share one memoized runner
  (``inverse.loss_grad_runner``).

Observations travel as parallel tuples of (flat row-major cell index,
observed value); ``from_fields`` builds them from (mask, values) arrays
and ``mask()``/``values()`` rebuild the arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import time
from typing import ClassVar, Optional

import numpy as np

from heat2d_tpu_torch.diff.vocab import ADJOINTS, TARGETS
from heat2d_tpu_torch.serve.schema import Rejected

log = logging.getLogger("heat2d_tpu_torch.diff")


@dataclasses.dataclass(frozen=True)
class InverseRequest:
    """One inverse solve: recover ``target`` from sparse final-state
    observations by ``iterations`` of Adam at rate ``lr`` on the
    differentiable solve. Frozen — the hash of an admitted request
    must not drift in the queue (same contract as SolveRequest)."""

    nx: int
    ny: int
    steps: int
    obs_indices: tuple          # flat row-major indices of observed cells
    obs_values: tuple           # observed values, parallel to obs_indices
    target: str = "diffusivity"
    iterations: int = 100
    lr: float = 0.05
    cx: float = 0.1             # known coefficients (target="init")
    cy: float = 0.1
    tol: Optional[float] = None  # early-stop loss threshold
    reg: float = 0.0
    adjoint: str = "checkpoint"
    segment: Optional[int] = None
    dtype: str = "float32"

    #: serving-protocol tag — serve/server.py routes dispatch on it
    request_kind: ClassVar[str] = "inverse"

    # -- construction helpers ------------------------------------------ #

    @classmethod
    def from_fields(cls, nx: int, ny: int, steps: int, mask, values,
                    **kw) -> "InverseRequest":
        """Build from (nx, ny) mask/values arrays (the inverse.py
        field form)."""
        mask = np.asarray(mask, bool)
        values = np.asarray(values, np.float32)
        if mask.shape != (nx, ny) or values.shape != (nx, ny):
            raise Rejected("invalid",
                           f"mask/values must be ({nx}, {ny}), got "
                           f"{mask.shape}/{values.shape}")
        idx = np.flatnonzero(mask.ravel())
        return cls(nx=nx, ny=ny, steps=steps,
                   obs_indices=tuple(int(i) for i in idx),
                   obs_values=tuple(float(v)
                                    for v in values.ravel()[idx]),
                   **kw).validate()

    def mask(self) -> np.ndarray:
        m = np.zeros(self.nx * self.ny, bool)
        m[list(self.obs_indices)] = True
        return m.reshape(self.nx, self.ny)

    def values(self) -> np.ndarray:
        v = np.zeros(self.nx * self.ny, np.float32)
        v[list(self.obs_indices)] = np.asarray(self.obs_values,
                                               np.float32)
        return v.reshape(self.nx, self.ny)

    # -- serving protocol ---------------------------------------------- #

    def validate(self) -> "InverseRequest":
        if self.nx < 3 or self.ny < 3:
            raise Rejected("invalid", f"grid must be at least 3x3, got "
                           f"{self.nx}x{self.ny}")
        if self.steps < 0:
            raise Rejected("invalid",
                           f"steps must be >= 0, got {self.steps}")
        if self.target not in TARGETS:
            raise Rejected("invalid", f"target {self.target!r} not in "
                           f"{TARGETS}")
        if self.adjoint not in ADJOINTS:
            raise Rejected("invalid", f"adjoint {self.adjoint!r} not in "
                           f"{ADJOINTS}")
        if self.iterations < 1:
            raise Rejected("invalid", f"iterations must be >= 1, got "
                           f"{self.iterations}")
        if not self.lr > 0:
            raise Rejected("invalid", f"lr must be > 0, got {self.lr}")
        if self.tol is not None and not self.tol > 0:
            raise Rejected("invalid",
                           f"tol must be > 0 or null, got {self.tol}")
        if self.segment is not None and self.segment < 1:
            raise Rejected("invalid", f"segment must be >= 1 or null, "
                           f"got {self.segment}")
        if self.dtype != "float32":
            raise Rejected("invalid", f"dtype {self.dtype!r} not in "
                           f"('float32',)")
        n = len(self.obs_indices)
        if n == 0 or n != len(self.obs_values):
            raise Rejected("invalid",
                           "obs_indices/obs_values must be non-empty "
                           f"equal-length tuples, got {n}/"
                           f"{len(self.obs_values)}")
        cells = self.nx * self.ny
        idx = list(self.obs_indices)
        if min(idx) < 0 or max(idx) >= cells or len(set(idx)) != n:
            raise Rejected("invalid",
                           f"obs_indices must be {n} distinct flat "
                           f"indices in [0, {cells})")
        return self

    def spec(self) -> dict:
        """Canonical spec dict — all hashed fields, fixed order.
        Observations included: the DATA is part of the computation's
        identity (two masks' worth of values must never share a cache
        entry)."""
        return {
            "kind": "inverse",
            "nx": int(self.nx), "ny": int(self.ny),
            "steps": int(self.steps),
            "target": self.target,
            "iterations": int(self.iterations),
            "lr": float(self.lr),
            "cx": float(self.cx), "cy": float(self.cy),
            "tol": None if self.tol is None else float(self.tol),
            "reg": float(self.reg),
            "adjoint": self.adjoint,
            "segment": None if self.segment is None else int(self.segment),
            "dtype": self.dtype,
            "obs_indices": [int(i) for i in self.obs_indices],
            "obs_values": [float(v) for v in self.obs_values],
        }

    def content_hash(self) -> str:
        # Memoized on the frozen instance: the spec JSON covers every
        # observation point, and the hash is consulted on admission AND
        # again at dispatch — O(n_obs) serialization must happen once.
        cached = getattr(self, "_content_hash", None)
        if cached is None:
            blob = json.dumps(self.spec(), sort_keys=True,
                              separators=(",", ":"))
            cached = hashlib.sha256(blob.encode()).hexdigest()
            object.__setattr__(self, "_content_hash", cached)
        return cached

    def signature(self) -> tuple:
        """The batch-bucket key: the runner's and the loop's shape.
        Observation data and (cx, cy, lr, tol, reg) vary within a
        bucket: they are operands of the shared runner or inputs of the
        host loop. The leading tag keeps inverse buckets apart from
        solve buckets."""
        return ("inverse", self.nx, self.ny, self.steps, self.target,
                self.iterations, self.adjoint,
                0 if self.segment is None else self.segment, self.dtype)

    @classmethod
    def from_dict(cls, d: dict) -> "InverseRequest":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise Rejected("invalid",
                           f"unknown request fields: {sorted(bad)}")
        d = dict(d)
        for k in ("obs_indices", "obs_values"):
            if k in d:
                d[k] = tuple(d[k])
        try:
            return cls(**d).validate()
        except TypeError as e:
            raise Rejected("invalid", str(e)) from None


@dataclasses.dataclass
class InverseResult:
    """One served inverse solve. ``params`` is the recovered field
    (host numpy, best-loss iterate); the serving labels mirror
    SolveResult's."""

    params: "object"
    final_loss: float
    iterations: int
    converged: bool
    grad_norm: float
    content_hash: str
    cache_hit: bool = False
    coalesced: bool = False
    batch_size: int = 1
    loss_history: list = dataclasses.field(default_factory=list)

    def as_cache_hit(self) -> "InverseResult":
        return dataclasses.replace(self, cache_hit=True, coalesced=False)

    def summary(self) -> dict:
        p = np.asarray(self.params)
        return {
            "kind": "inverse",
            "content_hash": self.content_hash,
            "final_loss": float(self.final_loss),
            "iterations": int(self.iterations),
            "converged": bool(self.converged),
            "grad_norm": float(self.grad_norm),
            "cache_hit": bool(self.cache_hit),
            "coalesced": bool(self.coalesced),
            "batch_size": int(self.batch_size),
            "shape": list(p.shape),
            "params_min": float(p.min()),
            "params_max": float(p.max()),
            "params_mean": float(p.mean()),
        }


class InverseEngine:
    """Runs dispatched inverse buckets on ``device``: the members'
    optimization loops one after another, sharing one memoized runner.
    It may raise transients (the injected ``ChaosError`` of the launch
    fault point solves share); the server's retry policy absorbs them.

    An optimization loop is long-lived host work, so the engine checks
    two signals once per iteration and aborts with a structured
    ``Rejected``: ``deadline`` (the server's ``launch_deadline``, read on
    ``clock``, ``time.monotonic`` by default) and ``stop_event`` (a
    non-drain server stop interrupts the loop).

    Metrics: ``inverse_solves_total{outcome}``, the ``inverse_solve_s``
    histogram, and the optimizer's per-iteration ``inverse_loss`` /
    ``inverse_grad_norm`` series and ``inverse_iterations_total``
    (labeled by the short content hash)."""

    def __init__(self, registry=None, deadline=None, stop_event=None,
                 clock=None, device=None):
        self.registry = registry
        self.deadline = deadline
        self.stop_event = stop_event
        self.clock = time.monotonic if clock is None else clock
        self.device = device
        self.solves = 0
        self.solve_log: list = []

    def _iteration_guard(self):
        t0 = self.clock()

        def check(_it, _loss, _gn):
            if self.stop_event is not None and self.stop_event.is_set():
                raise Rejected("shutdown",
                               "server stopping mid-optimization")
            if self.deadline is not None \
                    and self.clock() - t0 > self.deadline:
                raise Rejected(
                    "watchdog_timeout",
                    f"inverse optimization exceeded the "
                    f"{self.deadline}s launch deadline")
        return check

    def solve_batch(self, requests) -> list:
        from heat2d_tpu_torch.diff.inverse import (InverseProblem,
                                                   unit_reference_init)
        from heat2d_tpu_torch.resil import chaos
        chaos.launch_point()

        guard = self._iteration_guard()
        out = []
        for req in requests:
            key = req.content_hash()
            # A diffusivity recovery starts from the canonical unit-peak
            # init: the request carries no u0, so the known init must be
            # a function of the spec alone.
            u0 = (unit_reference_init(req.nx, req.ny)
                  if req.target == "diffusivity" else None)
            problem = InverseProblem(
                nx=req.nx, ny=req.ny, steps=req.steps, target=req.target,
                obs_mask=req.mask(), obs_values=req.values(),
                cx=req.cx, cy=req.cy, u0=u0, reg=req.reg,
                adjoint=req.adjoint, segment=req.segment,
                device=self.device)
            timer = (self.registry.timer("inverse_solve_s")
                     if self.registry is not None
                     else contextlib.nullcontext())
            with timer:
                sol = problem.solve(
                    iterations=req.iterations, lr=req.lr, tol=req.tol,
                    registry=self.registry,
                    series_labels={"hash": key[:12]}, progress=guard)
            self.solves += 1
            self.solve_log.append({
                "signature": req.signature(), "content_hash": key,
                "iterations": sol.iterations,
                "final_loss": sol.final_loss,
                "converged": sol.converged})
            if self.registry is not None:
                self.registry.counter(
                    "inverse_solves_total",
                    outcome="converged" if sol.converged else "budget")
            log.debug("inverse solve %d: %dx%d target=%s iters=%d "
                      "loss=%.3e", self.solves, req.nx, req.ny,
                      req.target, sol.iterations, sol.final_loss)
            out.append(InverseResult(
                params=sol.params, final_loss=sol.final_loss,
                iterations=sol.iterations, converged=sol.converged,
                grad_norm=sol.grad_norm, content_hash=key,
                loss_history=sol.loss_history))
        return out
