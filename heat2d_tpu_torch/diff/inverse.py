"""Inverse problems: recover a field from sparse observations of the
final state (the port of ``heat2d_tpu/diff/inverse.py``).

- ``target="init"``: the initial condition ``u0``, the coefficients
  (cx, cy) known;
- ``target="diffusivity"``: a per-cell isotropic diffusivity ``kappa``
  (``kx = ky = kappa``, the variable-coefficient route), the initial
  condition known,

by Adam on the differentiable solve (``diff.adjoint.make_diff_solve``).
The loss is the mean squared mismatch over the observed cells, with an
optional Tikhonov term; a diffusivity iterate is projected into the
stability box ``[KAPPA_MIN, KAPPA_MAX]`` (``ops.stability``).

The optimizer is a host loop over one memoized loss-and-gradient runner
per compile signature (``loss_grad_runner``): the solve and its adjoint
run on the problem's device, and the host reads two scalars per
iteration. The best iterate so far is kept as a host copy
(``resil.snapshot_state``, its dtype kept), so a diverging tail never
loses it. Every iteration streams ``inverse_loss`` and
``inverse_grad_norm`` series points and the ``inverse_iterations_total``
counter into the metrics registry it is given. The hook
``utils/profiling.phase`` marks each iteration (``inverse.iteration``)
and each best-iterate copy (``inverse.snapshot``) while a profiler
records or tracing is armed (docs/PORT_DIFF.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from heat2d_tpu_torch.diff.vocab import TARGETS
from heat2d_tpu_torch.ops.stability import project_stable
from heat2d_tpu_torch.resil.snapshot import snapshot_state
from heat2d_tpu_torch.utils.device import resolve_device
from heat2d_tpu_torch.utils.profiling import phase


def synthetic_diffusivity(nx: int, ny: int, base: float = 0.08,
                          bump: float = 0.08) -> np.ndarray:
    """A smooth known kappa field for selftests: ``base`` plus an
    off-centre Gaussian bump of height ``bump``, inside the stability
    box."""
    ix = np.arange(nx, dtype=np.float32)[:, None]
    iy = np.arange(ny, dtype=np.float32)[None, :]
    gx = np.exp(-((ix - nx / 3.0) ** 2) / (2 * (nx / 6.0) ** 2))
    gy = np.exp(-((iy - 2 * ny / 3.0) ** 2) / (2 * (ny / 6.0) ** 2))
    return (base + bump * gx * gy).astype(np.float32)


def unit_reference_init(nx: int, ny: int) -> np.ndarray:
    """The reference initial condition (``ops.init.inidat``) scaled to a
    unit peak: the known init of served diffusivity recoveries, which
    keeps losses O(1) at every grid size."""
    from heat2d_tpu_torch.ops.init import inidat
    u0 = inidat(nx, ny).numpy()
    return (u0 / u0.max()).astype(np.float32)


def observation_mask(nx: int, ny: int, every: int = 3) -> np.ndarray:
    """Every ``every``-th interior cell (the edges are held and carry no
    information)."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    m = np.zeros((nx, ny), dtype=bool)
    m[1:-1:every, 1:-1:every] = True
    return m


@functools.lru_cache(maxsize=64)
def loss_grad_runner(nx: int, ny: int, steps: int, target: str,
                     adjoint: str, segment: Optional[int], method: str,
                     reg_on: bool, device: str = "cuda") -> Callable:
    """The loss-and-gradient runner of one compile signature, memoized
    (its arguments are all hashable), so that problems of one signature
    share it; everything problem-specific comes in as operands:

    ``runner(params, *, aux, mask, obs, n_obs, reg) -> (loss, grad)``

    where ``aux`` is ``(cx, cy)`` for ``target="init"`` (params is the
    candidate u0) or ``(u0,)`` for ``target="diffusivity"`` (params is
    the candidate kappa). The runner holds no state of its own, so the
    server's inverse lane and direct callers share it across threads."""
    from heat2d_tpu_torch.diff.adjoint import make_diff_solve

    coeff = "const" if target == "init" else "var"
    solve = make_diff_solve(nx, ny, steps, coeff=coeff, adjoint=adjoint,
                            segment=segment, method=method, device=device)

    def runner(params, *, aux, mask, obs, n_obs, reg):
        with torch.enable_grad():
            p = params.detach().requires_grad_()
            u = (solve(p, aux[0], aux[1]) if target == "init"
                 else solve(aux[0], p, p))
            r = (u - obs) * mask
            loss = torch.sum(r * r) / n_obs
            if reg_on:
                loss = loss + reg * torch.mean(p * p)
            (grad,) = torch.autograd.grad(loss, p)
        return loss.detach(), grad

    return runner


@dataclasses.dataclass
class AdamState:
    """The optimizer's whole state between two iterations, as host
    copies (``snapshot_state(dtype=None)``: exact). ``iteration`` counts
    completed iterations: the bias corrections depend on it, so a resumed
    run is bit for bit an uninterrupted one."""
    iteration: int
    params: np.ndarray
    m: np.ndarray
    v: np.ndarray
    best: np.ndarray
    best_loss: float
    loss_history: list
    grad_norm_history: list


@dataclasses.dataclass
class InverseSolution:
    """One finished inverse solve. ``params`` is the best-loss iterate
    (host numpy), not necessarily the last. A paused solve sets
    ``paused`` and carries the resumable ``state``."""
    params: np.ndarray
    final_loss: float
    iterations: int
    converged: bool
    grad_norm: float
    loss_history: list
    grad_norm_history: list
    paused: bool = False
    state: Optional[AdamState] = None


def adam_minimize(value_and_grad: Callable, params0, *,
                  iterations: int = 100, lr: float = 0.05,
                  beta1: float = 0.9, beta2: float = 0.999,
                  eps: float = 1e-8, project: Optional[Callable] = None,
                  tol: Optional[float] = None, registry=None,
                  series_labels: Optional[dict] = None,
                  progress: Optional[Callable] = None,
                  state: Optional[AdamState] = None,
                  pause: Optional[Callable[[int], bool]] = None
                  ) -> InverseSolution:
    """Adam with an optional projection, early stop and pause/resume.

    ``value_and_grad(params) -> (loss, grad)`` on tensors; ``params0`` a
    tensor (its device is the optimization's) or a host array;
    ``project(params) -> params`` clamps each iterate; ``tol`` stops once
    ``loss <= tol`` (``converged``); ``registry``/``series_labels``
    stream the ``inverse_loss`` / ``inverse_grad_norm`` series;
    ``progress(iteration, loss, grad_norm)`` is called after each
    evaluation. ``pause(completed_iterations)`` is polled at each
    iteration boundary; when true the solve returns ``paused=True`` with
    an ``AdamState``, which ``state`` resumes (``iterations`` stays the
    total budget)."""
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    labels = dict(series_labels or {})
    if state is None:
        params = torch.as_tensor(params0)
        m = torch.zeros_like(params)
        v = torch.zeros_like(params)
        loss_hist: list = []
        gn_hist: list = []
        best_loss = float("inf")
        # dtype=None: an f64 run's best iterate keeps f64
        best = snapshot_state(params, dtype=None)
        it = 0
    else:
        dev = torch.as_tensor(params0).device
        params = torch.as_tensor(state.params, device=dev)
        m = torch.as_tensor(state.m, device=dev)
        v = torch.as_tensor(state.v, device=dev)
        loss_hist = list(state.loss_history)
        gn_hist = list(state.grad_norm_history)
        best_loss = float(state.best_loss)
        best = snapshot_state(state.best, dtype=None)
        it = int(state.iteration)
    converged = False
    paused = False
    while it < iterations:
        if pause is not None and pause(it):
            paused = True
            break
        it += 1
        with phase("inverse.iteration"):
            loss, g = value_and_grad(params)
            loss = float(loss)
            gn = float(torch.sqrt(torch.sum(g * g)))
            loss_hist.append(loss)
            gn_hist.append(gn)
            if registry is not None:
                registry.series("inverse_loss", it, loss, **labels)
                registry.series("inverse_grad_norm", it, gn, **labels)
                registry.counter("inverse_iterations_total")
            if progress is not None:
                progress(it, loss, gn)
            if loss < best_loss:
                best_loss = loss
                with phase("inverse.snapshot"):
                    best = snapshot_state(params, dtype=None)
            if tol is not None and loss <= tol:
                converged = True
                break
            m = beta1 * m + (1.0 - beta1) * g
            v = beta2 * v + (1.0 - beta2) * g * g
            mhat = m / (1.0 - beta1 ** it)
            vhat = v / (1.0 - beta2 ** it)
            params = params - lr * mhat / (torch.sqrt(vhat) + eps)
            if project is not None:
                params = project(params)
    out_state = None
    if paused:
        out_state = AdamState(
            iteration=it, params=snapshot_state(params, dtype=None),
            m=snapshot_state(m, dtype=None), v=snapshot_state(v, dtype=None),
            best=snapshot_state(best, dtype=None), best_loss=best_loss,
            loss_history=list(loss_hist), grad_norm_history=list(gn_hist))
    return InverseSolution(
        params=best, final_loss=best_loss, iterations=it,
        converged=converged, grad_norm=gn_hist[-1] if gn_hist else 0.0,
        loss_history=loss_hist, grad_norm_history=gn_hist,
        paused=paused, state=out_state)


@dataclasses.dataclass
class InverseProblem:
    """One inverse problem over final-state observations, on ``device``
    (the card unless ``"cpu"``).

    ``obs_mask`` (bool (nx, ny)) marks the observed cells; ``obs_values``
    holds the observed final state (only masked entries are read). For
    ``target="init"`` (cx, cy) are known and u0 is recovered; for
    ``target="diffusivity"`` u0 is known (default: the reference
    ``inidat``) and the per-cell kappa is recovered."""
    nx: int
    ny: int
    steps: int
    target: str
    obs_mask: np.ndarray
    obs_values: np.ndarray
    cx: float = 0.1
    cy: float = 0.1
    u0: Optional[np.ndarray] = None     # known init (diffusivity target)
    reg: float = 0.0                    # Tikhonov weight on the params
    adjoint: str = "checkpoint"
    segment: Optional[int] = None
    method: str = "auto"
    device: Optional[str] = None

    def __post_init__(self):
        if self.target not in TARGETS:
            raise ValueError(
                f"target must be one of {TARGETS}, got {self.target!r}")
        if tuple(np.shape(self.obs_mask)) != (self.nx, self.ny) or \
                tuple(np.shape(self.obs_values)) != (self.nx, self.ny):
            raise ValueError(
                f"obs_mask/obs_values must be ({self.nx}, {self.ny})")
        if not bool(np.any(self.obs_mask)):
            raise ValueError("obs_mask selects no cells")

    # -- pieces the optimizer consumes --------------------------------- #

    def known_u0(self) -> np.ndarray:
        from heat2d_tpu_torch.ops.init import inidat
        if self.u0 is not None:
            return np.asarray(self.u0, np.float32)
        return inidat(self.nx, self.ny).numpy()

    def initial_params(self) -> np.ndarray:
        """The first iterate: the scattered observations for the init
        target, a flat mid-box field for diffusivity."""
        if self.target == "init":
            p = np.zeros((self.nx, self.ny), np.float32)
            p[self.obs_mask] = np.asarray(self.obs_values,
                                          np.float32)[self.obs_mask]
            return p
        return np.full((self.nx, self.ny), 0.1, np.float32)

    def project(self) -> Optional[Callable]:
        return project_stable if self.target == "diffusivity" else None

    def value_and_grad(self) -> Callable:
        """``params -> (loss, grad)``: the memoized runner of this
        problem's compile signature, with the observations, the known
        coefficients or init and the regularization weight bound as
        operands on the problem's device."""
        dev = resolve_device(self.device)
        runner = loss_grad_runner(self.nx, self.ny, self.steps,
                                  self.target, self.adjoint, self.segment,
                                  self.method, bool(self.reg), str(dev))

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        aux = ((f32(self.cx), f32(self.cy)) if self.target == "init"
               else (f32(self.known_u0()),))
        return functools.partial(
            runner, aux=aux, mask=f32(self.obs_mask),
            obs=f32(self.obs_values),
            n_obs=f32(np.count_nonzero(self.obs_mask)), reg=f32(self.reg))

    def solve(self, *, iterations: int = 100, lr: float = 0.05,
              tol: Optional[float] = None, registry=None,
              series_labels: Optional[dict] = None,
              progress: Optional[Callable] = None,
              state: Optional[AdamState] = None,
              pause: Optional[Callable[[int], bool]] = None
              ) -> InverseSolution:
        vg = self.value_and_grad()
        params0 = torch.as_tensor(self.initial_params(),
                                  device=resolve_device(self.device))
        return adam_minimize(
            vg, params0, iterations=iterations, lr=lr, tol=tol,
            project=self.project(), registry=registry,
            series_labels=series_labels, progress=progress, state=state,
            pause=pause)
