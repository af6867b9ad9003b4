"""Live migration of long-running inverse jobs (the port of
``heat2d_tpu/autoscale/migrate.py``; its tickets are wire-compatible
with the JAX package's: a ticket either package writes decodes in the
other, with the arrays bit for bit).

A worker being retired may be hours into an Adam recovery. Killing the
job and restarting from iteration 0 wastes the work; letting it pin
the worker defeats the drain. Migration threads the needle with the
machinery the repo already has:

1. **Pause** — ``diff.inverse.adam_minimize`` polls its ``pause``
   callback at iteration BOUNDARIES only, so the checkpoint always
   captures a consistent (params, m, v, iteration) tuple, host-copied
   from the card through ``resil.snapshot_state(dtype=None)`` (exact,
   no dtype truncation; the codec copies any tensor it is handed to the
   host too).
2. **Ship** — the ``AdamState`` plus the full problem spec serialize
   into a JSON ticket with base64 numpy payloads (the ``fleet/wire``
   grid encoding idiom): the ticket IS a wire line, transportable to
   any survivor process.
3. **Resume** — ``resume_job`` rebuilds the problem from the spec and
   continues from the absolute iteration index, on the device the
   RESUMING side chooses (the card unless ``device="cpu"``; the ticket
   carries no device). The Adam update is a deterministic function of
   the state, and the memoized ``value_and_grad`` runner launches the
   same kernels in the same order, so on one device the migrated
   trajectory — every loss, every iterate — is BITWISE-identical to
   the run that never moved (the elastic soak's oracle comparison).

``InverseJob`` is the thread-shaped handle the actuator drives: start,
pause-and-checkpoint, resume, join.
"""

from __future__ import annotations

import base64
import json
import threading
from typing import Optional

import numpy as np

from heat2d_tpu_torch.diff.inverse import AdamState, InverseProblem

#: ticket schema tag — consumers refuse tickets they don't speak
MIGRATION_SCHEMA = "heat2d-tpu/inverse-migration/v1"


# -- wire-format encoding (the fleet/wire base64-numpy idiom) ---------- #

def _host(a) -> np.ndarray:
    """A host numpy copy of ``a``: ``np.asarray`` of a CUDA tensor
    raises, so tensors come off their device first."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _encode_array(a) -> Optional[dict]:
    if a is None:
        return None
    a = _host(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(np.ascontiguousarray(a).tobytes())
                         .decode("ascii")}


def _decode_array(d: Optional[dict]) -> Optional[np.ndarray]:
    if d is None:
        return None
    a = np.frombuffer(base64.b64decode(d["b64"]),
                      dtype=np.dtype(d["dtype"]))
    return a.reshape([int(s) for s in d["shape"]]).copy()


def encode_state(state: AdamState) -> dict:
    """JSON-able form of an ``AdamState`` — exact: the arrays round-
    trip through raw bytes, never through decimal text."""
    return {"iteration": int(state.iteration),
            "params": _encode_array(state.params),
            "m": _encode_array(state.m),
            "v": _encode_array(state.v),
            "best": _encode_array(state.best),
            "best_loss": float(state.best_loss),
            "loss_history": [float(x) for x in state.loss_history],
            "grad_norm_history": [float(x) for x in
                                  state.grad_norm_history]}


def decode_state(d: dict) -> AdamState:
    return AdamState(
        iteration=int(d["iteration"]),
        params=_decode_array(d["params"]),
        m=_decode_array(d["m"]),
        v=_decode_array(d["v"]),
        best=_decode_array(d["best"]),
        best_loss=float(d["best_loss"]),
        loss_history=list(d["loss_history"]),
        grad_norm_history=list(d["grad_norm_history"]))


def problem_spec(problem: InverseProblem) -> dict:
    """JSON-able form of an ``InverseProblem`` (arrays base64). The
    problem's ``device`` stays out: the resuming side picks its own."""
    return {"nx": problem.nx, "ny": problem.ny,
            "steps": problem.steps, "target": problem.target,
            "obs_mask": _encode_array(problem.obs_mask),
            "obs_values": _encode_array(problem.obs_values),
            "cx": float(problem.cx), "cy": float(problem.cy),
            "u0": _encode_array(problem.u0),
            "reg": float(problem.reg), "adjoint": problem.adjoint,
            "segment": problem.segment, "method": problem.method}


def problem_from_spec(spec: dict, device=None) -> InverseProblem:
    """The ``InverseProblem`` a spec describes, on ``device`` (the card
    unless ``"cpu"``)."""
    return InverseProblem(
        nx=int(spec["nx"]), ny=int(spec["ny"]),
        steps=int(spec["steps"]), target=spec["target"],
        obs_mask=_decode_array(spec["obs_mask"]),
        obs_values=_decode_array(spec["obs_values"]),
        cx=float(spec["cx"]), cy=float(spec["cy"]),
        u0=_decode_array(spec.get("u0")),
        reg=float(spec.get("reg", 0.0)),
        adjoint=spec.get("adjoint", "checkpoint"),
        segment=spec.get("segment"),
        method=spec.get("method", "auto"), device=device)


def encode_ticket(problem: InverseProblem, state: AdamState, *,
                  iterations: int, lr: float,
                  tol: Optional[float] = None,
                  source_slot: Optional[int] = None) -> dict:
    """The migration ticket: everything a survivor needs to finish the
    job — problem, solve budget, and the mid-flight optimizer state."""
    return {"schema": MIGRATION_SCHEMA,
            "problem": problem_spec(problem),
            "solve": {"iterations": int(iterations), "lr": float(lr),
                      "tol": None if tol is None else float(tol)},
            "state": encode_state(state),
            "source_slot": source_slot}


def decode_ticket(doc) -> dict:
    """Accepts the ticket dict or its JSON line; validates the schema
    tag."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    if doc.get("schema") != MIGRATION_SCHEMA:
        raise ValueError(
            f"not an inverse-migration ticket: schema="
            f"{doc.get('schema')!r}")
    return doc


# -- the actuator's job handle ----------------------------------------- #

class InverseJob:
    """One long-running inverse solve on its own daemon thread, with a
    pause/checkpoint/resume surface (module docstring).

    The pause is COOPERATIVE: ``request_pause`` sets an event the
    optimizer polls at iteration boundaries, so ``checkpoint`` blocks
    at most one iteration (plus the first launch, if the solve is still
    cold). A job that FINISHED before the pause landed checkpoints to
    ``None`` — the caller treats that as "nothing to migrate"."""

    def __init__(self, problem: InverseProblem, *,
                 iterations: int = 200, lr: float = 0.05,
                 tol: Optional[float] = None, registry=None,
                 state: Optional[AdamState] = None,
                 source_slot: Optional[int] = None):
        self.problem = problem
        self.iterations = int(iterations)
        self.lr = float(lr)
        self.tol = tol
        self.registry = registry
        self.source_slot = source_slot
        self._state = state
        self._pause_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.solution = None
        self.error: Optional[BaseException] = None

    def start(self) -> "InverseJob":
        if self._thread is not None:
            raise RuntimeError("job already started")
        self._thread = threading.Thread(
            target=self._run, name="heat2d-inverse-job", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            self.solution = self.problem.solve(
                iterations=self.iterations, lr=self.lr, tol=self.tol,
                registry=self.registry, state=self._state,
                pause=lambda _it: self._pause_evt.is_set())
        except BaseException as e:  # noqa: BLE001 — surfaced to caller
            self.error = e

    # -- state ---------------------------------------------------------- #

    def done(self) -> bool:
        t = self._thread
        return t is not None and not t.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        if self.error is not None:
            raise self.error

    def completed_iterations(self) -> int:
        sol = self.solution
        return 0 if sol is None else int(sol.iterations)

    # -- migration ------------------------------------------------------ #

    def request_pause(self) -> None:
        self._pause_evt.set()

    def checkpoint(self, timeout: float = 120.0) -> Optional[dict]:
        """Pause at the next iteration boundary and return the wire
        ticket — or ``None`` if the job already finished (nothing to
        migrate; its ``solution`` stands)."""
        if self._thread is None:
            raise RuntimeError("job never started")
        self._pause_evt.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"inverse job did not reach an iteration boundary in "
                f"{timeout}s")
        if self.error is not None:
            raise self.error
        sol = self.solution
        if not sol.paused:
            return None
        return encode_ticket(self.problem, sol.state,
                             iterations=self.iterations, lr=self.lr,
                             tol=self.tol,
                             source_slot=self.source_slot)


def resume_job(ticket, *, registry=None, device=None) -> InverseJob:
    """Rebuild and START the job a ticket describes, on this (the
    survivor's) side of the wire, on ``device`` (the card unless
    ``"cpu"``). The total iteration budget and every solve knob ride in
    the ticket, so the finished trajectory is bitwise the unmigrated
    one's on the same device."""
    doc = decode_ticket(ticket)
    problem = problem_from_spec(doc["problem"], device=device)
    solve = doc["solve"]
    return InverseJob(
        problem, iterations=solve["iterations"], lr=solve["lr"],
        tol=solve.get("tol"), registry=registry,
        state=decode_state(doc["state"]),
        source_slot=doc.get("source_slot")).start()


def run_unmigrated(ticket_or_problem, *, iterations: int = 200,
                   lr: float = 0.05, tol: Optional[float] = None,
                   registry=None, device=None):
    """The ORACLE: the same solve, never paused, never moved. Accepts
    a ticket (budget read from it; the solve on ``device``) or a bare
    problem (budget from the kwargs; the solve on its own device).
    Returns the ``InverseSolution``."""
    if isinstance(ticket_or_problem, InverseProblem):
        problem, solve = ticket_or_problem, {
            "iterations": iterations, "lr": lr, "tol": tol}
    else:
        doc = decode_ticket(ticket_or_problem)
        problem, solve = (problem_from_spec(doc["problem"], device=device),
                          doc["solve"])
    return problem.solve(iterations=solve["iterations"],
                         lr=solve["lr"], tol=solve.get("tol"),
                         registry=registry)


__all__ = ["MIGRATION_SCHEMA", "InverseJob", "encode_state",
           "decode_state", "encode_ticket", "decode_ticket",
           "problem_spec", "problem_from_spec", "resume_job",
           "run_unmigrated"]

