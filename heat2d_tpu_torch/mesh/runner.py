"""The mesh batch runner: ``ensemble.batch_runner``'s twin with the padded
member axis split over device slots. The port of
``heat2d_tpu/mesh/runner.py``.

The slots come from ``parallel.mesh``: the visible cards, or an explicit
slot list (``host_devices(n)``: n slots that share fewer cards). Each
slot advances its contiguous share of the members through the
single-device route (H5/H6/H7 on the card for heat5, H8/H9 for the other
families); every slot's work is launched before any host read, and
convergence loops advance a chunk of each slot in turn.

Two contracts carry over, both tested:

- **Bitwise parity.** Per-member trajectories do not depend on the batch
  around them, so the runner's cropped results equal the single-device
  ``batch_runner``'s bit for bit at every occupancy rung.
- **The capacity ladder.** Capacities pad to the next power of two and
  to a slot multiple, so a signature sees at most ``log2(max_batch) + 1``
  launch shapes per mesh (the JAX package's compile bound; here it keeps
  the launch shapes and the per-member work the same on both stacks).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch


def attached_devices(n_devices: Optional[int] = None,
                     devices=None) -> list:
    """The slots: ``devices`` (default: the visible cards; raises
    ``DeviceUnavailableError`` without one), the first ``n_devices`` of
    them when given."""
    from heat2d_tpu_torch.parallel.mesh import visible_devices
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else visible_devices())]
    return devs[:n_devices] if n_devices else devs


def mesh_capacity(n: int, max_batch: int, n_devices: int) -> int:
    """Padded launch capacity for ``n`` members on ``n_devices`` slots: the
    next power of two >= n, rounded up to a slot multiple (every slot
    holds at least one member), capped at the largest slot multiple <=
    ``max_batch``."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    cap = max_batch - max_batch % n_devices or n_devices
    p = 1
    while p < n:
        p *= 2
    p = -(-p // n_devices) * n_devices     # slot multiple
    return max(min(p, cap), -(-n // n_devices) * n_devices)


@functools.lru_cache(maxsize=128)
def mesh_batch_runner(nx: int, ny: int, steps: int, method: str = "auto",
                      convergence: bool = False, interval: int = 20,
                      sensitivity: float = 0.1,
                      n_devices: Optional[int] = None,
                      device_indices: Optional[tuple] = None,
                      abft: bool = False, problem: str = "heat5",
                      devices: Optional[tuple] = None):
    """The per-(signature, slots) runner, memoized: ``(u0, cxs, cys) ->
    batch`` (fixed-step) or ``-> (batch, steps_done)`` (convergence),
    the members split over the first ``n_devices`` slots of ``devices``
    (a tuple; default the visible cards). Callers pad the batch to a
    ``mesh_capacity`` first.

    ``device_indices`` (a sorted tuple of slot indices) runs over an
    arbitrary subset of the slots instead: the shrunken mesh of the
    quarantine path (``mesh/degrade.py``), whose survivors are generally
    not a prefix.

    ``abft=True`` also returns per-member ``(steps_done, s_obs, s_pred,
    scale)``: the on-device checksum observation, the closed-form
    prediction and the tolerance scale (``ops/abft.py``), each computed
    on the slot that ran the member.

    The callable exposes ``n_devices``, ``method``, ``device_indices``,
    ``abft``, ``problem`` and ``devices`` (the slots it runs on)."""
    from heat2d_tpu_torch import vocab
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.problems import runners as prunners

    pool = attached_devices(None, devices)
    slots = ([pool[i] for i in device_indices]
             if device_indices is not None
             else attached_devices(n_devices, devices))
    nd = len(slots)
    if problem != vocab.DEFAULT_PROBLEM:
        from heat2d_tpu_torch.problems.base import spec_for
        if abft and not spec_for(problem).abft:
            raise ValueError(
                f"problem {problem!r} declares no ABFT recurrence "
                f"(problems/base.py) — gate with spec_for(...).abft "
                f"before arming the runner")
    method = ensemble._route(method, problem, nx, ny, slots[0])
    if convergence:
        loop = ensemble._conv_loop(method, problem, steps, interval,
                                   sensitivity)
    else:
        fixed = prunners.fixed_runner(problem, method)
    verify = _abft_parts(nx, ny, steps, method) if abft else None

    def run(u0, cxs, cys):
        if u0.shape[0] % nd:
            raise ValueError(
                f"mesh batch axis {u0.shape[0]} is not a multiple of "
                f"the {nd}-device mesh — pad with mesh_capacity first")
        parts = ensemble._split(u0, cxs, cys, slots)
        if convergence:
            outs = ensemble._drive_all([loop(*p) for p in parts])
        else:
            outs = [(fixed(*p, steps=steps), None) for p in parts]
        dev = u0.device
        u = ensemble._gather([o[0] for o in outs], dev)
        k = (ensemble._gather([o[1] for o in outs], dev) if convergence
             else None)
        if verify is None:
            return (u, k) if convergence else u
        checks = [verify(p, o) for p, o in zip(parts, outs)]
        k = ensemble._gather([c[0] for c in checks], dev)
        return (u, k) + tuple(ensemble._gather([c[i] for c in checks],
                                               dev) for i in (1, 2, 3))

    run.n_devices = nd
    run.method = method
    run.device_indices = device_indices
    run.abft = abft
    run.problem = problem
    run.devices = tuple(slots)
    return run


def _abft_parts(nx: int, ny: int, steps: int, method: str):
    """The verify tier's on-device half for one slot's part (``ops/abft``):
    ``verify((u0, cxs, cys), (u, k)) -> (k, s_obs, s_pred, scale)``, one
    weighted reduction over the inputs and one over the outputs per
    member."""
    import numpy as np

    from heat2d_tpu_torch.ops import abft

    family = abft.supported_family(method)
    if family is None:
        raise ValueError(
            f"method {method!r} has no ABFT recurrence — gate with "
            f"abft.supported_family before arming the runner")
    weights = {}

    def verify(part, out):
        u0, cxs, cys = part
        u, k = out
        dev = u0.device
        if dev not in weights:
            weights[dev] = torch.as_tensor(
                np.asarray(abft.mode_weights(nx, ny), np.float32),
                device=dev)
        w = weights[dev]
        if k is None:
            k = torch.full((u.shape[0],), steps, dtype=torch.int32,
                           device=dev)
        s_pred, scale = abft.predict_batch(u0, cxs, cys, k, w,
                                           family=family)
        return k, abft.observe_batch(u, w), s_pred, scale

    return verify
