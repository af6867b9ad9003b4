"""The plain reference of the heat5 configurations: the upstream's
``inidat``, its explicit update, and the hybrid build's convergence check,
in plain PyTorch (any device), for a batch of members that each carry
their own ``(cx, cy)``.

It imports nothing of the program under test and takes nothing the
program made: the benchmark hands both sides the same sizes, steps and
coefficients, and the reference works the grid out again from them.

- ``inidat``: ``u[ix][iy] = ix*(nx-ix-1)*iy*(ny-iy-1)``, the upstream's
  initial field (mpi_heat2Dn.c:242-248), evaluated exactly in float64
  and stored in the storage type.
- ``step``: the update of grad1612_mpi_heat.c, ``u + cx*(n + s - 2u) +
  cy*(e + w - 2u)`` on the interior, in that order, every operation
  rounded to the storage type; the edges stay as they are.
- ``solve``: ``steps`` updates in the storage type given: the checks
  take float64, the exact solution of the discrete scheme within
  rounding that is negligible beside float32's (a float32 run of the
  same update drifts from it by up to ~7e-4 of the grid's largest value
  at 2560x2048 x 10000 steps, where the field's values near 1.7e12 make
  float32's increments coarse), and the control takes bfloat16; with
  ``interval`` the hybrid build's
  check (grad1612_hybrid_heat.c:15-17): after every ``interval`` steps,
  the sum over the grid of the squared change of the last step, and a
  stop once it falls below ``sensitivity``.

A member is one grid of the batch; the grids are stepped together, each
stopping at its own check. TF32 plays no part (there is no matrix
product), and its switches are set off all the same.
"""

from __future__ import annotations

import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def inidat(nx: int, ny: int, dtype=torch.float64, device="cpu"):
    """The upstream's initial field, exact in float64, stored in
    ``dtype``."""
    ix = torch.arange(nx, dtype=torch.float64, device=device)[:, None]
    iy = torch.arange(ny, dtype=torch.float64, device=device)[None, :]
    return (ix * (nx - ix - 1) * iy * (ny - iy - 1)).to(dtype)


def step(u, out, cx, cy):
    """One update of every member of ``u`` (B, nx, ny) into ``out``
    (whose edges already hold ``u``'s); ``cx``, ``cy``: (B, 1, 1)
    tensors of ``u``'s dtype. Each operation rounds to that dtype, in the
    update's written order."""
    c = u[:, 1:-1, 1:-1]
    ns = u[:, 2:, 1:-1] + u[:, :-2, 1:-1]
    ns.sub_(c + c)
    ew = u[:, 1:-1, 2:] + u[:, 1:-1, :-2]
    ew.sub_(c + c)
    new = torch.addcmul(c, cx, ns)
    torch.addcmul(new, cy, ew, out=out[:, 1:-1, 1:-1])
    return out


def residual(a, b):
    """Per member, the sum over the grid of ``(a - b)^2`` in float64."""
    d = a.to(torch.float64) - b.to(torch.float64)
    return (d * d).sum(dim=(1, 2))


def solve(nx: int, ny: int, steps: int, cxs, cys, *, dtype=torch.float64,
          device="cpu", interval: int = 0, sensitivity: float = 0.0):
    """Solve one member per ``(cx, cy)`` pair from ``inidat``. Returns
    ``(grids, steps_done)``: the final grids as a (B, nx, ny) tensor of
    ``dtype`` on ``device``, and each member's steps as a list.
    ``interval`` > 0 turns the convergence check on."""
    _no_tf32()
    b = len(cxs)
    u = inidat(nx, ny, dtype, device).expand(b, nx, ny).contiguous()
    v = u.clone()
    # the coefficients as the configuration holds them, in float32
    cx = torch.tensor(cxs, dtype=torch.float32).to(dtype).to(device)
    cy = torch.tensor(cys, dtype=torch.float32).to(dtype).to(device)
    cx, cy = cx.view(b, 1, 1), cy.view(b, 1, 1)
    done = [steps] * b
    live = [True] * b
    k = 0
    while k < steps:
        n = min(interval, steps - k) if interval else steps - k
        stopped = [i for i in range(b) if not live[i]]
        for _ in range(n):
            step(u, v, cx, cy)
            # a member that has stopped keeps its grid
            for i in stopped:
                v[i] = u[i]
            u, v = v, u
        k += n
        if interval and n == interval:
            res = residual(u, v).cpu()
            for i in range(b):
                if live[i] and res[i] < sensitivity:
                    live[i] = False
                    done[i] = k
            if not any(live):
                break
    return u, done


def solve_blocks(nx: int, ny: int, steps: int, cxs, cys, *, block: int,
                 **kw):
    """``solve`` over members in blocks of at most ``block``, so that a
    large sample fits: yields ``(indices, grids, steps_done)``."""
    for lo in range(0, len(cxs), block):
        hi = min(lo + block, len(cxs))
        grids, done = solve(nx, ny, steps, cxs[lo:hi], cys[lo:hi], **kw)
        yield list(range(lo, hi)), grids, done


def grid_gaps(got, ref, init) -> dict:
    """How far a program's grid lies from the reference's, each as a
    share of the change the solve made, ``ref - init`` (``init`` the
    initial field): ``grid_gap``, the widest gap over the widest change,
    ``max|got - ref| / max|ref - init|``; ``grid_rms_gap``, the gap's
    root mean square over the change's, ``||got - ref|| / ||ref -
    init||``. A grid left as it started reads 1 on both, one that did
    half the steps about 0.5; in float64."""
    got = torch.as_tensor(got).to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    init = init.to(ref.device, torch.float64)
    d = got - ref
    change = ref - init
    return {"grid_gap": float(d.abs().max() / change.abs().max()),
            "grid_rms_gap": float(torch.linalg.vector_norm(d)
                                  / torch.linalg.vector_norm(change))}


def check_answers(answers, nx: int, ny: int, steps: int, *, block: int,
                  device="cpu", interval: int = 0,
                  sensitivity: float = 0.0) -> dict:
    """The widest of each gap (``grid_gaps``) over ``answers``, a list of
    ``(cx, cy, grid, steps_done)`` the program returned, each against the
    reference's solve of its own ``(cx, cy)``, and the widest difference
    in steps done (``steps_gap``); the reference steps ``block`` members
    together."""
    init = inidat(nx, ny, torch.float64, device)
    out = {"grid_gap": 0.0, "grid_rms_gap": 0.0, "steps_gap": 0.0}
    for idx, grids, done in solve_blocks(
            nx, ny, steps, [a[0] for a in answers], [a[1] for a in answers],
            block=block, device=device, interval=interval,
            sensitivity=sensitivity):
        for j, i in enumerate(idx):
            for k, v in grid_gaps(answers[i][2], grids[j], init).items():
                out[k] = max(out[k], v)
            out["steps_gap"] = max(out["steps_gap"],
                                   float(abs(answers[i][3] - done[j])))
        del grids
    return out
