"""The plain reference of the inverse configurations: the forward of
heat5's explicit update, the loss over the observed cells, and its
gradient in the initial field by the transposed step written out, in
plain PyTorch (any device), for a batch of members that each carry their
own ``(cx, cy)``.

It imports nothing of the program under test: the benchmark hands both
sides the same sizes, steps, coefficients and observations, and the
reference works the loss and the gradient out again from them.

- ``unit_init``: the upstream's ``inidat`` (``heat5.inidat``) over its
  largest value, stored in float32: the truth field whose final state is
  observed.
- ``observation_mask``: every ``every``-th interior cell along both axes
  (the edges are held, so they tell nothing of the initial field).
- ``forward``: ``A^n p``, ``n`` steps of ``heat5.step`` (the update's
  literal form, every operation rounded to the storage type).
- ``losses``: ``sum(mask * (u - obs)^2) / n_obs`` at ``u = A^n p``, the
  mean squared mismatch over the observed cells (docs/DIFFERENTIABLE.md),
  without the optional Tikhonov term.
- ``value_and_grad``: the loss and its gradient
  ``(2 / n_obs) (A^T)^n [mask (A^n p - obs)]``. The step is linear in
  the grid, so its transpose needs no stored state;
  ``step_t`` writes it out: every interior cell scatters its cotangent
  to itself times ``1 - 2cx - 2cy`` and to its four neighbours times cx
  (along the first axis) or cy (along the second), and every edge cell
  keeps its own cotangent. That is exact for the held edges: an edge
  cell's output is its input and nothing else, so its row of ``A`` is a
  unit row, and its column of ``A`` holds that 1 and the cx or cy of
  each interior neighbour that reads it, which is what the scatter
  gives it.
- ``adam``: the optimizer's best iterate of a job, Adam as the program
  documents it (docs/DIFFERENTIABLE.md) on the float64 loss and
  gradient above, so that the check sees the move the job made and not
  only the gradient it started from.

The checks take float64, the control bfloat16 (``value_and_grad`` in
that precision, every operation rounded to it). TF32 plays no part
(there is no matrix product), and its switches are set off all the
same.
"""

from __future__ import annotations

import torch

from portbench.reference import heat5


def unit_init(nx: int, ny: int, device="cpu"):
    """The truth field: ``inidat`` over its largest value, stored in
    float32 (returned in float32)."""
    u = heat5.inidat(nx, ny, torch.float64, device)
    return (u / u.max()).to(torch.float32)


def observation_mask(nx: int, ny: int, every: int, device="cpu"):
    """Every ``every``-th interior cell, from cell (1, 1): a bool
    (nx, ny) tensor."""
    m = torch.zeros((nx, ny), dtype=torch.bool, device=device)
    m[1:-1:every, 1:-1:every] = True
    return m


def _coeffs(cxs, cys, dtype, device):
    b = len(cxs)
    # the coefficients as the configuration holds them, in float32
    cx = torch.tensor(cxs, dtype=torch.float32).to(dtype).to(device)
    cy = torch.tensor(cys, dtype=torch.float32).to(dtype).to(device)
    return cx.view(b, 1, 1), cy.view(b, 1, 1)


def forward(p, steps: int, cx, cy):
    """``steps`` updates of every member of ``p`` (B, nx, ny), in p's
    dtype; ``cx``, ``cy``: (B, 1, 1) of that dtype. ``p`` is not
    changed."""
    heat5._no_tf32()
    u = p.clone()
    v = p.clone()
    for _ in range(steps):
        heat5.step(u, v, cx, cy)
        u, v = v, u
    return u


def step_t(w, out, cx, cy):
    """The transposed update ``A^T w`` of every member of ``w`` (B, nx,
    ny) into ``out`` (see the module docstring); ``cx``, ``cy``: (B, 1,
    1) of w's dtype. Each operation rounds to that dtype."""
    wi = w[:, 1:-1, 1:-1]
    # every cell starts from its own cotangent: an edge keeps it whole,
    # the interior keeps its share 1 - 2cx - 2cy; then each interior
    # cell scatters to its neighbours, edges among them
    out.copy_(w)
    out[:, 1:-1, 1:-1].sub_(torch.mul(wi, cx + cx + cy + cy))
    out[:, 2:, 1:-1].add_(torch.mul(wi, cx))
    out[:, :-2, 1:-1].add_(torch.mul(wi, cx))
    out[:, 1:-1, 2:].add_(torch.mul(wi, cy))
    out[:, 1:-1, :-2].add_(torch.mul(wi, cy))
    return out


def pullback(w, steps: int, cx, cy):
    """``(A^T)^steps w`` for every member of ``w`` (B, nx, ny), in its
    dtype; ``w`` is not changed."""
    u = w.clone()
    v = torch.empty_like(w)
    for _ in range(steps):
        step_t(u, v, cx, cy)
        u, v = v, u
    return u


def first_iterate(mask, obs32):
    """The optimizer's first iterate: the observations scattered onto
    their cells, zero elsewhere (float32, as the configuration stores
    the field)."""
    return torch.where(mask, obs32, torch.zeros_like(obs32))


def _mismatch(u, mask, obs):
    """(per member ``sum(mask * (u - obs)^2) / n_obs``, the masked
    residual, ``n_obs``), in u's dtype."""
    m = mask.to(u.dtype)
    n_obs = m.sum()
    r = (u - obs.to(u.dtype)) * m
    return (r * r).sum(dim=(-2, -1)) / n_obs, r, n_obs


def value_and_grad(p, steps: int, cxs, cys, mask, obs, *,
                   dtype=torch.float64):
    """(loss per member, gradient) at ``p`` (B, nx, ny), each member at
    its own ``(cx, cy)``, computed in ``dtype``: the forward, the loss
    and ``(2 / n_obs) (A^T)^steps [mask (A^steps p - obs)]``."""
    cx, cy = _coeffs(cxs, cys, dtype, p.device)
    lo, r, n_obs = _mismatch(forward(p.to(dtype), steps, cx, cy), mask,
                             obs)
    return lo, pullback(r * (2 / n_obs), steps, cx, cy)


def observe(truth, steps: int, cxs, cys, mask):
    """The observations of ``truth`` (nx, ny), one member per ``(cx,
    cy)``: the float64 forward's final field on the observed cells, zero
    elsewhere; a (B, nx, ny) float64 tensor."""
    b = len(cxs)
    cx, cy = _coeffs(cxs, cys, torch.float64, truth.device)
    p = truth.to(torch.float64).expand(b, *truth.shape).contiguous()
    return forward(p, steps, cx, cy) * mask


def losses(ps, steps: int, cxs, cys, mask, obs):
    """The float64 loss of each member of ``ps`` (B, nx, ny), each at its
    own ``(cx, cy)`` and observations ``obs`` (B, nx, ny)."""
    cx, cy = _coeffs(cxs, cys, torch.float64, ps.device)
    return _mismatch(forward(ps.to(torch.float64), steps, cx, cy), mask,
                     obs)[0]


def adam(p0, steps: int, cx: float, cy: float, mask, obs, *,
         iterations: int, lr: float, first=None):
    """(best iterate, its loss) of ``iterations`` Adam iterations from
    ``p0`` (nx, ny) at one ``(cx, cy)``, in float64: each iteration
    takes the loss and gradient at the iterate, keeps the iterate if its
    loss is below the best so far, then steps ``m = b1 m + (1 - b1) g``,
    ``v = b2 v + (1 - b2) g^2``, ``p -= lr mhat / (sqrt(vhat) + eps)``
    with ``mhat``, ``vhat`` the bias-corrected moments, at the
    program's b1 = 0.9, b2 = 0.999, eps = 1e-8. The last iteration's
    step moves no kept iterate, so only its loss is taken. ``first``:
    the (loss, gradient) at ``p0``, where already known."""
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    p = p0.to(torch.float64)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    best, best_loss = p, float("inf")
    for it in range(1, iterations + 1):
        if it == iterations:
            lo = losses(p[None], steps, [cx], [cy], mask, obs)[0]
        elif it == 1 and first is not None:
            lo, g = first
        else:
            lo, g = value_and_grad(p[None], steps, [cx], [cy], mask, obs)
            lo, g = lo[0], g[0]
        if float(lo) < best_loss:
            best, best_loss = p, float(lo)
        if it == iterations:
            break
        g = g.to(torch.float64)
        m = beta1 * m + (1.0 - beta1) * g
        v = beta2 * v + (1.0 - beta2) * g * g
        mhat = m / (1.0 - beta1 ** it)
        vhat = v / (1.0 - beta2 ** it)
        p = p - lr * mhat / (torch.sqrt(vhat) + eps)
    return best, best_loss


def step_gap(got, ref, start) -> float:
    """How far a job's move lies from the reference's, in float64:
    ||(got - start) - (ref - start)|| / ||ref - start||. A state left
    where it started reads 1."""
    dev = ref.device
    start = torch.as_tensor(start).to(dev, torch.float64)
    d_ref = ref.to(torch.float64) - start
    d = torch.as_tensor(got).to(dev, torch.float64) - start
    return float(torch.linalg.vector_norm(d - d_ref)
                 / torch.linalg.vector_norm(d_ref))


def gaps(g, g_ref) -> dict:
    """How far a gradient lies from the reference's, in float64:
    ``grad_gap`` = max|g - g_ref| / max|g_ref|, ``grad_rms_gap`` =
    ||g - g_ref|| / ||g_ref||. A gradient left at zero reads 1 on
    both."""
    g = torch.as_tensor(g).to(g_ref.device, torch.float64)
    g_ref = g_ref.to(torch.float64)
    d = g - g_ref
    return {"grad_gap": float(d.abs().max() / g_ref.abs().max()),
            "grad_rms_gap": float(torch.linalg.vector_norm(d)
                                  / torch.linalg.vector_norm(g_ref))}


def loss_gap(got: float, ref: float) -> float:
    """``|got - ref| / ref``."""
    return abs(float(got) - float(ref)) / float(ref)
