"""Batched tridiagonal solves and Crank-Nicolson ADI: the implicit time
stepping of the port, ``heat2d_tpu/ops/tridiag.py`` on the H100.

One Peaceman-Rachford ADI step at diffusion numbers (cx, cy):

    half 1 (implicit in x):  (I - cx/2 dxx) u* = (I + cy/2 dyy) u
    half 2 (implicit in y):  (I - cy/2 dyy) u1 = (I + cx/2 dxx) u*

Each half is ny (resp. nx) independent constant-coefficient tridiagonal
systems with identity rows 0 and n-1, so the edges are held as in every
explicit route. The scheme is unconditionally stable: dt is chosen by
accuracy, far past the explicit box.

- ``thomas_solve``: the plain solve (forward sweep and back substitution
  in the JAX scan's division form), a ``torch.autograd.Function`` whose
  backward solves the transpose system instead of storing the sweep.
  ``adi_step``/``adi_multi_step``/``batched_adi_scan`` build on it: the
  plain ADI route (mode serial).
- Three CUDA kernels (``csrc/tridiag.cu``) solve a batch of the CN
  systems with the elimination scalars (cp, mi) of the JAX kernel TD:

  ====  =============  =====================================================
  --    ``td_coeffs``  (cp, mi) of every member, once per run; replaces
                       TD's ``_coeff_loops`` (tridiag.py:219), which runs
                       in every program of the TPU kernel
  H10   ``td_rows``    along axis 1 of (B, n, m): a warp per panel of 32
                       columns, coefficients and rhs staged in shared
                       memory; replaces ``_tridiag_rows_kernel`` (:324)
  H11   ``td_lanes``   along axis 2 of (B, rows, n): a warp per panel of 32
                       rows, 32 x 32 tiles staged and transposed in shared
                       memory so that every access is a coalesced row
                       segment; replaces ``_tridiag_lanes_kernel`` (:349)
  ====  =============  =====================================================

  (cp, mi) depend on (c, n) only: ``adi_coeffs`` computes both axes'
  once, and ``batched_adi_kernel`` hands them to every step (the solves
  take them as ``coef=``; without it a solve computes its own).
  ``adi_sweep_kernel`` runs one batched step through them: the x half
  through H10, the y half through H11, with no transpose between them.
  The half-RHS stencils and the held edges are torch ops, as they are
  XLA ops around the TPU kernel.
  The TPU route is gated on VMEM (``adi_kernel_viable``); the card has no
  such envelope, so every float32 CUDA batch takes the kernels and a CPU
  batch their plain versions, which repeat the kernels' arithmetic.
  JAX's lane-panel planner (``plan_adi_panel``) has no counterpart: the
  panels of H10 and H11 are planned from the card's SMs (``plan_td_rows``,
  ``plan_td_lanes``).

On a CPU tensor a kernel wrapper runs its plain version; on a CUDA tensor
it launches the kernel or raises. Each launch adds one to the wrapper's
entry in ``LAUNCHES``; the plain versions count nothing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops.cuda_stencil import H100_SMEM_OPTIN
from heat2d_tpu_torch.ops.resident import H100_SM_COUNT

#: Launches per kernel wrapper since the last ``reset_launch_counts``.
LAUNCHES = {"td_coeffs": 0, "td_rows": 0, "td_lanes": 0}

#: The solve kernels put the member on blockIdx.y.
MAX_MEMBERS = 65535


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


# --------------------------------------------------------------------- #
# The plain solve, with implicit differentiation
# --------------------------------------------------------------------- #

def _as_band(x, rhs):
    """A band as (n, 1, ..., 1) against ``rhs`` when it is a (n,) vector;
    bands of any other shape must already broadcast against rhs rows."""
    x = x.to(rhs.dtype)
    if x.dim() == 1:
        return x.reshape((x.shape[0],) + (1,) * (rhs.dim() - 1))
    return x


def _thomas_primal(dl, d, du, rhs):
    """Forward sweep and back substitution along axis 0, in the JAX
    scan's operations: ``m = d - dl*cp``, ``cp = du/m``, ``dp = (b -
    dl*dp)/m``, then ``x = dp - cp*x``. Row i reads ``dl[i] x[i-1] + d[i]
    x[i] + du[i] x[i+1] = rhs[i]``; every trailing slice of ``rhs`` is an
    independent system. No pivoting: the CN matrices are strictly
    diagonally dominant.

    The band recurrence (m, cp) is computed on the CPU, where a row costs
    no kernel launch, then moved to rhs's device; the operations are the
    same IEEE float32 ones either way."""
    n = rhs.shape[0]
    dl, d, du = (_as_band(x, rhs) for x in (dl, d, du))
    cdl, cd, cdu = (x.detach().cpu() for x in (dl, d, du))
    cp = torch.zeros_like(cd[0])
    ms, cps = [], []
    for i in range(n):
        m = cd[i] - cdl[i] * cp
        cp = cdu[i] / m
        ms.append(m)
        cps.append(cp)
    ms = torch.stack(ms).to(rhs.device)
    cps = torch.stack(cps).to(rhs.device)
    dl = dl.detach().to(rhs.device)
    dp = torch.zeros_like(rhs[0])
    dps = []
    for i in range(n):
        dp = (rhs[i] - dl[i] * dp) / ms[i]
        dps.append(dp)
    x = torch.zeros_like(rhs[0])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs)


class _ThomasSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dl, d, du, rhs):
        x = _thomas_primal(dl, d, du, rhs)
        ctx.save_for_backward(dl, d, du, x)
        return x

    @staticmethod
    def backward(ctx, xbar):
        """``lam = T^-T xbar`` (the transpose's bands are the shifted
        originals), then ``Tbar = -lam x^T`` on the three bands, summed
        to each band's shape."""
        dl, d, du, x = ctx.saved_tensors
        zero = torch.zeros_like(du[:1])
        dl_t = torch.cat([zero, du[:-1]])
        du_t = torch.cat([dl[1:], zero])
        lam = _thomas_primal(dl_t, d, du_t, xbar)
        zero_row = torch.zeros_like(x[:1])
        x_up = torch.cat([zero_row, x[:-1]])      # x[i-1]
        x_dn = torch.cat([x[1:], zero_row])       # x[i+1]

        def bar(prod, band):
            shape = _as_band(band, x).shape
            return (-prod).sum_to_size(shape).reshape(band.shape) \
                .to(band.dtype)

        return (bar(lam * x_up, dl), bar(lam * x, d), bar(lam * x_dn, du),
                lam)


def thomas_solve(dl, d, du, rhs):
    """Solve the tridiagonal system ``T x = rhs`` along axis 0, with
    ``T``'s bands (dl, d, du) (``dl[0]`` and ``du[n-1]`` are ignored:
    pass 0). ``rhs`` may carry trailing batch axes; a band is an (n,)
    vector or any (n, ...) shape that broadcasts against rhs rows.
    Differentiable in all four arguments: the backward pass costs one
    transpose-system solve (the JAX package's ``custom_vjp``)."""
    return _ThomasSolve.apply(dl, d, du, rhs)


# --------------------------------------------------------------------- #
# The CN-ADI step (plain route)
# --------------------------------------------------------------------- #

def _cn_bands(n: int, c):
    """Bands of ``I - (c/2) dxx`` with identity boundary rows: interior
    rows (-c/2, 1+c, -c/2), rows 0 and n-1 (0, 1, 0). ``c`` is a float32
    tensor of any shape S; the bands are (n, *S)."""
    i = torch.arange(n, device=c.device)
    interior = ((i >= 1) & (i <= n - 2)).reshape((n,) + (1,) * c.dim())
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    one = torch.ones((), dtype=c.dtype, device=c.device)
    a = torch.where(interior, -0.5 * c, zero)
    d = torch.where(interior, 1.0 + c, one)
    return a, d, a


def _rhs_half(u, c, axis: int):
    """``u + (c/2) d2(u)`` along ``axis`` (0 = rows, 1 = columns of the
    last two dims) on the interior, edges passed through. ``c``
    broadcasts: a 0-dim tensor, or (B, 1, 1) per member."""
    c = 0.5 * c
    ctr = u[..., 1:-1, 1:-1]
    if axis == 0:
        s = u[..., 2:, 1:-1] + u[..., :-2, 1:-1]
    else:
        s = u[..., 1:-1, 2:] + u[..., 1:-1, :-2]
    out = u.clone()
    out[..., 1:-1, 1:-1] = ctr + c * (s - 2.0 * ctr)
    return out


def _hold_edges(v, u):
    """``v`` with the held boundary of ``u`` restored on all four edges
    (the batched solves run the edge-column systems too)."""
    out = u.clone()
    out[..., 1:-1, 1:-1] = v[..., 1:-1, 1:-1]
    return out


def _coefs(u, cx, cy):
    """(cx, cy) as float32 tensors on u's device: 0-dim for a grid,
    (B,) for a (B, nx, ny) batch."""
    return (torch.as_tensor(cx, dtype=u.dtype, device=u.device),
            torch.as_tensor(cy, dtype=u.dtype, device=u.device))


def adi_step(u, cx, cy):
    """One Peaceman-Rachford ADI step of an (nx, ny) grid at diffusion
    numbers (cx, cy), or of a (B, nx, ny) batch at (B,) vectors (per
    member the operations of the single-grid step). Unconditionally
    stable, O(dt^2), edges held; differentiable in (u, cx, cy)."""
    cx, cy = _coefs(u, cx, cy)
    batched = u.dim() == 3
    # the rhs stencils take c per member as (B, 1, 1), the bands (B, 1)
    bx, by = (c.reshape(-1, 1) if batched else c for c in (cx, cy))
    sx, sy = (c.reshape(-1, 1, 1) if batched else c for c in (cx, cy))
    rhs1 = _rhs_half(u, sy, axis=1)
    x = thomas_solve(*_cn_bands(u.shape[-2], bx), rhs1.movedim(-2, 0))
    ustar = _hold_edges(x.movedim(0, -2), u)
    rhs2 = _rhs_half(ustar, sx, axis=0)
    y = thomas_solve(*_cn_bands(u.shape[-1], by), rhs2.movedim(-1, 0))
    return _hold_edges(y.movedim(0, -1), u)


def adi_multi_step(u, steps: int, cx, cy):
    """``steps`` ADI steps (plain route)."""
    for _ in range(steps):
        u = adi_step(u, cx, cy)
    return u


def batched_adi_scan(u0, cxs, cys, *, steps: int):
    """A (B, nx, ny) batch advanced ``steps`` ADI steps through the plain
    solve, member b at (cxs[b], cys[b])."""
    return adi_multi_step(u0, steps, cxs, cys)


# --------------------------------------------------------------------- #
# Kernels H10 / H11 and their plain versions
# --------------------------------------------------------------------- #

def _lib():
    return _build.load("tridiag")


def _check(rc: int, what: str) -> None:
    _build.check(_lib(), rc, what)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _validate(rhs, c, what: str) -> None:
    if rhs.dim() != 3 or rhs.dtype != torch.float32:
        raise ValueError(f"{what}: expected a (B, n, m) float32 batch, "
                         f"got {tuple(rhs.shape)} {rhs.dtype}")
    if min(rhs.shape) < 1:
        raise ValueError(f"{what}: empty batch {tuple(rhs.shape)}")
    if (c.dim() != 1 or c.shape[0] != rhs.shape[0]
            or c.dtype != torch.float32 or c.device != rhs.device):
        raise ValueError(f"{what}: c must be a ({rhs.shape[0]},) float32 "
                         f"vector on {rhs.device}, got {tuple(c.shape)} "
                         f"{c.dtype} on {c.device}")
    if rhs.device.type == "cuda":
        if not (rhs.is_contiguous() and c.is_contiguous()):
            raise ValueError(f"{what}: the CUDA kernels take contiguous "
                             f"tensors")
        if rhs.shape[0] > MAX_MEMBERS:
            raise ValueError(f"{what}: {rhs.shape[0]} members exceed the "
                             f"launch grid's y limit of {MAX_MEMBERS}")
    elif rhs.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {rhs.device}")


def cn_coeffs(c, n: int):
    """The elimination scalars of each member's CN matrix, as the kernels
    compute them (JAX ``_coeff_loops``): ``m = b - a*cp[i-1]``, ``mi =
    1/m``, ``cp = a/m`` with ``a = -c/2``, ``b = 1 + c`` on interior rows
    and (0, 1) on rows 0 and n-1. Returns (a_rows, cp, mi): the (n, B, 1)
    sub-diagonal per row and the two recurrences, on c's device. The
    recurrence runs on the CPU (float32, the same roundings)."""
    cc = c.detach().to("cpu", torch.float32).reshape(-1, 1)
    a = -0.5 * cc
    b = 1.0 + cc
    zero, one = torch.zeros_like(cc), torch.ones_like(cc)
    rows_a, cps, mis = [zero], [zero], [one]
    for i in range(1, n):
        ai, bi = (a, b) if i <= n - 2 else (zero, one)
        m = bi - ai * cps[-1]
        mis.append(one / m)
        cps.append(ai / m)
        rows_a.append(ai)
    return tuple(torch.stack(t).to(c.device) for t in (rows_a, cps, mis))


def td_coeffs_plain(c, n: int):
    """``td_coeffs``' plain version: ``cn_coeffs``' (cp, mi) in the
    kernels' (B, 2, n) layout."""
    _, cp, mi = cn_coeffs(c, n)
    return torch.stack([cp[:, :, 0].T, mi[:, :, 0].T], dim=1).contiguous()


def _unpack(c, n: int, coef):
    """(a_rows, cp, mi) of ``cn_coeffs`` for the plain solves: computed
    from c, or the a rows from c and (cp, mi) from a (B, 2, n) ``coef``."""
    if coef is None:
        return cn_coeffs(c, n)
    i = torch.arange(n, device=c.device).reshape(n, 1, 1)
    a = torch.where((i >= 1) & (i <= n - 2), (-0.5 * c).reshape(1, -1, 1),
                    torch.zeros((), dtype=c.dtype, device=c.device))
    return a, coef[:, 0].T.unsqueeze(-1), coef[:, 1].T.unsqueeze(-1)


def td_rows_plain(rhs, c, coef=None):
    """H10's plain version: each member's CN systems along axis 1 of the
    (B, n, m) batch, in the kernel's operations; (cp, mi) from ``coef``
    where it is given."""
    n = rhs.shape[1]
    a, cp, mi = _unpack(c, n, coef)
    prev = rhs[:, 0]
    rows = [prev]
    for i in range(1, n):
        prev = (rhs[:, i] - a[i] * prev) * mi[i]
        rows.append(prev)
    nxt = prev
    for i in range(n - 2, -1, -1):
        nxt = rows[i] - cp[i] * nxt
        rows[i] = nxt
    return torch.stack(rows, dim=1)


def td_lanes_plain(rhs, c, coef=None):
    """H11's plain version: the CN systems along axis 2 of (B, rows, n)."""
    return td_rows_plain(rhs.transpose(1, 2), c, coef).transpose(1, 2) \
        .contiguous()


def _stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def td_coeffs(c, n: int):
    """The (B, 2, n) float32 elimination scalars (cp then mi) of every
    member's CN matrix of n rows at diffusion number ``c[b]``: what the
    solves take as ``coef=``. One warp per member on the card: the
    recurrence runs until a row repeats its predecessor's cp bit for bit
    (a float fixed point, after which every interior row is the same) and
    the warp fills the rest; ``td_coeffs_plain`` on the CPU."""
    if (c.dim() != 1 or c.shape[0] < 1 or c.dtype != torch.float32
            or c.device.type not in ("cpu", "cuda")):
        raise ValueError(f"td_coeffs: c must be a (B,) float32 vector on "
                         f"the CPU or a card, got {tuple(c.shape)} "
                         f"{c.dtype} on {c.device}")
    if n < 1:
        raise ValueError(f"td_coeffs: n must be >= 1, got {n}")
    if c.device.type == "cpu":
        return td_coeffs_plain(c, n)
    if not c.is_contiguous():
        raise ValueError("td_coeffs: the CUDA kernel takes a contiguous c")
    coef = torch.empty((c.shape[0], 2, n), dtype=torch.float32,
                       device=c.device)
    LAUNCHES["td_coeffs"] += 1
    _check(_lib().heat_td_coeffs(_ptr(c), _ptr(coef), c.shape[0], n,
                                 _stream(c)), "td_coeffs")
    return coef


def _checked_coef(coef, c, n: int, what: str):
    """``coef`` validated against (c, n), or computed when None."""
    if coef is None:
        return td_coeffs(c, n)
    want = (c.shape[0], 2, n)
    if (tuple(coef.shape) != want or coef.dtype != torch.float32
            or coef.device != c.device or not coef.is_contiguous()):
        raise ValueError(f"{what}: coef must be a contiguous {want} "
                         f"float32 tensor on {c.device} (td_coeffs), got "
                         f"{tuple(coef.shape)} {coef.dtype} on "
                         f"{coef.device}")
    return coef


class RowsPlan(NamedTuple):
    warps: int        # panels of 32 systems per block (1..4)
    coef_smem: bool   # (cp, mi) staged in shared memory
    smem_bytes: int   # dynamic shared memory of a block
    blocks: int


#: H10's ring per warp (csrc/tridiag.cu: STAGES x STAGE_ROWS x 32 floats).
TD_RING_BYTES = 8 * 32 * 32 * 4
#: H11's ring per warp: STAGES slots of 32 rows x 32 columns at a row
#: stride of 33 floats (``SLOT_STRIDE``, no bank conflicts).
TD_LANES_RING_BYTES = 8 * 32 * 33 * 4


def _plan_panels(nb: int, n: int, systems: int, ring: int, sms: int,
                 smem: int) -> RowsPlan:
    """One warp per panel of 32 of a member's ``systems`` systems of n
    unknowns, as many panels a block (up to 4, all of one member) as it
    takes to put every panel in one wave of ``sms`` blocks; (cp, mi) in
    shared memory beside the ``ring``-byte rings when their 8n bytes
    (rounded up to 16) fit, else read through the read-only cache."""
    panels = -(-systems // 32)
    warps = max(1, min(4, panels, -(-nb * panels // sms)))
    coef_bytes = -(-8 * n // 16) * 16
    coef_smem = coef_bytes + warps * ring <= smem
    need = (coef_bytes if coef_smem else 0) + warps * ring
    return RowsPlan(warps, coef_smem, need, nb * -(-panels // warps))


def plan_td_rows(nb: int, n: int, m: int, sms: int = H100_SM_COUNT,
                 smem: int = H100_SMEM_OPTIN) -> RowsPlan:
    """H10's launch on a (nb, n, m) batch: panels of 32 columns
    (``_plan_panels``)."""
    return _plan_panels(nb, n, m, TD_RING_BYTES, sms, smem)


def plan_td_lanes(nb: int, rows: int, n: int, sms: int = H100_SM_COUNT,
                  smem: int = H100_SMEM_OPTIN) -> RowsPlan:
    """H11's launch on a (nb, rows, n) batch: panels of 32 rows, H10's
    rule with H11's padded rings (``_plan_panels``)."""
    return _plan_panels(nb, n, rows, TD_LANES_RING_BYTES, sms, smem)


def td_rows(rhs, c, coef=None):
    """H10: solve every member's CN systems (diffusion number ``c[b]``)
    along axis 1 of the (B, n, m) batch: a warp per panel of 32 columns
    (``plan_td_rows``). ``coef``: the (B, 2, n) ``td_coeffs(c, n)``,
    computed here when absent."""
    _validate(rhs, c, "td_rows")
    n = rhs.shape[1]
    coef = _checked_coef(coef, c, n, "td_rows")
    if rhs.device.type == "cpu":
        return td_rows_plain(rhs, c, coef)
    nb, _, m = rhs.shape
    caps = cs.device_caps(rhs.device)
    plan = plan_td_rows(nb, n, m, caps.sm_count, caps.smem_optin)
    out = torch.empty_like(rhs)
    LAUNCHES["td_rows"] += 1
    _check(_lib().heat_td_rows(_ptr(rhs), _ptr(out), _ptr(c), _ptr(coef),
                               nb, n, m, plan.warps, int(plan.coef_smem),
                               _stream(rhs)), "td_rows")
    return out


def td_lanes(rhs, c, coef=None):
    """H11: the same along axis 2 of the (B, rows, n) batch, no transpose
    of the batch: a warp per panel of 32 rows (``plan_td_lanes``), whose
    tiles are transposed in shared memory. ``coef``: the (B, 2, n)
    ``td_coeffs(c, n)``, computed here when absent."""
    _validate(rhs, c, "td_lanes")
    n = rhs.shape[2]
    coef = _checked_coef(coef, c, n, "td_lanes")
    if rhs.device.type == "cpu":
        return td_lanes_plain(rhs, c, coef)
    nb, rows, _ = rhs.shape
    caps = cs.device_caps(rhs.device)
    plan = plan_td_lanes(nb, rows, n, caps.sm_count, caps.smem_optin)
    out = torch.empty_like(rhs)
    LAUNCHES["td_lanes"] += 1
    _check(_lib().heat_td_lanes(_ptr(rhs), _ptr(out), _ptr(c), _ptr(coef),
                                nb, rows, n, plan.warps,
                                int(plan.coef_smem), _stream(rhs)),
           "td_lanes")
    return out


def adi_coeffs(u, cxs, cys):
    """The two axes' ``td_coeffs`` of a (B, nx, ny) batch: (cx over nx
    rows, cy over ny columns), what every step of a run shares."""
    return td_coeffs(cxs, u.shape[-2]), td_coeffs(cys, u.shape[-1])


def adi_sweep_kernel(u, cxs, cys, coefs=None):
    """One batched ADI step of the (B, nx, ny) batch: the x half through
    H10, the y half through H11; ``cxs``/``cys`` are (B,) float32 vectors
    on u's device, ``coefs`` their ``adi_coeffs`` (computed when
    absent)."""
    cb, db = cxs.reshape(-1, 1, 1), cys.reshape(-1, 1, 1)
    _validate(u, cxs, "adi_sweep_kernel")
    _validate(u, cys, "adi_sweep_kernel")
    kx, ky = adi_coeffs(u, cxs, cys) if coefs is None else coefs
    ustar = _hold_edges(td_rows(_rhs_half(u, db, 1), cxs, kx), u)
    return _hold_edges(td_lanes(_rhs_half(ustar, cb, 0), cys, ky), u)


def batched_adi_kernel(u0, cxs, cys, *, steps: int, coefs=None):
    """``steps`` batched ADI steps through the kernels, the time loop on
    the host (two solver launches and the torch ops around them per
    step); each axis's (cp, mi) computed once (``adi_coeffs``) unless
    ``coefs`` brings them."""
    if steps <= 0:
        return u0
    if coefs is None:
        _validate(u0, cxs, "batched_adi_kernel")
        _validate(u0, cys, "batched_adi_kernel")
        coefs = adi_coeffs(u0, cxs, cys)
    u = u0
    for _ in range(steps):
        u = adi_sweep_kernel(u, cxs, cys, coefs)
    return u
