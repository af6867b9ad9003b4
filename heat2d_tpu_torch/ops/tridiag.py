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
                       memory, or per segment of its rows where the batch
                       has fewer panels than SMs (the split, below);
                       replaces ``_tridiag_rows_kernel`` (:324)
  H11   ``td_lanes``   along axis 2 of (B, rows, n): a warp per panel of 32
                       rows, 32 x 32 tiles staged and transposed in shared
                       memory so that every access is a coalesced row
                       segment; replaces ``_tridiag_lanes_kernel`` (:349)
  ====  =============  =====================================================

  (cp, mi) depend on (c, n) only: ``adi_coeffs`` computes both axes'
  once, and ``batched_adi_kernel`` hands them to every step (the solves
  take them as ``coef=``; without it a solve computes its own).
  ``adi_sweep_kernel`` runs one batched step through them, one launch a
  half: the x half through H10's right-hand-side build
  (``td_rows_rhs``), the y half through H11's (``td_lanes_rhs``), with
  no transpose between them. Each build forms its half's right-hand side
  (``_rhs_half``) as it stages the step's grid and holds the grid's
  edges (``_hold_edges``) in its stores, where the JAX package runs both
  as XLA ops around the TPU kernel; its plain version is that
  composition, which the kernel equals bit for bit.
  The TPU route is gated on VMEM (``adi_kernel_viable``); the card has no
  such envelope, so every float32 CUDA batch takes the kernels and a CPU
  batch their plain versions, which repeat the kernels' arithmetic.
  JAX's lane-panel planner (``plan_adi_panel``) has no counterpart: the
  panels of H10 and H11 are planned from the card's SMs (``plan_td_rows``,
  ``plan_td_lanes``).

H10 splits where a batch has fewer panels than the card has SMs
(``plan_td_rows``): each panel's systems run as segments of rows, a block
each, all resident at once; each segment starts its sweeps W rows early
from a guess, checks the value where it meets its neighbour's verified one
and replays its rows where the bits differ, so every stored bit is the
unsplit sweep's (``csrc/tridiag.cu``). The registry's
``td_split_segments_total`` counts, at each split launch, the segments it
runs past the first of each sweep (the speculative ones);
``td_split_replays_total`` the replays, a word on the card that
``collect_split_replays`` reads in once the work is done.

On a CPU tensor a kernel wrapper runs its plain version; on a CUDA tensor
it launches the kernel or raises. Each launch counts under the kernel's
name in ``_build.launch_counts`` (a right-hand-side build counts as its
solve kernel); the plain versions count nothing. The registry's
``adi_halves_total`` counts the ADI halves of every step loop, and
``adi_halves_fused_total`` the launches of the right-hand-side builds
among them (``_build.entry_launches`` of their entry points: every half
on a card, none on the CPU), once per call of ``adi_sweep_kernel`` or
``batched_adi_kernel``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from heat2d_tpu_torch.obs.metrics import get_registry
from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops._build import (call, device_caps, entry_launches,
                                         round_up)
from heat2d_tpu_torch.utils.profiling import phase

#: The right-hand-side builds' entry points: each launch is one ADI half
#: run as one launch. The step loops add the launches of their call to
#: the registry's ``adi_halves_fused_total``.
RHS_ENTRIES = ("heat_td_rows_rhs", "heat_td_lanes_rhs",
               "heat_td_rows_rhs_split")

#: The solve kernels put the member on blockIdx.y.
MAX_MEMBERS = 65535


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
    call("tridiag", "heat_td_coeffs", "td_coeffs", "td_coeffs", c, coef,
         c.shape[0], n)
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
    segments: int = 1   # H10: segments of rows a system runs in (split)
    seg_rows: int = 0   # H10 split: rows a segment owns (0: unsplit)
    warm_bits: int = 0  # H10 split: the warm-up's rule (below)


#: H10's ring per warp (csrc/tridiag.cu: STAGES x STAGE_ROWS x 32 floats).
TD_RING_BYTES = 8 * 32 * 32 * 4
#: H11's ring per warp: STAGES slots of 32 rows x 32 columns at a row
#: stride of 33 floats (``SLOT_STRIDE``, no bank conflicts).
TD_LANES_RING_BYTES = 8 * 32 * 33 * 4
#: The right-hand-side builds' rings: H10's ring and, beside it, its
#: producer warp's ring of 2 slots of 32 rows of 34 columns (the panel's
#: 32 and the two beside them); H11's slots of 34 rows (the panel's 32 and
#: the rows above and below it).
TD_RHS_RING_BYTES = TD_RING_BYTES + 2 * 32 * (32 + 2) * 4
TD_LANES_RHS_RING_BYTES = 8 * (32 + 2) * 33 * 4


def _plan_panels(nb: int, n: int, systems: int, ring: int, sms: int,
                 smem: int) -> RowsPlan:
    """One warp per panel of 32 of a member's ``systems`` systems of n
    unknowns, as many panels a block (up to 4, all of one member) as it
    takes to put every panel in one wave of ``sms`` blocks; (cp, mi) in
    shared memory beside the ``ring``-byte rings when their 8n bytes
    (rounded up to 16) fit, else read through the read-only cache."""
    panels = -(-systems // 32)
    warps = max(1, min(4, panels, -(-nb * panels // sms)))
    coef_bytes = round_up(8 * n, 16)
    coef_smem = coef_bytes + warps * ring <= smem
    need = (coef_bytes if coef_smem else 0) + warps * ring
    return RowsPlan(warps, coef_smem, need, nb * -(-panels // warps))


#: H10's split: a segment owns at least this many rows, so that its
#: warm-ups (at most ``WARM_MAX_ROWS`` a sweep) stay a small share.
SPLIT_MIN_ROWS = 256
#: The warm-up W of a split segment: the least multiple of 32 rows with
#: |cp|^W <= 2^-WARM_BITS at the member's fixed-point cp (96 rows at c =
#: 12.5 and 25, 160 at c = 50), at most ``WARM_MAX_ROWS`` and a segment.
#: A chain's error falls to an ulp after ~24 bits; two chains an ulp
#: apart then merge at random, and the rest is that margin.
WARM_BITS = 44
WARM_MAX_ROWS = 256
#: The join buffer of the split (``csrc/tridiag.cu``): 64-bit words, a
#: head of 32 (word 0 counts replays), then 96 a segment.
SYNC_HEAD = 32
JOIN_WORDS = 96


def warm_rows(cp: float, bits: int) -> int:
    """The kernel's warm-up at a member's fixed-point ``cp``
    (``csrc/tridiag.cu``, ``warm_rows``): the least multiple of 32 rows
    with |cp|^W <= 2^-bits by float32 products (|cp|^32 by five
    squarings), at most ``WARM_MAX_ROWS``; 0 at bits <= 0. A launch takes
    at most a segment of it."""
    if bits <= 0:
        return 0
    f = np.float32
    q = f(abs(f(cp)))
    for _ in range(5):
        q = f(q * q)
    goal, pw, rows = f(2.0 ** -bits), f(1.0), 0
    while rows < WARM_MAX_ROWS and pw > goal:
        pw = f(pw * q)
        rows += 32
    return rows


def rows_per_sm(device, rhs: bool, coef_smem: bool, smem: int) -> int:
    """Blocks of H10's split build (one panel a block) one SM of
    ``device`` holds at ``smem`` bytes: the card's occupancy
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, ``split_info``);
    for the CPU the H100's by shared memory, threads and blocks, and by
    registers at the 255 a thread may take, so never more than the card
    holds."""
    dev = torch.device(device)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return split_info(rhs, coef_smem, smem)["blocks_per_sm"]
    threads = 32 * (2 if rhs else 1)
    return min(_build.SM_SMEM_BYTES // (smem + _build.BLOCK_RESERVED_SMEM),
               _build.SM_THREADS // threads, _build.SM_BLOCKS,
               _build.SM_REGISTERS // (256 * threads))


def split_info(rhs: bool, coef_smem: bool, smem: int) -> dict:
    """H10's split build on the current card at ``smem`` bytes a block:
    registers and local (spill) bytes a thread, blocks an SM."""
    buf = (ctypes.c_int * 3)()
    call("tridiag", "heat_td_rows_split_info", None, "H10 split_info",
         int(rhs), int(coef_smem), smem, buf)
    return {"registers": buf[0], "local_bytes": buf[1],
            "blocks_per_sm": buf[2]}


def split_rows(plan: RowsPlan, nb: int, n: int, m: int, p: int,
               warm_bits: int) -> RowsPlan:
    """``plan`` (one panel a block) with each system cut into ``p``
    segments of whole 32-row stages: the last may own fewer rows, and
    fewer segments than ``p`` remain where the rounding leaves nothing for
    the last."""
    seg_rows = round_up(-(-n // p), 32)
    segments = -(-n // seg_rows)
    return plan._replace(blocks=nb * -(-m // 32) * segments,
                         segments=segments, seg_rows=seg_rows,
                         warm_bits=warm_bits)


def plan_td_rows(nb: int, n: int, m: int, device="cpu",
                 rhs: bool = False) -> RowsPlan:
    """H10's launch on a (nb, n, m) batch on ``device`` (a batch on the
    CPU plans what the H100 would): panels of 32 columns
    (``_plan_panels``); ``rhs``: the right-hand-side build's ring.

    Where the batch has fewer panels than the card has SMs, the split
    (``split_rows``): P segments a system, P the least power of two with
    ``nb * panels * P >= sm_count``, halved while a segment would own
    fewer than ``SPLIT_MIN_ROWS`` rows; taken only where the card launches
    cooperative grids and holds every block at once (``rows_per_sm``), so
    that no join waits on a block that has not started. Elsewhere the
    unsplit plan: the same grid, blocks and entry point as before the
    split existed. Each launch plans, so the plan is kept per shape, card
    and rule."""
    return _plan_rows(nb, n, m, device, rhs, WARM_BITS, SPLIT_MIN_ROWS)


@functools.lru_cache(maxsize=256)
def _plan_rows(nb: int, n: int, m: int, device, rhs: bool, warm_bits: int,
               min_rows: int) -> RowsPlan:
    caps = device_caps(device)
    plan = _plan_panels(nb, n, m, TD_RHS_RING_BYTES if rhs
                        else TD_RING_BYTES, caps.sm_count, caps.smem_optin)
    panels = -(-m // 32)
    p = 1
    while nb * panels * p < caps.sm_count and n // (2 * p) >= min_rows:
        p *= 2
    if p == 1 or not caps.cooperative:
        return plan
    split = split_rows(plan, nb, n, m, p, warm_bits)
    if split.blocks > caps.sm_count * rows_per_sm(
            device, rhs, plan.coef_smem, plan.smem_bytes):
        return plan
    return split


def plan_td_lanes(nb: int, rows: int, n: int, device="cpu",
                  rhs: bool = False) -> RowsPlan:
    """H11's launch on a (nb, rows, n) batch on ``device``: panels of 32
    rows, H10's rule with H11's padded rings (``_plan_panels``); ``rhs``:
    the right-hand-side build's slots of 34 rows."""
    caps = device_caps(device)
    return _plan_panels(nb, n, rows, TD_LANES_RHS_RING_BYTES if rhs
                        else TD_LANES_RING_BYTES, caps.sm_count,
                        caps.smem_optin)


#: The split's join buffers: (device, stream) -> [words, epoch], an int64
#: tensor zeroed once, room for ``2 * sm_count`` segments (a split plan
#: has fewer: it doubles P only while the blocks stay below the SMs), and
#: the epoch its last launch used; and the replays already read from them.
_joins: dict = {}
_replays_read = 0
#: Two threads launching on one stream never share an epoch.
_joins_lock = threading.Lock()


def _join_buffer(device, segments: int) -> tuple:
    """The join buffer of the stream a launch on ``device`` goes to and
    the next epoch on it (after 2**31 - 2 launches its joins are zeroed
    again, in stream order)."""
    room = 2 * device_caps(device).sm_count
    if segments > room:
        raise ValueError(f"H10 split: {segments} segments exceed the join "
                         f"buffer's {room}")
    words = SYNC_HEAD + room * JOIN_WORDS
    key = (device, _build._stream(device))
    with _joins_lock:
        got = _joins.get(key)
        if got is None:
            got = _joins[key] = [torch.zeros(words, dtype=torch.int64,
                                             device=device), 0]
        got[1] += 1
        if got[1] >= 2 ** 31 - 1:
            got[0][SYNC_HEAD:].zero_()
            got[1] = 1
        return got[0], got[1]


def collect_split_replays(reg=None) -> None:
    """Add the replays the cards counted since the last call to the
    registry's (``reg``'s) ``td_split_replays_total``: a read of each join
    buffer's replay word, which waits for the card, so a reader calls it
    once the work it reads is done. Adds nothing before a split launch."""
    global _replays_read
    if not _joins:
        return
    total = sum(int(w[0]) for w, _ in _joins.values())
    (reg or get_registry()).counter("td_split_replays_total",
                                    total - _replays_read)
    _replays_read = total


def _launch(kernel: str, x, c, coef, sc=None, plan=None):
    """One launch of H10 (``kernel`` "td_rows") or H11 ("td_lanes") on the
    (B, n1, n2) batch ``x`` on its card, planned from the card unless
    ``plan`` is given: the solve, or with ``sc`` (the stencil's (B,)
    diffusion numbers) the ADI half's right-hand-side build on the step's
    grid ``x``. A split plan (H10 only) goes to the split entry point with
    its join buffer and counts its speculative segments."""
    nb, n1, n2 = x.shape
    if plan is None:
        plan = (plan_td_lanes if kernel == "td_lanes" else plan_td_rows)(
            nb, n1, n2, x.device, sc is not None)
    out = torch.empty_like(x)
    entry = f"heat_{kernel}" + ("_rhs" if sc is not None else "")
    stencil = (sc,) if sc is not None else ()
    if plan.segments > 1:
        if kernel != "td_rows" or plan.warps != 1:
            raise ValueError(f"{kernel}: a split plan is H10's, one panel a "
                             f"block, got {plan}")
        words, epoch = _join_buffer(x.device, plan.blocks)
        call("tridiag", entry + "_split", kernel, kernel, x, out, c,
             *stencil, coef, words, nb, n1, n2, plan.seg_rows,
             plan.warm_bits, plan.coef_smem, epoch)
        panels = plan.blocks // plan.segments
        get_registry().counter("td_split_segments_total",
                               2 * panels * (plan.segments - 1))
        return out
    call("tridiag", entry, kernel, kernel, x, out, c, *stencil, coef, nb,
         n1, n2, plan.warps, plan.coef_smem)
    return out


def td_rows(rhs, c, coef=None, *, plan=None):
    """H10: solve every member's CN systems (diffusion number ``c[b]``)
    along axis 1 of the (B, n, m) batch: a warp per panel of 32 columns
    (``plan_td_rows``; ``plan``, a ``RowsPlan`` to launch instead, is the
    tests' way to force a split or its warm-up). ``coef``: the (B, 2, n)
    ``td_coeffs(c, n)``, computed here when absent."""
    _validate(rhs, c, "td_rows")
    coef = _checked_coef(coef, c, rhs.shape[1], "td_rows")
    if rhs.device.type == "cpu":
        return td_rows_plain(rhs, c, coef)
    return _launch("td_rows", rhs, c, coef, plan=plan)


def td_lanes(rhs, c, coef=None):
    """H11: the same along axis 2 of the (B, rows, n) batch, no transpose
    of the batch: a warp per panel of 32 rows (``plan_td_lanes``), whose
    tiles are transposed in shared memory. ``coef``: the (B, 2, n)
    ``td_coeffs(c, n)``, computed here when absent."""
    _validate(rhs, c, "td_lanes")
    coef = _checked_coef(coef, c, rhs.shape[2], "td_lanes")
    if rhs.device.type == "cpu":
        return td_lanes_plain(rhs, c, coef)
    return _launch("td_lanes", rhs, c, coef)


def td_rows_rhs_plain(u, c, s, coef=None):
    """H10's right-hand-side build, plain: the x half of an ADI step of
    the (B, n, m) batch ``u``, implicit along axis 1 at ``c``, the stencil
    along axis 2 at ``s``, u's edges held."""
    return _hold_edges(td_rows_plain(_rhs_half(u, s.reshape(-1, 1, 1), 1),
                                     c, coef), u)


def td_lanes_rhs_plain(u, c, s, coef=None):
    """H11's right-hand-side build, plain: the y half, implicit along
    axis 2 at ``c``, the stencil along axis 1 at ``s``, u's edges held."""
    return _hold_edges(td_lanes_plain(
        _rhs_half(u, s.reshape(-1, 1, 1), 0), c, coef), u)


def td_rows_rhs(u, c, s, coef=None, *, plan=None):
    """The x half of an ADI step of the (B, n, m) batch ``u`` in one H10
    launch (its right-hand-side build): each row's right-hand side at
    the stencil's ``s[b]`` formed as the kernel stages u, the solve at
    ``c[b]`` with the (B, 2, n) ``coef`` (computed when absent), u's edges
    held in its stores; bit for bit ``td_rows_rhs_plain``. ``plan`` as in
    ``td_rows``."""
    _validate(u, c, "td_rows_rhs")
    _validate(u, s, "td_rows_rhs")
    coef = _checked_coef(coef, c, u.shape[1], "td_rows_rhs")
    if u.device.type == "cpu":
        return td_rows_rhs_plain(u, c, s, coef)
    return _launch("td_rows", u, c, coef, s, plan=plan)


def td_lanes_rhs(u, c, s, coef=None):
    """The y half in one H11 launch: implicit along axis 2 of u at
    ``c[b]``, the stencil along axis 1 at ``s[b]``; bit for bit
    ``td_lanes_rhs_plain``."""
    _validate(u, c, "td_lanes_rhs")
    _validate(u, s, "td_lanes_rhs")
    coef = _checked_coef(coef, c, u.shape[2], "td_lanes_rhs")
    if u.device.type == "cpu":
        return td_lanes_rhs_plain(u, c, s, coef)
    return _launch("td_lanes", u, c, coef, s)


def adi_coeffs(u, cxs, cys):
    """The two axes' ``td_coeffs`` of a (B, nx, ny) batch: (cx over nx
    rows, cy over ny columns), what every step of a run shares. The
    hook's span ``adi.coeffs`` covers the pass."""
    with phase("adi.coeffs"):
        return td_coeffs(cxs, u.shape[-2]), td_coeffs(cys, u.shape[-1])


def _count_halves(halves: int, launches_before: int) -> None:
    """Add a step loop's ``halves`` and the right-hand-side builds it
    launched (``RHS_ENTRIES``' launches since ``launches_before``) to the
    registry."""
    reg = get_registry()
    reg.counter("adi_halves_total", halves)
    reg.counter("adi_halves_fused_total",
                entry_launches(*RHS_ENTRIES) - launches_before)


def _sweep(u, cxs, cys, coefs):
    with phase("adi.half_x"):
        ustar = td_rows_rhs(u, cxs, cys, coefs[0])
    with phase("adi.half_y"):
        return td_lanes_rhs(ustar, cys, cxs, coefs[1])


def adi_sweep_kernel(u, cxs, cys, coefs=None):
    """One batched ADI step of the (B, nx, ny) batch: the x half through
    H10, the y half through H11, each one launch of its right-hand-side
    build (the composition of ``_rhs_half``, the solve and ``_hold_edges``
    on the CPU); ``cxs``/``cys`` are (B,) float32 vectors on u's device,
    ``coefs`` their ``adi_coeffs`` (computed when absent). The hook's
    spans ``adi.half_x`` and ``adi.half_y`` each cover a half."""
    _validate(u, cxs, "adi_sweep_kernel")
    _validate(u, cys, "adi_sweep_kernel")
    before = entry_launches(*RHS_ENTRIES)
    out = _sweep(u, cxs, cys,
                 adi_coeffs(u, cxs, cys) if coefs is None else coefs)
    _count_halves(2, before)
    return out


def batched_adi_kernel(u0, cxs, cys, *, steps: int, coefs=None):
    """``steps`` batched ADI steps through the kernels, the time loop on
    the host (two launches a step); each axis's (cp, mi) computed once
    (``adi_coeffs``) unless ``coefs`` brings them."""
    if steps <= 0:
        return u0
    if coefs is None:
        _validate(u0, cxs, "batched_adi_kernel")
        _validate(u0, cys, "batched_adi_kernel")
        coefs = adi_coeffs(u0, cxs, cys)
    before, u = entry_launches(*RHS_ENTRIES), u0
    for _ in range(steps):
        u = _sweep(u, cxs, cys, coefs)
    _count_halves(2 * steps, before)
    return u
