"""The hand-written CUDA ensemble kernels and their plain PyTorch versions:
the port of the Pallas kernels of ``heat2d_tpu/models/ensemble.py``.

A batch is one contiguous (B, nx, ny) float32 tensor; member b steps with
its own (cxs[b], cys[b]), two float32 vectors on the batch's device.
Three kernels (sources in ``csrc/ensemble.cu``):

====  =======================  ==============================================
H5    ``ens_resident``         every member ``steps`` steps in one
                               cooperative launch, its tiles resident in
                               shared memory (``ops/resident.py``,
                               ``csrc/resident.cuh``); replaces B5
                               (``_ensemble_kernel``, ensemble.py:106)
H6    ``ens_tile_multi``       ``nsub <= T`` steps per strip sweep of
                               shared-memory tiles over a (member, tile)
                               grid (H2's, ``tile_plan``); replaces B6
                               and B7
                               (``_ensemble_band_kernel``,
                               ``_ens_window_kernel``, ensemble.py:157/:243)
H7    ``ens_tile_multi_conv``  H6 gated by a per-member ``active`` flag
                               (frozen members pass through), optionally
                               with each member's residual of the last step
                               pair; replaces B8 (``_ens_conv_kernel``,
                               ensemble.py:357)
====  =======================  ==============================================

Every kernel takes the FMA step form with ``k0 = (1 - 2cx) - 2cy``
computed in float32 from the float32 coefficients, as the TPU kernels
compute it from their SMEM scalars (``ops/cuda_stencil`` computes its k0
in double on the host instead; the two differ by an ulp of k0 for
coefficients that are not binary-exact).

H5's state stays in shared memory, so it is bound by its step loop there
(10 bytes of shared memory per cell-step against 128 bytes per clock and
SM; on the H100 the instruction rate binds first), then by its ring
exchange once per K steps; the batch crosses device memory once each way.
H6/H7 move the batch through device memory once each way per sweep;
their step loop's instructions bound them, as H2's do.

On a CPU tensor a wrapper runs its kernel's plain version; on a CUDA
tensor it launches the kernel or raises. Each launch counts under the
wrapper's name in ``_build.launch_counts``; the plain versions count
nothing.
"""

from __future__ import annotations

import ctypes

import torch

from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops._build import call
from heat2d_tpu_torch.ops.cuda_stencil import (DEFAULT_TSTEPS,
                                               multi_step_plain, step_plain)
from heat2d_tpu_torch.ops.resident import (launch_scratch, plan_resident,
                                            raise_if_gave_up)

#: The tile kernels put the member on blockIdx.z.
MAX_MEMBERS = 65535

#: Cells a strip of H6/H7's strip sweep (``ENS_STRIP`` of
#: csrc/ensemble.cu): 8, H2's heat5 build (on the H100 17% faster than 4,
#: PERF.md).
STRIP = 8


def _validate(u, cxs, cys, what: str, active=None) -> None:
    if u.dim() != 3 or u.dtype != torch.float32:
        raise ValueError(f"{what}: expected a (B, nx, ny) float32 batch, "
                         f"got {tuple(u.shape)} {u.dtype}")
    if min(u.shape) < 1:
        raise ValueError(f"{what}: empty batch {tuple(u.shape)}")
    vecs = [("cxs", cxs, torch.float32), ("cys", cys, torch.float32)]
    if active is not None:
        vecs.append(("active", active, torch.int32))
    for name, v, dtype in vecs:
        if (v.dim() != 1 or v.shape[0] != u.shape[0] or v.dtype != dtype
                or v.device != u.device):
            raise ValueError(
                f"{what}: {name} must be a ({u.shape[0]},) {dtype} vector "
                f"on {u.device}, got {tuple(v.shape)} {v.dtype} on "
                f"{v.device}")
    if u.device.type == "cuda":
        if not (u.is_contiguous() and all(v.is_contiguous()
                                          for _, v, _ in vecs)):
            raise ValueError(f"{what}: the CUDA kernels take contiguous "
                             f"tensors")
        if u.numel() >= 2 ** 31:
            raise ValueError(f"{what}: batch of {u.numel()} cells exceeds "
                             f"the kernels' 32-bit index range")
        if u.shape[0] > MAX_MEMBERS:
            raise ValueError(f"{what}: {u.shape[0]} members exceed the "
                             f"launch grid's z limit of {MAX_MEMBERS}")
    elif u.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {u.device}")


#: The builds ``func_attrs`` reads, in ``heat_ens_func_attrs``' order.
FUNC_BUILDS = ("ens_resident", "ens_tile_multi", "ens_tile_multi_conv")


def func_attrs(name: str) -> dict:
    """Registers and local (spill) bytes a thread of wrapper ``name``'s
    build on the card (``cudaFuncGetAttributes``)."""
    buf = (ctypes.c_int * 2)()
    call("ensemble", "heat_ens_func_attrs", None, f"func_attrs {name}",
         FUNC_BUILDS.index(name), buf)
    return {"registers": buf[0], "local_bytes": buf[1]}


def _check_depth(nsub: int, tsteps: int) -> None:
    if not 1 <= nsub <= tsteps:
        raise ValueError(f"nsub must be in [1, T={tsteps}], got {nsub}")


# --------------------------------------------------------------------- #
# Tile planner
# --------------------------------------------------------------------- #

def tile_plan(nx: int, ny: int, device, tsteps: int = DEFAULT_TSTEPS,
              ty=None) -> cs.TilePlan:
    """H6/H7's tiles for a member of nx x ny: H2's at depth ``tsteps``,
    of at most ``ty`` centre rows when given (``cuda_stencil.tile_plan``;
    a batch on the CPU plans what the H100 would). Like H2, H6/H7 take
    the depth at run time, and every cell takes the same updates at any
    depth and tile."""
    return cs.tile_plan(nx, ny, tsteps, device, ty)


def tile_paths(plan: cs.TilePlan, nb: int, nx: int, ny: int) -> dict:
    """The planner's count of the tiles of ``plan`` on nb members of nx x
    ny by path (H2's ``cuda_stencil.TILE_PATHS``): H2's count on one
    member, times nb. The kernel counts every member's tiles, a frozen
    member's too, into a ``cuda_stencil.path_counter``."""
    return {k: nb * v for k, v in cs.tile_paths(plan, nx, ny).items()}


# --------------------------------------------------------------------- #
# Plain PyTorch versions (whole-batch steps, same form and mask)
# --------------------------------------------------------------------- #

def member_coefs(cxs, cys):
    """(cxs, cys) as (B, 1, 1) float32 tensors: the plain steps of
    ``ops.cuda_stencil`` then give each member its own coefficients and
    compute k0 = (1-2cx)-2cy in f32 (the TPU kernels' ``_step_value`` on
    f32 scalars)."""
    return cxs.reshape(-1, 1, 1), cys.reshape(-1, 1, 1)


def ens_multi_step_plain(u, n: int, cxs, cys):
    """``n`` clamped FMA-form steps of every member."""
    return multi_step_plain(u, n, *member_coefs(cxs, cys))


def member_residuals(a, b):
    """Each member's sum over cells of (a - b)^2, float32: (B,)."""
    d = a - b
    return torch.sum(d * d, dim=(1, 2))


def ens_conv_sweep_plain(u, nsub: int, cxs, cys, active, resid: bool):
    """``nsub`` steps of the active members (frozen ones unchanged) and,
    with ``resid``, each member's residual of the last step pair (0 for a
    frozen member). Returns u, or (u, residuals)."""
    prev = ens_multi_step_plain(u, nsub - 1, cxs, cys)
    last = step_plain(prev, *member_coefs(cxs, cys))
    on = active != 0
    out = torch.where(on.reshape(-1, 1, 1), last, u)
    if not resid:
        return out
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    return out, torch.where(on, member_residuals(last, prev), zero)


# --------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------- #

def _resident_launch(u, steps: int, cxs, cys, plan, window: bool = True):
    """One H5 launch of ``plan`` (``ops.resident``), its step loop
    ``window_steps`` (heat5's choice: the faster of the two on the H100)
    or ``tile_steps``. Raises when the launch is refused (the plan's
    blocks must all be co-resident) or a block gave up waiting."""
    what = (f"H5 ens_resident ({plan.blocks} blocks of {plan.smem_bytes} "
            f"bytes of shared memory)")
    out = torch.empty_like(u)
    scratch = launch_scratch(plan, steps, u.device)
    call("ensemble", "heat_ens_resident", "ens_resident", what, u, out,
         scratch, cxs, cys, plan.as_ctypes(), steps, int(window))
    raise_if_gave_up(scratch, what, plan)
    return out


def ens_resident(u, steps: int, cxs, cys, k=None):
    """H5: ``steps`` steps of every member in one cooperative launch, the
    members' tiles resident in shared memory for all of them
    (``ops.resident.plan_resident``, at chunk depth ``k`` when given, a
    tuned depth). A member too large to stay on the
    chip (no plan: beyond the co-resident blocks' shared memory, ~3.6 M
    cells on the H100) advances by H6 sweeps instead, ``ens_tiled_chunk``:
    the same per-cell arithmetic, bitwise the same result, counted under
    ``ens_tile_multi``. That is a gate on shape: a launch that fails
    raises, and so does one in which a block gave up waiting for a
    neighbour's ring (``ops.resident.raise_if_gave_up``; reading that
    waits for the launch)."""
    _validate(u, cxs, cys, "ens_resident")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if u.device.type == "cpu":
        return ens_multi_step_plain(u, steps, cxs, cys)
    if steps == 0:
        return u
    plan = plan_resident(*u.shape, 1, u.device, k)
    if plan is None:
        return ens_tiled_chunk(u, steps, cxs, cys)
    return _resident_launch(u, steps, cxs, cys, plan)


def _tile_launch(u, nsub, cxs, cys, active, resid, name, paths=None,
                 tsteps=DEFAULT_TSTEPS, ty=None):
    """One H6 (H7 with ``active``) launch of ``tile_plan``'s tiles."""
    nb, nx, ny = u.shape
    plan = tile_plan(nx, ny, u.device, tsteps, ty)
    if plan.grid[0] > 65535:
        raise ValueError(f"{name}: {nx} rows exceed the launch grid's y "
                         f"limit")
    cs._check_paths(paths, len(cs.TILE_PATHS), u.device)
    out = torch.empty_like(u)
    parts = (torch.empty((nb, plan.ntiles), dtype=torch.float32,
                         device=u.device) if resid else None)
    call("ensemble", "heat_ens_tile", name, name, u, out, parts, paths, cxs,
         cys, active, nb, nx, ny, plan.tsteps, nsub, plan.ty, plan.tx)
    return out, parts


def ens_tile_multi(u, nsub: int, cxs, cys, paths=None, *,
                   tsteps: int = DEFAULT_TSTEPS, ty=None):
    """H6: ``nsub <= tsteps`` steps of every member in one strip sweep of
    shared-memory tiles (``tile_plan`` at ``tsteps`` and ``ty``): one read
    and one write of the batch. ``paths``
    (``cuda_stencil.path_counter``): the kernel adds its tiles by path to
    it; the plain version, on the CPU, counts none."""
    _validate(u, cxs, cys, "ens_tile_multi")
    _check_depth(nsub, tsteps)
    if u.device.type == "cpu":
        return ens_multi_step_plain(u, nsub, cxs, cys)
    out, _ = _tile_launch(u, nsub, cxs, cys, None, False, "ens_tile_multi",
                          paths, tsteps, ty)
    return out


def ens_tile_multi_conv(u, nsub: int, cxs, cys, active, resid: bool = False,
                        paths=None, *, tsteps: int = DEFAULT_TSTEPS,
                        ty=None):
    """H7: H6 for the members whose int32 ``active`` flag is set, the
    others passed through unchanged; with ``resid`` also each member's
    residual of the last step pair (0 for a frozen member), summed on the
    device from one partial per tile. Returns u, or (u, residuals).
    ``paths``, ``tsteps`` and ``ty`` as H6's."""
    _validate(u, cxs, cys, "ens_tile_multi_conv", active)
    _check_depth(nsub, tsteps)
    if u.device.type == "cpu":
        return ens_conv_sweep_plain(u, nsub, cxs, cys, active, resid)
    out, parts = _tile_launch(u, nsub, cxs, cys, active, resid,
                              "ens_tile_multi_conv", paths, tsteps, ty)
    return (out, torch.sum(parts, dim=1)) if resid else out


def ens_tiled_chunk(u, n: int, cxs, cys, active=None, *,
                    tsteps: int = DEFAULT_TSTEPS, ty=None):
    """``n`` steps of every member as full ``tsteps``-deep sweeps plus
    one partial sweep at depth ``n % tsteps``: H6 sweeps, or with an
    int32 ``active`` vector H7 sweeps in which the frozen members pass
    through; tiles of at most ``ty`` centre rows when given."""
    nsweeps, rem = divmod(n, tsteps)
    kw = dict(tsteps=tsteps, ty=ty)
    for d in [tsteps] * nsweeps + ([rem] if rem else []):
        u = (ens_tile_multi(u, d, cxs, cys, **kw) if active is None
             else ens_tile_multi_conv(u, d, cxs, cys, active, **kw))
    return u
