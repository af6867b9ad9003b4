"""The hand-written CUDA kernels of the problem families and their plain
PyTorch versions: the port of the Pallas kernels of
``heat2d_tpu/problems/runners.py``.

A batch is one contiguous (B, nx, ny) float32 tensor of one family
(heat9, advdiff or reactdiff); member b steps with the S scalar operands
in row b of a (B, S) float32 block (``scalar_block``: the family's
``scalars`` mapping of (cxs, cys)). Two kernels (sources in
``csrc/family.cu``):

====  ==================  ===============================================
H8    ``fam_resident``    every member ``steps`` steps in one cooperative
                          launch, its tiles resident in shared memory
                          (``ops/resident.py``, ``csrc/resident.cuh``);
                          replaces B9 (``_family_ensemble_kernel``,
                          runners.py:124)
H9    ``fam_tile_multi``  ``nsub <= T`` steps per sweep of shared-memory
                          tiles with a ``W * nsub``-deep ring, strips of
                          4 cells a thread; replaces B10
                          (``_family_band_kernel``, runners.py:181)
====  ==================  ===============================================

A kernel's plain version is the family's step on the whole batch, its
constants read from the scalar block: the update of
``problems/kernels.py`` with its W-deep ring held, operations in the JAX
package's order. The kernels round every operation
as the plain version does; ``rounding_factor`` bounds what remains.

H8's state stays in shared memory, so it is bound by its step loop there
(heat9: 10 accesses of 4 bytes per cell-step, the W = 1 families 6,
against 128 bytes per clock and SM; on the H100 the instructions of the
rounded update sequences bind first), then by its ring exchange of depth
``W * K`` once per K steps; the batch crosses device memory once each
way. H9 reads and writes the batch once per sweep, and is bound by its
rounded update sequences on the recomputed ring; its paths sweep
``SWEEP_TSTEPS[problem]`` steps at a time, a depth measured on the card.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. Each launch adds one to the wrapper's
entry in ``LAUNCHES``; the plain versions count nothing.
"""

from __future__ import annotations

import ctypes

import torch

from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops.cuda_stencil import (BLOCK_RESERVED_SMEM,
                                               DEFAULT_TSTEPS, SM_SMEM_BYTES,
                                               STRIP_WARPS, plan_tiles,
                                               smem_limit)
from heat2d_tpu_torch.ops.resident import (launch_scratch, plan_resident,
                                            raise_if_gave_up)
from heat2d_tpu_torch.problems.registry import get_family

#: Launches per kernel wrapper since the last ``reset_launch_counts``.
LAUNCHES = {"fam_resident": 0, "fam_tile_multi": 0}

#: The families the kernels are built for, and their codes in
#: csrc/family.cu.
FAMILY_CODES = {"heat9": 0, "advdiff": 1, "reactdiff": 2}

#: The tile kernel puts the member on blockIdx.z.
MAX_MEMBERS = 65535

#: Per-step bound on |kernel - plain| in units of 2^-24 * max|u|, per
#: family: (rounded operations of one update) x (largest partial result
#: over max|u| at the stability limit). heat9: 22 operations, partial
#: sums up to 64 max|u| scaled by (cx + cy) / 12 <= 1/32, so <= 3 max|u|;
#: advdiff: 14 operations, <= 1 + 4 * 0.5 + 2 * 0.1 = 3.2; reactdiff: 12
#: operations, <= 1 + 4 * 0.5 + 0.25 = 3.25. The kernels repeat the plain
#: version's roundings, so on the card the two agree bit for bit unless
#: a plain operation rounds another way; the bound holds either way.
_ROUNDING = {"heat9": 22 * 3.0, "advdiff": 14 * 3.2, "reactdiff": 12 * 3.25}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def rounding_factor(problem: str) -> float:
    """The per-step tolerance factor of ``problem`` (see ``_ROUNDING``):
    after n steps kernel and plain version differ by at most ``n *
    factor * 2**-24 * max|plain|``."""
    return _ROUNDING[problem]


def _lib():
    return _build.load("family")


def _check(rc: int, what: str) -> None:
    _build.check(_lib(), rc, what)


def _stream(u) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(u.device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def scalar_block(problem: str, cxs, cys):
    """The (B, S) float32 scalar block of ``problem``: row b holds member
    b's operands, the family's ``scalars(cxs, cys)`` in order."""
    fam = get_family(problem)
    return torch.stack(fam.scalars(cxs, cys), dim=1).contiguous()


def _validate(u, scal, problem: str, what: str) -> None:
    if problem not in FAMILY_CODES:
        raise ValueError(f"{what}: no kernel for problem {problem!r} "
                         f"(built for {tuple(FAMILY_CODES)})")
    spec = get_family(problem).spec
    if u.dim() != 3 or u.dtype != torch.float32:
        raise ValueError(f"{what}: expected a (B, nx, ny) float32 batch, "
                         f"got {tuple(u.shape)} {u.dtype}")
    if u.shape[0] < 1 or min(u.shape[1:]) < spec.min_grid:
        raise ValueError(f"{what}: {problem} needs members of at least "
                         f"{spec.min_grid}x{spec.min_grid}, got "
                         f"{tuple(u.shape)}")
    want = (u.shape[0], spec.n_scalars)
    if (tuple(scal.shape) != want or scal.dtype != torch.float32
            or scal.device != u.device):
        raise ValueError(f"{what}: the scalar block must be {want} float32 "
                         f"on {u.device}, got {tuple(scal.shape)} "
                         f"{scal.dtype} on {scal.device}")
    if u.device.type == "cuda":
        if not (u.is_contiguous() and scal.is_contiguous()):
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


# --------------------------------------------------------------------- #
# Plain PyTorch version
# --------------------------------------------------------------------- #

def fam_multi_step_plain(u, n: int, scal, problem: str):
    """``n`` steps of every member: the family's step with member b's
    operands from row b of ``scal``."""
    fam = get_family(problem)
    ops = [scal[:, k].reshape(-1, 1, 1) for k in range(scal.shape[1])]
    for _ in range(n):
        u = fam.step(u, *ops)
    return u


# --------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------- #

def _resident_launch(u, steps: int, scal, problem: str, plan,
                     window: bool = False):
    """One H8 launch of ``plan`` (``ops.resident``), its step loop
    ``tile_steps`` (the families' choice: the faster of the two on the
    H100) or ``window_steps``. Raises when the launch is refused (the
    plan's blocks must all be co-resident) or a block gave up waiting."""
    what = (f"H8 fam_resident ({problem}, {plan.blocks} blocks of "
            f"{plan.smem_bytes} bytes of shared memory)")
    out = torch.empty_like(u)
    scratch = launch_scratch(plan, steps, u.device)
    LAUNCHES["fam_resident"] += 1
    _check(_lib().heat_fam_resident(
        FAMILY_CODES[problem], _ptr(u), _ptr(out), _ptr(scratch),
        _ptr(scal), plan.as_ctypes(), steps, int(window), _stream(u)), what)
    raise_if_gave_up(scratch, what, plan)
    return out


def fam_resident(u, steps: int, scal, problem: str):
    """H8: ``steps`` steps of every member in one cooperative launch, the
    members' tiles resident in shared memory for all of them
    (``ops.resident.plan_resident`` with the family's ring width). A
    member too large to stay on the chip (no plan) advances by H9 sweeps
    instead, ``fam_tiled_chunk``: the same per-cell arithmetic, bitwise
    the same result, counted under ``fam_tile_multi``. That is a gate on
    shape: a launch that fails raises, and so does one in which a block
    gave up waiting for a neighbour's ring
    (``ops.resident.raise_if_gave_up``; reading that waits for the
    launch)."""
    _validate(u, scal, problem, "fam_resident")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if u.device.type == "cpu":
        return fam_multi_step_plain(u, steps, scal, problem)
    if steps == 0:
        return u
    plan = plan_resident(*u.shape, get_family(problem).spec.halo_width,
                         u.device)
    if plan is None:
        return fam_tiled_chunk(u, steps, scal, problem)
    return _resident_launch(u, steps, scal, problem, plan)


#: Steps per H9 sweep on the families' paths (``fam_tiled_chunk``), from
#: ``chip_smoke.py``'s plan sweep (``plan_sweep_ms``) on the H100: a
#: shallower sweep recomputes less of its ring (heat9's W = 2 ring of 8
#: at T = 4: 1.15 updates per centre cell-step, against 1.36 at T = 8)
#: and keeps two blocks on an SM, at one more read and write of the
#: batch per 8 steps. The W = 1 families ran as fast at T = 6 as at 8,
#: and T = 8 takes one sweep per 8 steps.
SWEEP_TSTEPS = {"heat9": 4, "advdiff": 8, "reactdiff": 8}

#: Warps per H9 block (``FAM_BY`` of csrc/family.cu): the strip sweep's.
FAM_WARPS = STRIP_WARPS


def tile_plan(nx: int, ny: int, problem: str, device,
              tsteps: int = DEFAULT_TSTEPS):
    """The H9 tile geometry of sweeps of ``tsteps`` steps: ``plan_tiles``
    with a ring of ``W * tsteps``."""
    ring = get_family(problem).spec.halo_width * tsteps
    return plan_tiles(nx, ny, ring, smem_limit(device))


def blocks_per_sm(plan) -> int:
    """H9 blocks one SM holds at ``plan``'s shared memory and
    ``FAM_WARPS`` warps a block (2048 threads an SM); the card's own
    count, with registers, is ``tile_info``'s."""
    by_smem = SM_SMEM_BYTES // (plan.smem_bytes + BLOCK_RESERVED_SMEM)
    return min(by_smem, 2048 // (32 * FAM_WARPS))


def _tile_launch(u, nsub: int, scal, problem: str, plan):
    """One H9 launch of ``plan`` (ring ``plan.tsteps >= W * nsub``)."""
    nb, nx, ny = u.shape
    if plan.grid[0] > 65535:
        raise ValueError(f"fam_tile_multi: {nx} rows exceed the launch "
                         f"grid's y limit")
    out = torch.empty_like(u)
    LAUNCHES["fam_tile_multi"] += 1
    _check(_lib().heat_fam_tile(
        FAMILY_CODES[problem], _ptr(u), _ptr(out), _ptr(scal), nb, nx, ny,
        plan.tsteps, nsub, plan.ty, plan.tx, _stream(u)),
        f"H9 fam_tile_multi ({problem})")
    return out


def fam_tile_multi(u, nsub: int, scal, problem: str):
    """H9: ``nsub <= T`` steps of every member in one sweep of
    shared-memory tiles with a ``W * nsub``-deep ring (the shallowest
    that leaves the centre exact)."""
    _validate(u, scal, problem, "fam_tile_multi")
    if not 1 <= nsub <= DEFAULT_TSTEPS:
        raise ValueError(f"nsub must be in [1, T={DEFAULT_TSTEPS}], got "
                         f"{nsub}")
    if u.device.type == "cpu":
        return fam_multi_step_plain(u, nsub, scal, problem)
    plan = tile_plan(*u.shape[1:], problem, u.device, nsub)
    return _tile_launch(u, nsub, scal, problem, plan)


def tile_info(problem: str, plan) -> dict:
    """H9's build on the card at ``plan``: registers and local (spill)
    bytes a thread (what ``nvcc -Xptxas -v`` reports), and the blocks an
    SM holds by ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    buf = (ctypes.c_int * 4)()
    _check(_lib().heat_fam_tile_info(FAMILY_CODES[problem],
                                     plan.smem_bytes,
                                     ctypes.cast(buf, ctypes.c_void_p)),
           f"H9 tile_info ({problem})")
    return {"registers": buf[0], "local_bytes": buf[1],
            "blocks_per_sm": buf[2], "max_threads": buf[3],
            "warps": FAM_WARPS, "smem_bytes": plan.smem_bytes}


def sweep_schedule(n: int, problem: str) -> list:
    """The sweep depths of ``n`` steps on ``problem``'s path: full
    sweeps of ``SWEEP_TSTEPS[problem]`` and one partial sweep of the
    rest."""
    t = SWEEP_TSTEPS[problem]
    nsweeps, rem = divmod(n, t)
    return [t] * nsweeps + ([rem] if rem else [])


def fam_tiled_chunk(u, n: int, scal, problem: str):
    """``n`` steps of every member as H9 sweeps (``sweep_schedule``)."""
    for d in sweep_schedule(n, problem):
        u = fam_tile_multi(u, d, scal, problem)
    return u
