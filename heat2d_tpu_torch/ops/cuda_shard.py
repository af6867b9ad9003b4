"""The hand-written CUDA shard kernels and their plain PyTorch versions:
the port of the shard kernels of ``heat2d_tpu/ops/pallas_stencil.py`` for
mode ``hybrid`` (sources in ``csrc/shard.cu``).

=====  ==========================  =========================================
H12    ``shard_tile_multi``        one (bm, bn) shard and its four T-deep
                                   halo strips -> the shard advanced nsub <=
                                   T steps by the strip sweep of
                                   ``csrc/tile.cuh`` (H9's, planned by
                                   ``cs.plan_strip_sweep``); replaces kernel D
                                   (``_shard_fused_vmem_kernel``,
                                   ``_shard_fused_band_kernel``) and D2
                                   (``_shard_window_kernel``)
H13    ``shard_tile_multi_resid``  H12 plus the shard's sum of squared
                                   deltas of the last step pair; replaces
                                   D2R
H14    ``shard_fused``             every shard of a mesh advanced nsub
                                   steps with the halo exchange inside the
                                   kernel (ring cells read from the
                                   neighbours' blocks) by the strip sweep
                                   (``cs.tile_plan``, ring nsub); replaces
                                   kernel F (``_fused_ici_kernel``)
=====  ==========================  =========================================

The plain versions: H12's is the golden loop of the JAX sharded engine
(``advance`` on the strip-extended block, ``parallel/sharded.py:160``),
H13's the same plus ``residual_sq`` over the shard's cells inside the
domain, H14's the overlap schedule ``chunk_fused`` (interior plus four
frames, ``parallel/sharded.py:176``) on the exchanged strips. Both step
forms: FMA (``_step_value``) and literal (``_step_value_literal``, bitwise
equal to the golden step in float32).

Every wrapper runs the plain version on CPU tensors and launches its
kernel (or raises) on CUDA tensors; each launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops.stencil import residual_sq, stencil_step
from heat2d_tpu_torch.parallel.halo import (exchange_halo_strips, extend,
                                            fused_halo_viable)

FORM_FMA = cs.FORM_FMA
FORM_LITERAL = cs.FORM_LITERAL

#: Shards one H14 launch can address (``MAX_SHARDS`` of csrc/shard.cu).
MAX_SHARDS = 64
#: Cells a strip of H14's strip sweep (``FUSED_STRIP`` of csrc/shard.cu):
#: 8, H2's heat5 build (on the H100 15% faster than the 4 of H12/H13,
#: PERF.md).
FUSED_STRIP = 8

LAUNCHES = {"shard_tile_multi": 0, "shard_tile_multi_resid": 0,
            "shard_fused": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _lib():
    return _build.load("shard")


def _check(rc: int, what: str) -> None:
    _build.check(_lib(), rc, what)


# --------------------------------------------------------------------- #
# Plain PyTorch versions
# --------------------------------------------------------------------- #

def keep_mask(shape, nx: int, ny: int, row0: int, col0: int, device):
    """True where a cell is held: the domain's boundary ring and every
    cell outside the domain, for a block whose (0, 0) is global cell
    (row0, col0) (``parallel/sharded._keep_mask``); ``shape``'s last two
    axes are the block's."""
    gi = row0 + torch.arange(shape[-2], device=device)[:, None]
    gj = col0 + torch.arange(shape[-1], device=device)[None, :]
    return (gi <= 0) | (gi >= nx - 1) | (gj <= 0) | (gj >= ny - 1)


def _step(w, cx, cy, form, accum):
    if form == FORM_LITERAL:
        return stencil_step(w, cx, cy, accum)
    return cs.step_plain(w, cx, cy, FORM_FMA)


def advance(v, row0: int, col0: int, t: int, nx: int, ny: int, cx, cy,
            form: int = FORM_LITERAL, accum=torch.float32):
    """``t`` masked steps of a block whose (0, 0) sits at global (row0,
    col0): the one per-cell step both halo routes share. The literal form
    takes ``accum`` (the golden dist modes' float64 path)."""
    keep = keep_mask(v.shape, nx, ny, row0, col0, v.device)
    for _ in range(t):
        v = torch.where(keep, v, _step(v, cx, cy, form, accum))
    return v


def shard_tile_multi_plain(u, strips, nsub: int, x0: int, y0: int, nx: int,
                           ny: int, cx, cy, form: int = FORM_FMA,
                           accum=torch.float32):
    """H12's plain version: ``nsub`` steps of the strip-extended block,
    its (bm, bn) centre."""
    t = strips[0].shape[0]
    ext = advance(extend(u, strips), x0 - t, y0 - t, nsub, nx, ny, cx, cy,
                  form, accum)
    return ext[t:-t, t:-t]


def shard_tile_multi_resid_plain(u, strips, nsub: int, x0: int, y0: int,
                                 nx: int, ny: int, cx, cy,
                                 form: int = FORM_FMA, accum=torch.float32):
    """H13's plain version: ``(shard after nsub steps, the shard's
    residual of its last step pair)``, summed over its cells inside the
    domain (pad cells are held, so they would add 0)."""
    t = strips[0].shape[0]
    prev = advance(extend(u, strips), x0 - t, y0 - t, nsub - 1, nx, ny, cx,
                   cy, form, accum)
    last = advance(prev, x0 - t, y0 - t, 1, nx, ny, cx, cy, form, accum)
    last, prev = last[t:-t, t:-t], prev[t:-t, t:-t]
    vr, vc = max(0, min(nx - x0, u.shape[0])), max(0, min(ny - y0,
                                                          u.shape[1]))
    return last, residual_sq(last[:vr, :vc], prev[:vr, :vc], accum)


def chunk_fused_plain(u, strips, t: int, x0: int, y0: int, nx: int, ny: int,
                      cx, cy, form: int = FORM_LITERAL,
                      accum=torch.float32):
    """The overlap schedule (the reference's inner/boundary split,
    grad1612_mpi_heat.c:233-259): the interior advanced from the block
    alone, then the four t-wide frames from strip-extended regions,
    stitched. Every kept cell sees the golden loop's operands, so the
    result equals the collective route bit for bit. Needs
    ``fused_halo_viable(bm, bn, t)``; the strips are t deep. The block
    may carry leading member axes (B, bm, bn), with (B, 1, 1)
    coefficients."""
    bm, bn = u.shape[-2:]
    north, south, west, east = strips

    def adv(v, r0, c0):
        return advance(v, r0, c0, t, nx, ny, cx, cy, form, accum)

    core = adv(u, x0, y0)[..., t:bm - t, t:bn - t]
    nfr = adv(torch.cat([north, u[..., :2 * t, :]], dim=-2), x0 - t,
              y0)[..., t:2 * t, t:bn - t]
    sfr = adv(torch.cat([u[..., bm - 2 * t:, :], south], dim=-2),
              x0 + bm - 2 * t, y0)[..., t:2 * t, t:bn - t]
    vert = torch.cat([north, u, south], dim=-2)
    wfr = adv(torch.cat([west, vert[..., :2 * t]], dim=-1),
              x0 - t, y0 - t)[..., t:bm + t, t:2 * t]
    efr = adv(torch.cat([vert[..., bn - 2 * t:], east], dim=-1),
              x0 - t, y0 + bn - 2 * t)[..., t:bm + t, t:2 * t]
    mid = torch.cat([nfr, core, sfr], dim=-2)
    return torch.cat([wfr, mid, efr], dim=-1)


def shard_fused_plain(blocks, nsub: int, nx: int, ny: int, cx, cy,
                      form: int = FORM_FMA):
    """H14's plain version: the exchange, then ``chunk_fused_plain`` on
    every shard of the (gx, gy) grid ``blocks``."""
    bm, bn = blocks[0][0].shape
    strips = exchange_halo_strips(blocks, nsub)
    return [[chunk_fused_plain(b, strips[i][j], nsub, i * bm, j * bn, nx, ny,
                               cx, cy, form) for j, b in enumerate(row)]
            for i, row in enumerate(blocks)]


# --------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------- #

def _validate(u, strips, nsub, what):
    cs._validate(u, what)
    bm, bn = u.shape
    north, south, west, east = strips
    t = north.shape[0]
    want = [(t, bn), (t, bn), (bm + 2 * t, t), (bm + 2 * t, t)]
    got = [tuple(s.shape) for s in strips]
    if got != want:
        raise ValueError(f"{what}: strips {got}, expected {want} (the "
                         f"layout of halo.exchange_halo_strips)")
    if not 1 <= t <= min(bm, bn):
        raise ValueError(f"{what}: halo depth {t} outside [1, {min(bm, bn)}]")
    cs._check_depth(nsub, t)
    for s in strips:
        if s.dtype != torch.float32 or s.device != u.device:
            raise ValueError(f"{what}: strips must be float32 on {u.device}")


#: The strip sweep's paths, in the order of the words of a ``paths``
#: count (csrc/shard.cu): ``fast``, tiles whose ext lies inside the
#: shard's block and inside the domain; ``edge``, the rest;
#: ``in_block_held``, the edge tiles whose ext lies inside the block but
#: not the domain (pad rows of an uneven decomposition).
TILE_PATHS = ("fast", "edge", "in_block_held")


def tile_paths(plan: cs.TilePlan, x0: int, y0: int, bm: int, bn: int,
               nx: int, ny: int) -> dict:
    """The planner's count of the tiles of ``plan`` on the (bm, bn) shard
    at global (x0, y0) of the nx x ny domain by path (``TILE_PATHS``),
    by the kernel's two uniform tests (``ext_inside`` of csrc/tile.cuh).
    What the kernel took, it counts itself into ``paths``."""
    h = plan.tsteps
    ey, ex = plan.ty + 2 * h, plan.tx + 2 * h
    counts = dict.fromkeys(TILE_PATHS, 0)
    for a in range(plan.grid[0]):
        for b in range(plan.grid[1]):
            li, lj = a * plan.ty - h, b * plan.tx - h
            in_block = li >= 0 and lj >= 0 and li + ey <= bm \
                and lj + ex <= bn
            gi, gj = x0 + li, y0 + lj
            in_domain = gi >= 0 and gj >= 0 and gi + ey <= nx \
                and gj + ex <= ny
            counts["fast" if in_block and in_domain else "edge"] += 1
            counts["in_block_held"] += in_block and not in_domain
    return counts


def fused_tile_paths(plan: cs.TilePlan, gx: int, gy: int, bm: int, bn: int,
                     nx: int, ny: int) -> dict:
    """The planner's count of H14's tiles by path (``TILE_PATHS``) over
    every shard of the (gx, gy) mesh of (bm, bn) blocks: the sum of
    ``tile_paths`` (H12's test) per shard. H14's plan is
    ``cs.tile_plan(bm, bn, nsub, device)``: its ring is its depth."""
    counts = dict.fromkeys(TILE_PATHS, 0)
    for i in range(gx):
        for j in range(gy):
            for k, v in tile_paths(plan, i * bm, j * bn, bm, bn, nx,
                                   ny).items():
                counts[k] += v
    return counts


def path_counter(device):
    """A zeroed ``paths`` count for ``device``: one int32 word per entry
    of ``TILE_PATHS``, to which each H12/H13 (or H14) launch given it adds
    its tiles; ``dict(zip(TILE_PATHS, buf.tolist()))`` reads it."""
    return torch.zeros(len(TILE_PATHS), dtype=torch.int32, device=device)


def _shard_launch(u, strips, nsub, x0, y0, nx, ny, cx, cy, form, resid,
                  paths=None):
    bm, bn = u.shape
    strips = [s.contiguous() for s in strips]
    t = strips[0].shape[0]
    plan = cs.plan_strip_sweep(bm, bn, t,
                              cs.device_caps(u.device).smem_optin)
    if plan.grid[0] > 65535:
        raise ValueError(f"{bm} rows exceed the launch grid's y limit")
    cs._check_paths(paths, len(TILE_PATHS), u.device)
    out = torch.empty_like(u)
    parts = (torch.empty(plan.ntiles, dtype=torch.float32, device=u.device)
             if resid else None)
    p = cs._ptr
    with torch.cuda.device(u.device):
        rc = _lib().heat_shard_tile(
            p(u), *(p(s) for s in strips), p(out),
            p(parts) if resid else None,
            None if paths is None else p(paths), x0, y0, bm, bn, nx, ny,
            cx, cy, cs._k0(cx, cy), form, t, nsub, plan.ty, plan.tx,
            cs._stream(u))
    _check(rc, "H13 shard_tile_multi_resid" if resid
           else "H12 shard_tile_multi")
    return out, parts


def shard_tile_multi(u, strips, nsub: int, x0: int, y0: int, nx: int,
                     ny: int, cx: float, cy: float, form: int = FORM_FMA,
                     paths=None):
    """H12: the shard ``u`` at global (x0, y0) of the nx x ny domain,
    advanced ``nsub`` steps from its halo strips ``(north, south, west,
    east)`` of depth T >= nsub. One read and one write of the block per
    sweep; the tiles' rings are recomputed in shared memory
    (``cs.plan_strip_sweep``). ``paths`` (``path_counter``): the kernel adds
    its tiles by path to it; the plain version, on the CPU, counts none."""
    _validate(u, strips, nsub, "shard_tile_multi")
    if u.device.type == "cpu":
        return shard_tile_multi_plain(u, strips, nsub, x0, y0, nx, ny, cx,
                                      cy, form)
    LAUNCHES["shard_tile_multi"] += 1
    out, _ = _shard_launch(u, strips, nsub, x0, y0, nx, ny, cx, cy, form,
                           resid=False, paths=paths)
    return out


def shard_tile_multi_resid(u, strips, nsub: int, x0: int, y0: int, nx: int,
                           ny: int, cx: float, cy: float,
                           form: int = FORM_FMA, paths=None):
    """H13: H12 plus the shard's residual of its last step pair, summed
    on the device from one partial per tile. Returns (u, residual).
    ``paths`` as H12's."""
    _validate(u, strips, nsub, "shard_tile_multi_resid")
    if u.device.type == "cpu":
        return shard_tile_multi_resid_plain(u, strips, nsub, x0, y0, nx, ny,
                                            cx, cy, form)
    LAUNCHES["shard_tile_multi_resid"] += 1
    out, parts = _shard_launch(u, strips, nsub, x0, y0, nx, ny, cx, cy,
                               form, resid=True, paths=paths)
    return out, torch.sum(parts)


def fused_peer_ok(devices) -> bool:
    """H14 can serve a mesh over ``devices``: one card, or cards that can
    each read every other's memory (``can_device_access_peer``)."""
    cards = sorted({d.index if d.index is not None else 0 for d in devices})
    return all(torch.cuda.can_device_access_peer(a, b)
               for a in cards for b in cards if a != b)


_events: dict = {}


def _sync_devices(cards) -> None:
    """Every card waits for the work each other card has queued so far:
    a neighbour's block is read only once its previous chunk is complete,
    and a block is overwritten only once every reader is done."""
    for c in cards:
        ev = _events.setdefault(c, torch.cuda.Event())
        ev.record(torch.cuda.current_stream(c))
    for c in cards:
        for o in cards:
            if o != c:
                torch.cuda.current_stream(c).wait_event(_events[o])


def shard_fused(blocks, nsub: int, nx: int, ny: int, cx: float, cy: float,
                form: int = FORM_FMA, paths=None):
    """H14: every shard of the mesh ``blocks`` (a (gx, gy) nested list of
    equal (bm, bn) blocks, shard (i, j) at global (i bm, j bn)) advanced
    ``nsub`` steps, the exchange inside the kernel: one launch per device
    covering the shards it holds, reading ring cells from the neighbours'
    blocks and writing new blocks. Returns the new (gx, gy) grid. On the
    CPU: the exchange, then ``chunk_fused_plain`` per shard. ``paths``
    (``path_counter``, a mesh on one card): the kernel adds its tiles by
    path to it (``fused_tile_paths``); the plain version counts none."""
    gx, gy = len(blocks), len(blocks[0])
    bm, bn = blocks[0][0].shape
    flat = [b for row in blocks for b in row]
    for b in flat:
        cs._validate(b, "shard_fused")
        if tuple(b.shape) != (bm, bn) or b.device.type != flat[0].device.type:
            raise ValueError("shard_fused: the blocks must be equal-sized "
                             "and all on the CPU or all on cards")
    if not fused_halo_viable(bm, bn, nsub):
        raise ValueError(f"shard_fused: depth {nsub} needs shards of at "
                         f"least {2 * nsub}x{2 * nsub}, got {bm}x{bn}")
    if flat[0].device.type == "cpu":
        return shard_fused_plain(blocks, nsub, nx, ny, cx, cy, form)
    if gx * gy > MAX_SHARDS:
        raise ValueError(f"shard_fused: {gx * gy} shards exceed the "
                         f"kernel's table of {MAX_SHARDS}")
    devices = [b.device for b in flat]
    cards = sorted({d.index for d in devices})
    if paths is not None and len(cards) > 1:
        raise ValueError("shard_fused: a paths count needs a mesh on one "
                         "card")
    cs._check_paths(paths, len(TILE_PATHS), devices[0])
    if len(cards) > 1:
        if not fused_peer_ok(devices):
            raise ValueError("shard_fused: the mesh's cards cannot read "
                             "each other's memory (no peer access)")
        for c in cards:
            with torch.cuda.device(c):
                for o in cards:
                    if o != c:
                        _check(_lib().heat_shard_enable_peer(o),
                               "H14 peer access")
        _sync_devices(cards)
    plan = cs.tile_plan(bm, bn, nsub, devices[0])
    if plan.grid[0] > 65535:
        raise ValueError(f"{bm} rows exceed the launch grid's y limit")
    outs = [torch.empty_like(b) for b in flat]
    table = (ctypes.c_void_p * (gx * gy))(*[b.data_ptr() for b in flat])
    for c in cards:
        mine = [z for z, d in enumerate(devices) if d.index == c]
        optr = (ctypes.c_void_p * len(mine))(
            *[outs[z].data_ptr() for z in mine])
        pos = (ctypes.c_int * (2 * len(mine)))(
            *[v for z in mine for v in divmod(z, gy)])
        LAUNCHES["shard_fused"] += 1
        with torch.cuda.device(c):
            rc = _lib().heat_shard_fused(
                table, optr, pos, None if paths is None else cs._ptr(paths),
                len(mine), gx, gy, bm, bn, nx, ny, cx, cy, cs._k0(cx, cy),
                form, nsub, nsub, plan.ty, plan.tx,
                cs._stream(flat[mine[0]]))
        _check(rc, "H14 shard_fused")
    if len(cards) > 1:
        _sync_devices(cards)
    return [outs[i * gy:(i + 1) * gy] for i in range(gx)]
