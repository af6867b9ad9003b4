"""The planner of the on-chip resident sweep (H4 ``resident`` on one
member, H5 ``ens_resident``, H8 ``fam_resident``; device code in
``csrc/resident.cuh``) and a plain PyTorch emulation of the schedule the
kernel runs.

The sweep keeps every member of a wave in shared memory for all of its
steps. A member is cut into ``gx x gy`` tiles of ``ty x tx`` centre cells;
a tile's block holds two copies of its *ext* (the centre plus a ring of
depth ``H = W * K``, W the operator's radius) and advances it K steps at a
time over the shrinking region, after which only the centre is exact.
Then the block publishes the H-deep border bands of its centre at their
global coordinates in one of two exchange planes (the parity of the
exchange's number), every cell as one word that carries its value under
that number, and reads its ring back from the plane until every word
carries the number (0 outside the domain). A word is trusted by its
stamp alone: no flag, fence or barrier orders the exchange. Corner cells
lie in the diagonal neighbour's band, so they need no second phase. A
*wave* is as many whole members as the co-resident blocks hold (one block
per SM); a wave runs all steps before the next begins, and the exchanges
count on across waves, so no barrier spans the grid. A block whose wait
outlasts ~2 s sets the launch's error word and every waiting block gives
up on seeing it; the wrappers read the word after the launch and raise
(``launch_scratch``, ``raise_if_gave_up``).

Why two planes suffice: a block publishes exchange g only after it has
refilled from exchange g - 1, which it could only do after every
neighbour had published g - 1, which each of them did after refilling
from g - 2: the plane of g's parity has no reader left.

``plan_resident`` is pure Python and plans against ``_build.device_caps``,
so a CPU batch is gated against the H100's limits and the CPU runs plan
what the card would. ``emulate_resident`` is
the executable statement of the schedule, for the tests; no path calls it.
"""

from __future__ import annotations

import ctypes
import functools
import math
import random
from typing import Callable, NamedTuple, Optional

import torch

from heat2d_tpu_torch.ops._build import device_caps, round_up, smem_limit

#: Deepest chunk (steps between two exchanges) the planner considers.
MAX_CHUNK = 8
#: Cost of one exchange in cell updates, the planner's weight of chunk
#: depth against ring recompute. Fitted to sweeps of K on the H100 at
#: 8 x 640x1024 x 10000 (``chip_smoke.py``'s ``k_sweep_ms``, PERF.md): time
#: ~ ext area + cost / K, the cost ~12,000 heat5 cell updates and fewer of
#: a family's (the exchange is a fixed time, a family's cell update a
#: longer one). With this heat5 gets its measured optimum K = 4 and heat9
#: K = 3.
_EXCHANGE_COST = 12288


#: Adjacent columns a thread owns (one 16-byte access).
GROUP = 4
#: Columns a warp covers: a row of the region costs whole warps.
WARP_COLS = 32 * GROUP


def _smem_bytes(ey: int, ex: int) -> int:
    """Two ext planes at a row pitch of whole 4-column groups, and a
    4-float pad at either end."""
    return (2 * ey * round_up(ex, GROUP) + 2 * GROUP) * 4


class ResidentPlan(NamedTuple):
    nb: int        # members of the batch
    nx: int
    ny: int
    ring_w: int    # the operator's radius W
    k: int         # steps per chunk, between two exchanges
    ty: int        # centre rows per tile
    tx: int        # centre columns per tile
    gx: int        # tile rows per member
    gy: int        # tile columns per member
    members: int   # members per wave

    @property
    def halo(self) -> int:
        """Ring depth H = W * K."""
        return self.ring_w * self.k

    @property
    def tiles(self) -> int:
        return self.gx * self.gy

    @property
    def blocks(self) -> int:
        """Blocks of the launch: one per (member of a wave, tile)."""
        return self.members * self.tiles

    @property
    def waves(self) -> int:
        return -(-self.nb // self.members)

    @property
    def ext(self) -> tuple:
        return self.ty + 2 * self.halo, self.tx + 2 * self.halo

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block (``resident_smem_bytes`` of
        csrc/resident.cuh)."""
        return _smem_bytes(*self.ext)

    def as_ctypes(self):
        """The plan as the int array ``csrc/resident.cuh`` reads."""
        vals = (self.nb, self.nx, self.ny, self.k, self.ty, self.tx,
                self.gx, self.gy, self.members)
        return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=256)
def plan_for_limits(nb: int, nx: int, ny: int, ring_w: int, smem: int,
                    blocks: int, k: Optional[int] = None
                    ) -> Optional[ResidentPlan]:
    """The cheapest plan for ``blocks`` co-resident blocks of ``smem``
    bytes of shared memory each, or None when one member's tiles do not
    fit them. Every (K, gx, gy) with K <= ``MAX_CHUNK`` (or K = ``k``) is
    weighed by its cell updates per step: waves x (the ext's area, its
    rows in whole warps, + the exchange's cost / K). A tile grid needs
    ``ty >= H`` (``tx >= H``) where it has more than one row (column), so
    that a ring reaches into the adjacent tile only."""
    best = None
    for kk in ([k] if k else range(MAX_CHUNK, 0, -1)):
        h = ring_w * kk
        for gx in range(1, min(blocks, nx) + 1):
            ty = -(-nx // gx)
            if (gx - 1) * ty >= nx:
                continue                    # its last tile row is empty
            if gx > 1 and ty < h:
                break
            for gy in range(1, min(blocks // gx, ny) + 1):
                tx = -(-ny // gy)
                if (gy - 1) * tx >= ny:
                    continue
                if gy > 1 and tx < h:
                    break
                ey, ex = ty + 2 * h, tx + 2 * h
                if _smem_bytes(ey, ex) > smem:
                    continue
                members = min(nb, blocks // (gx * gy))
                area = ey * round_up(ex, WARP_COLS)
                exchange = _EXCHANGE_COST if gx * gy > 1 else 0
                cost = -(-nb // members) * (area + exchange / kk)
                if best is None or cost < best[0]:
                    best = (cost, ResidentPlan(nb, nx, ny, ring_w, kk, ty,
                                               tx, gx, gy, members))
    return best[1] if best else None


def plan_resident(nb: int, nx: int, ny: int, ring_w: int, device,
                  k: Optional[int] = None) -> Optional[ResidentPlan]:
    """The resident sweep's plan for a (nb, nx, ny) batch of an operator
    of radius ``ring_w`` on ``device`` (at chunk depth ``k`` when given),
    or None when a member is too large to stay on the chip (its tiles
    exceed the co-resident blocks' shared memory): the wrappers then
    advance it by tile sweeps. One block per SM of the card
    (``_build.device_caps``: a batch on the CPU is gated against the
    H100's 132 SMs), each within ``_build.smem_limit``."""
    return plan_for_limits(nb, nx, ny, ring_w, smem_limit(device),
                           device_caps(device).sm_count, k)


def on_chip_bytes(device) -> int:
    """The shared memory the resident sweeps can hold on ``device``: one
    block's share on every SM (SM count x ``_build.smem_limit``), the
    largest member the card keeps on chip. A CPU device answers for the
    H100."""
    return device_caps(device).sm_count * smem_limit(device)


def exchange_planes(plan: ResidentPlan, device):
    """The two exchange planes on ``device``: 64-bit words (a cell's value
    under the number of the exchange that published it), zeroed, since 0
    stamps a word never written. Only the border bands are touched
    afterwards."""
    return torch.zeros((2, plan.members, plan.nx, plan.ny),
                       dtype=torch.int64, device=device)


def launch_scratch(plan: ResidentPlan, steps: int, device):
    """What one launch of ``steps`` steps needs beside the batch, one
    zeroed vector of 64-bit words: the error word, then the exchange
    planes, 16 bytes a cell of a wave (4 x 640x1024: 42 MB). A launch that
    never exchanges (one tile a member, or no more steps than one chunk)
    gets the error word alone."""
    exchanges = plan.tiles > 1 and steps > plan.k
    words = 2 * plan.members * plan.nx * plan.ny if exchanges else 0
    return torch.zeros(1 + words, dtype=torch.int64, device=device)


def raise_if_gave_up(scratch, what: str, plan: ResidentPlan) -> None:
    """Read the launch's error word (waits for the launch) and raise when
    a block gave up: a neighbour's ring words had not come after ~2 s of
    SM clocks, so part of the result is unwritten. Only a block that is
    not running can cause that (the cooperative launch makes all of them
    co-resident): a context preempted for seconds, as under a debugger or
    on a time-sliced card, can."""
    if int(scratch[0].item()):
        raise RuntimeError(
            f"{what}: a block of the resident sweep ({plan.blocks} blocks "
            f"of {plan.smem_bytes} bytes of shared memory, {plan.tiles} "
            f"tiles a member) waited ~2 s for a neighbour's ring and gave "
            f"up; the result is incomplete")


# --------------------------------------------------------------------- #
# The schedule in plain PyTorch
# --------------------------------------------------------------------- #

def _bands(plan: ResidentPlan, ti: int, tj: int):
    """The rectangles (r0, r1, c0, c1), in ext coordinates, of the centre
    bands tile (ti, tj) publishes: the H rows (columns) along each side
    that has a neighbour, clipped to the domain."""
    h = plan.halo
    rows = min(plan.ty, plan.nx - ti * plan.ty)     # centre rows in domain
    cols = min(plan.tx, plan.ny - tj * plan.tx)
    out = []
    if ti > 0:
        out.append((h, h + min(h, rows), h, h + cols))
    if ti < plan.gx - 1:
        out.append((plan.ty, plan.ty + h, h, h + cols))
    if tj > 0:
        out.append((h, h + rows, h, h + min(h, cols)))
    if tj < plan.gy - 1:
        out.append((h, h + rows, plan.tx, plan.tx + h))
    return out


def _ring(plan: ResidentPlan):
    """The four rectangles, in ext coordinates, that cover a tile's ring."""
    h = plan.halo
    ey, ex = plan.ext
    return [(0, h, 0, ex), (h + plan.ty, ey, 0, ex),
            (h, h + plan.ty, 0, h), (h, h + plan.ty, h + plan.tx, ex)]


def emulate_resident(u, steps: int, plan: ResidentPlan, step: Callable,
                     seed: int = 0):
    """``steps`` steps of every member of ``u`` by the resident kernel's
    schedule, in plain PyTorch on the CPU. ``step(ext, m)`` is one plain
    step of a 2D tile with member m's scalars, its own W-deep edge held
    (the family's step on a one-member batch); the global held rule is
    applied on top, so the arithmetic of every updated cell is the plain
    version's and the result must equal it bit for bit.

    Every tile is a task that runs as a block does: load, K steps on the
    shrinking region, publish band by band, read the ring back in passes
    until every word carries the exchange's number, ..., write, next wave.
    A scheduler seeded with ``seed`` interleaves the tasks at random at
    every point where a block could be overtaken (between two bands too:
    words become visible one by one), so a plane reused too early or a
    word trusted too soon shows as a wrong cell. Cells a step does not
    rewrite, and the exchange planes' values, are poisoned with NaN: a
    valid cell that read one would carry it to the result."""
    nb, nx, ny = u.shape
    w, h, k = plan.ring_w, plan.halo, plan.k
    ey, ex = plan.ext
    nan = float("nan")
    out = torch.full_like(u, nan)
    values = torch.full((2, plan.members, nx, ny), nan, dtype=u.dtype)
    stamps = exchange_planes(plan, "cpu")

    def task(slot, ti, tj):
        i0, j0 = ti * plan.ty - h, tj * plan.tx - h
        gi = torch.arange(i0, i0 + ey).reshape(-1, 1)
        gj = torch.arange(j0, j0 + ex).reshape(1, -1)
        inside = (gi >= 0) & (gi < nx) & (gj >= 0) & (gj < ny)
        updated = (gi >= w) & (gi < nx - w) & (gj >= w) & (gj < ny - w)
        # the in-domain part of the ext, as slices of the member's plane
        r0, r1 = max(i0, 0), min(i0 + ey, nx)
        c0, c1 = max(j0, 0), min(j0 + ex, ny)
        gen = 0
        for wave in range(plan.waves):
            m = wave * plan.members + slot
            if m >= nb:
                return
            cur = torch.zeros((ey, ex), dtype=u.dtype)
            cur[r0 - i0:r1 - i0, c0 - j0:c1 - j0] = u[m, r0:r1, c0:c1]
            done = 0
            while True:
                for s in range(1, min(k, steps - done) + 1):
                    lo = w * s
                    nxt = torch.full_like(cur, nan)
                    new = torch.where(updated, step(cur, m), cur)
                    nxt[lo:ey - lo, lo:ex - lo] = new[lo:ey - lo, lo:ex - lo]
                    cur = nxt
                done += min(k, steps - done)
                yield
                if done >= steps:
                    break
                gen += 1
                value, stamp = values[gen % 2, slot], stamps[gen % 2, slot]
                for a, b, c, d in _bands(plan, ti, tj):
                    value[i0 + a:i0 + b, j0 + c:j0 + d] = cur[a:b, c:d]
                    stamp[i0 + a:i0 + b, j0 + c:j0 + d] = gen
                    yield
                late = True
                while late:
                    late = False
                    for a, b, c, d in _ring(plan):
                        got = torch.zeros((b - a, d - c), dtype=u.dtype)
                        rr0, rr1 = max(i0 + a, 0), min(i0 + b, nx)
                        cc0, cc1 = max(j0 + c, 0), min(j0 + d, ny)
                        if rr1 > rr0 and cc1 > cc0:
                            got[rr0 - i0 - a:rr1 - i0 - a,
                                cc0 - j0 - c:cc1 - j0 - c] = \
                                value[rr0:rr1, cc0:cc1]
                            late |= bool((stamp[rr0:rr1, cc0:cc1]
                                          != gen).any())
                        cur[a:b, c:d] = got
                    if late:
                        yield
                if not bool((cur[~inside] == 0).all()):
                    raise RuntimeError("a cell outside the domain is not 0")
                yield
            rows = min(plan.ty, nx - ti * plan.ty)
            cols = min(plan.tx, ny - tj * plan.tx)
            out[m, i0 + h:i0 + h + rows, j0 + h:j0 + h + cols] = \
                cur[h:h + rows, h:h + cols]
            yield

    tasks = [task(slot, ti, tj) for slot in range(plan.members)
             for ti in range(plan.gx) for tj in range(plan.gy)]
    rng = random.Random(seed)
    budget = 128 * len(tasks) * (plan.waves * (math.ceil(steps / k) + 2) + 1)
    while tasks:
        budget -= 1
        if budget < 0:
            raise RuntimeError("the emulated schedule made no progress: a "
                               "tile waits for a word that is never "
                               "published")
        i = rng.randrange(len(tasks))
        try:
            next(tasks[i])
        except StopIteration:
            tasks.pop(i)
    return out
