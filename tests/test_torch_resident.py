"""The on-chip resident sweep of H5 ``ens_resident`` and H8 ``fam_resident``
on the CPU: its planner (``ops/resident.plan_resident``) and the plain
PyTorch emulation of the schedule the kernel runs (``emulate_resident``:
tiles with rings, K steps on the shrinking region, band exchange by
parity and stamped words under a random interleaving, waves).

The emulation updates every cell with the plain version's arithmetic, so
it must equal ``ens_multi_step_plain`` / ``fam_multi_step_plain`` bit for
bit; cells no step rewrites and the exchange planes are poisoned with NaN,
so a stale ring, a missing corner or a plane reused too early shows.
"""

import numpy as np
import pytest
import torch

from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops import cuda_ensemble as ce
from heat2d_tpu_torch.ops import cuda_family as cf
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops import resident as rs
from heat2d_tpu_torch.problems.registry import get_family

#: The H100's limits the CPU plans are gated against.
SMEM = 232448
SMS = 132

OPERATORS = ["heat5", "heat9", "advdiff", "reactdiff"]
COEFS = {"heat5": (0.01, 0.24), "heat9": (0.01, 0.17),
         "advdiff": (0.01, 0.24), "reactdiff": (0.01, 0.24)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_w(op):
    return 1 if op == "heat5" else get_family(op).spec.halo_width


def _problem(op, nb, shape, seed):
    """A seeded batch with per-member scalars, its plain multi-step
    function and the emulation's one-tile step."""
    rng = np.random.default_rng(seed)
    lo, hi = COEFS[op]
    u = torch.from_numpy(rng.random((nb,) + shape, dtype=np.float32))
    cxs = torch.from_numpy(rng.uniform(lo, hi, nb).astype(np.float32))
    cys = torch.from_numpy(rng.uniform(lo, hi, nb).astype(np.float32))
    if op == "heat5":
        def plain(n):
            return ce.ens_multi_step_plain(u, n, cxs, cys)

        def step(t, m):
            return cs.step_plain(t[None], cxs[m].reshape(1, 1, 1),
                                 cys[m].reshape(1, 1, 1))[0]
    else:
        scal = cf.scalar_block(op, cxs, cys)
        fam = get_family(op)

        def plain(n):
            return cf.fam_multi_step_plain(u, n, scal, op)

        def step(t, m):
            return fam.step(t[None], *[scal[m, j].reshape(1, 1, 1)
                                       for j in range(scal.shape[1])])[0]
    return u, plain, step


# ------------------------------------------------------------------ #
# The planner
# ------------------------------------------------------------------ #

def _check_plan(plan, nb, nx, ny, w, smem, blocks):
    assert (plan.nb, plan.nx, plan.ny, plan.ring_w) == (nb, nx, ny, w)
    assert 1 <= plan.k <= rs.MAX_CHUNK and plan.halo == w * plan.k
    # tiles cover each member exactly once: a grid of equal tiles, none
    # empty, the last of each axis reaching the edge
    for n, t, g in ((nx, plan.ty, plan.gx), (ny, plan.tx, plan.gy)):
        assert (g - 1) * t < n <= g * t
        # a ring reaches into the adjacent tile only
        assert g == 1 or t >= plan.halo
    covered = np.zeros((nx, ny), np.int32)
    for ti in range(plan.gx):
        for tj in range(plan.gy):
            covered[ti * plan.ty:(ti + 1) * plan.ty,
                    tj * plan.tx:(tj + 1) * plan.tx] += 1
    assert (covered == 1).all()
    # every ext fits the shared memory, in two planes of whole groups
    ey, ex = plan.ext
    assert (ey, ex) == (plan.ty + 2 * plan.halo, plan.tx + 2 * plan.halo)
    assert plan.smem_bytes == (2 * ey * (-(-ex // 4) * 4) + 8) * 4
    assert plan.smem_bytes <= smem
    # a wave holds whole members on at most the co-resident blocks
    assert 1 <= plan.members <= nb
    assert plan.blocks == plan.members * plan.tiles <= blocks
    assert plan.waves == -(-nb // plan.members)
    assert (plan.waves - 1) * plan.members < nb


PLAN_TABLE = [(nb, nx, ny) for nx, ny in [(37, 53), (640, 1024)]
              for nb in (1, 5, 8, 40)] + [(1, 2048, 1536), (3, 2048, 1536)]


@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("nb,nx,ny", PLAN_TABLE)
def test_plan_covers_members_and_fits_the_card(nb, nx, ny, w):
    plan = rs.plan_resident(nb, nx, ny, w, "cpu")
    assert plan is not None
    _check_plan(plan, nb, nx, ny, w, _build.smem_limit("cpu"), SMS)
    assert _build.smem_limit("cpu") <= SMEM
    assert list(plan.as_ctypes()) == [nb, nx, ny, plan.k, plan.ty, plan.tx,
                                      plan.gx, plan.gy, plan.members]


@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("nb", [1, 3])
def test_oversize_members_get_no_plan(nb, w):
    """4099x4097 is 16.8 M cells against the ~3.8 M floats per plane the
    card's shared memory holds: the wrappers advance it by tile sweeps."""
    assert rs.plan_resident(nb, 4099, 4097, w, "cpu") is None
    assert rs.plan_resident(nb, 4096, 4096, w, "cpu") is None


def test_the_serving_bucket_runs_in_two_waves():
    """8 x 640x1024 in two ext planes exceeds the card's shared memory
    once, not twice: 4 members a wave on all 132 blocks."""
    plan = rs.plan_resident(8, 640, 1024, 1, "cpu")
    assert (plan.members, plan.waves) == (4, 2)
    assert plan.blocks > SMS - plan.tiles
    one = rs.plan_resident(1, 640, 1024, 1, "cpu")
    assert one.waves == 1 and one.tiles > SMS // 2


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("w", [1, 2])
def test_plan_under_small_limits(w, k):
    """A forced chunk depth and a small budget: still a valid plan, with
    several tiles a member, and several waves where few blocks remain."""
    smem, blocks = 48 * 1024, 12
    plan = rs.plan_for_limits(5, 96, 80, w, smem, blocks, k)
    assert plan is not None and plan.k == k
    _check_plan(plan, 5, 96, 80, w, smem, blocks)
    assert plan.tiles > 1
    few = rs.plan_for_limits(5, 96, 80, w, smem, plan.tiles, k)
    _check_plan(few, 5, 96, 80, w, smem, plan.tiles)
    assert few.members == 1 and few.waves == 5
    assert rs.plan_for_limits(5, 96, 80, w, 512, blocks, k) is None


def test_exchange_planes():
    """Two planes of 64-bit words (value under the exchange's number) per
    member of a wave, zeroed: 0 stamps a word never written."""
    plan = rs.plan_resident(8, 640, 1024, 1, "cpu")
    xbuf = rs.exchange_planes(plan, "cpu")
    assert tuple(xbuf.shape) == (2, plan.members, 640, 1024)
    assert xbuf.dtype == torch.int64 and not bool(xbuf.any())


@pytest.mark.parametrize("nb,shape,steps,exchanges", [
    (8, (640, 1024), 10000, True),      # the serving bucket
    (8, (640, 1024), 5, True),          # past one chunk of K = 4
    (8, (640, 1024), 4, False),         # one chunk: no exchange
    (40, (37, 53), 1000, False),        # one tile a member: no neighbour
])
def test_launch_scratch(nb, shape, steps, exchanges):
    """One zeroed vector of 64-bit words: the error word, then the two
    exchange planes, left out when the launch never exchanges."""
    plan = rs.plan_resident(nb, *shape, 1, "cpu")
    scratch = rs.launch_scratch(plan, steps, "cpu")
    planes = 2 * plan.members * shape[0] * shape[1]
    assert (plan.tiles > 1 and steps > plan.k) == exchanges
    assert scratch.numel() == 1 + (planes if exchanges else 0)
    assert scratch.dtype == torch.int64 and not bool(scratch.any())
    rs.raise_if_gave_up(scratch, "a launch", plan)
    scratch[0] = 1
    with pytest.raises(RuntimeError, match="gave up"):
        rs.raise_if_gave_up(scratch, "a launch", plan)


# ------------------------------------------------------------------ #
# The schedule
# ------------------------------------------------------------------ #

def _nine_tile_plan(nb, w, k, members=2):
    """A 3 x 3 tile grid (every edge, every corner and an interior tile)
    over a ragged member, ``members`` members a wave."""
    h = w * k
    ty, tx = max(h, 7) + 1, max(h, 9) + 2
    nx, ny = 3 * ty - 2, 3 * tx - 3          # ragged last tiles
    return rs.ResidentPlan(nb, nx, ny, w, k, ty, tx, 3, 3, members)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("op", OPERATORS)
def test_schedule_equals_plain_bitwise(op, k):
    """steps in {0, 1, K-1, K, 2K+3}: no exchange, a partial chunk, one
    full chunk, two exchanges and a remainder; 3 members in waves of 2."""
    w = _ring_w(op)
    plan = _nine_tile_plan(3, w, k)
    u, plain, step = _problem(op, 3, (plan.nx, plan.ny), seed=k)
    for steps in sorted({0, 1, k - 1, k, 2 * k + 3}):
        got = rs.emulate_resident(u, steps, plan, step, seed=steps)
        assert torch.equal(got, plain(steps)), (op, k, steps)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("op", ["heat5", "heat9"])
def test_schedule_under_other_interleavings(op, seed):
    """Other random orders of the tiles' phases: members drift apart,
    neighbours overtake each other by up to one exchange."""
    w = _ring_w(op)
    plan = _nine_tile_plan(5, w, 2)
    u, plain, step = _problem(op, 5, (plan.nx, plan.ny), seed=10 + seed)
    got = rs.emulate_resident(u, 11, plan, step, seed=seed)
    assert torch.equal(got, plain(11))


@pytest.mark.parametrize("op", ["heat5", "heat9"])
def test_schedule_on_planned_tiles(op):
    """The planner's own plan under a small budget (whatever grid it
    picks), and a member of one tile."""
    w = _ring_w(op)
    for nb, shape, smem, blocks in [(3, (41, 67), 12 * 1024, 14),
                                    (4, (12, 15), SMEM, 3)]:
        plan = rs.plan_for_limits(nb, *shape, w, smem, blocks)
        assert plan is not None
        u, plain, step = _problem(op, nb, shape, seed=nb)
        steps = 2 * plan.k + 1
        got = rs.emulate_resident(u, steps, plan, step)
        assert torch.equal(got, plain(steps))


def test_schedule_needs_the_corners(monkeypatch):
    """Bands published without their corner blocks leave the diagonal
    neighbour's ring corners unpublished: once a second chunk needs them
    (and not before) the neighbour waits for words that never come, where
    the kernel gives up and the wrapper raises."""
    plan = _nine_tile_plan(2, 1, 4)
    h = plan.halo
    whole = rs._bands

    def no_corners(p, ti, tj):
        return [(a, b, max(c, 2 * h), min(d, p.tx)) if b - a <= h
                else (max(a, 2 * h), min(b, p.ty), c, d)
                for a, b, c, d in whole(p, ti, tj)]

    u, plain, step = _problem("heat5", 2, (plan.nx, plan.ny), seed=4)
    monkeypatch.setattr(rs, "_bands", no_corners)
    assert torch.equal(rs.emulate_resident(u, 4, plan, step), plain(4))
    with pytest.raises(RuntimeError, match="no progress"):
        rs.emulate_resident(u, 9, plan, step)


def test_schedule_needs_both_planes(monkeypatch):
    """With one exchange plane a tile that runs ahead overwrites words a
    neighbour has not read yet: the neighbour then waits for a number that
    is gone (no progress) or, where a value slipped through, ends wrong."""
    plan = _nine_tile_plan(2, 1, 1)
    u, plain, step = _problem("heat5", 2, (plan.nx, plan.ny), seed=5)
    real = rs.exchange_planes

    def one_plane(p, device):
        return real(p, device)[:1].expand(2, -1, -1, -1)   # parities alias

    monkeypatch.setattr(rs, "exchange_planes", one_plane)
    wrong = 0
    for s in range(3):
        try:
            wrong += not torch.equal(
                rs.emulate_resident(u, 6, plan, step, seed=s), plain(6))
        except RuntimeError:
            wrong += 1
    assert wrong > 0


# ------------------------------------------------------------------ #
# The wrappers on the CPU
# ------------------------------------------------------------------ #

def test_wrappers_run_their_plain_versions_on_the_cpu():
    u, plain, _ = _problem("heat5", 2, (20, 24), seed=6)
    rng = np.random.default_rng(6)
    cxs = torch.from_numpy(rng.uniform(0.01, 0.24, 2).astype(np.float32))
    cys = torch.from_numpy(rng.uniform(0.01, 0.24, 2).astype(np.float32))
    _build.reset_launch_counts()
    assert torch.equal(ce.ens_resident(u, 5, cxs, cys),
                       ce.ens_multi_step_plain(u, 5, cxs, cys))
    scal = cf.scalar_block("heat9", cxs * 0.5, cys * 0.5)
    assert torch.equal(cf.fam_resident(u, 5, scal, "heat9"),
                       cf.fam_multi_step_plain(u, 5, scal, "heat9"))
    assert set(_build.launch_counts("ensemble").values()) == {0}
    assert set(_build.launch_counts("family").values()) == {0}
    with pytest.raises(ValueError):
        ce.ens_resident(u, -1, cxs, cys)
    with pytest.raises(ValueError):
        cf.fam_resident(u, -1, scal, "heat9")
