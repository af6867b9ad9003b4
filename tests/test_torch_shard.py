"""The shard kernels' plain PyTorch versions (what H12, H13 and H14 run on
CPU tensors) against the JAX package's shard kernels on the CPU, run as
tests/test_pallas.py runs them (Pallas in interpret mode).

H12 <- kernel D (``_shard_vmem_chunk``, ``_shard_band_chunk``);
H13 <- the golden chunk plus ``residual_sq`` (D2R itself runs only on a
TPU: ``plan_shard_window`` returns None off-TPU, ``pallas_stencil.py:
1777``, so its result is what the test holds H13 to);
H14 <- the overlap schedule (``dist2d --halo fused``, tier ``overlap``).

Tolerances. Against JAX in float32: ``n * 2**-21 * max|ref|`` after n
steps, both step forms (XLA's CPU backend contracts the update's
multiply-adds into FMAs, torch eager rounds each operation: a few cells
differ by an ulp). In float64 accumulation the golden paths are bitwise
equal across the stacks. Within the port: the literal form bitwise equal
to the golden step, H14's plain version bitwise equal to the collective
route in both forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu.ops import inidat as jinidat
from heat2d_tpu.ops import pallas_stencil as ps
from heat2d_tpu.ops.stencil import residual_sq as jresidual_sq
from heat2d_tpu.ops.stencil import stencil_step_padded
from heat2d_tpu.parallel.sharded import _keep_mask
from heat2d_tpu_torch.ops import cuda_shard as csh
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.parallel import halo
from heat2d_tpu_torch.parallel.sharded import ShardedGrid

FORMS = {"fma": (csh.FORM_FMA, ps._step_value),
         "literal": (csh.FORM_LITERAL, ps._step_value_literal)}
POSITIONS = [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(n, ref):
    return max(1, n) * 2.0 ** -21 * float(np.abs(ref).max())


def _global(nx, ny, t, rng):
    """The nx x ny domain (inidat plus seeded noise on the interior) inside
    a t-deep ring of zeros: the extended block of any shard is a slice."""
    g = np.zeros((nx + 2 * t, ny + 2 * t), np.float32)
    u = np.asarray(jinidat(nx, ny)).copy()
    u[1:-1, 1:-1] += rng.random((nx - 2, ny - 2), dtype=np.float32) * 100
    g[t:-t, t:-t] = u
    return g


def _strips(ext, t):
    """(u, (north, south, west, east)) of an extended block, in the layout
    of exchange_halo_strips (west/east carry the corners)."""
    return ext[t:-t, t:-t], (ext[:t, t:-t], ext[-t:, t:-t], ext[:, :t],
                             ext[:, -t:])


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _golden(ext, t, row0, col0, nx, ny, n=None):
    """The JAX package's golden wide-halo loop (literal step, f32) on an
    extended block: every plane, the initial one first."""
    v = jnp.asarray(ext)
    keep = _keep_mask(v.shape, nx, ny, row0, col0)
    planes = [v]
    for _ in range(t if n is None else n):
        newint = stencil_step_padded(v, 0.1, 0.1)
        mid = jnp.concatenate([v[1:-1, :1], newint, v[1:-1, -1:]], axis=1)
        full = jnp.concatenate([v[:1, :], mid, v[-1:, :]], axis=0)
        v = jnp.where(keep, v, full)
        planes.append(v)
    return [np.asarray(p) for p in planes]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("si,sj", POSITIONS)
@pytest.mark.parametrize("variant", ["vmem", "band", "band-uneven"])
def test_h12_plain_vs_kernel_d(si, sj, variant, form, rng):
    """Every position of a 2x2 decomposition of 32x32 (bm = bn = 16,
    T = 3), kernel D's resident route and its band route (rb 8, and rb 12,
    whose block pads and embeds the south strip)."""
    tf, jf = FORMS[form]
    nx = ny = 32
    t, bm = 3, 16
    g = _global(nx, ny, t, rng)
    r0, c0 = si * bm, sj * bm
    ext = g[r0:r0 + bm + 2 * t, c0:c0 + bm + 2 * t]
    u, strips = _strips(ext, t)
    ju, jstrips = jnp.asarray(u), tuple(jnp.asarray(s) for s in strips)
    scalars = jnp.asarray([r0, c0], jnp.int32)
    if variant == "vmem":
        want = ps._shard_vmem_chunk(ju, jstrips, scalars, t, 0.1, 0.1, nx,
                                    ny, step=jf)
    else:
        want = ps._shard_band_chunk(ju, jstrips, scalars, t, 0.1, 0.1, nx,
                                    ny, step=jf,
                                    bm=8 if variant == "band" else 12)
    want = np.asarray(want)
    got = csh.shard_tile_multi(_torch(u), [_torch(s) for s in strips], t,
                               r0, c0, nx, ny, 0.1, 0.1, tf).numpy()
    assert np.abs(got - want).max() <= _tol(t, want)
    if form == "literal":
        # The literal plain version is the port's golden loop, bit for bit.
        gold = csh.advance(_torch(ext), r0 - t, c0 - t, t, nx, ny, 0.1, 0.1)
        np.testing.assert_array_equal(got, gold.numpy()[t:-t, t:-t])


@pytest.mark.parametrize("nsub", [1, 2, 3])
@pytest.mark.parametrize("si,sj", POSITIONS)
def test_h12_partial_depth_vs_golden(si, sj, nsub, rng):
    """nsub < T steps from T-deep strips (the chunk remainders): the
    centre equals the golden loop's after nsub steps."""
    nx, ny, t, bm, bn = 30, 34, 3, 15, 17
    g = _global(nx, ny, t, rng)
    r0, c0 = si * bm, sj * bn
    ext = g[r0:r0 + bm + 2 * t, c0:c0 + bn + 2 * t]
    u, strips = _strips(ext, t)
    want = _golden(ext, t, r0 - t, c0 - t, nx, ny, n=nsub)[-1][t:-t, t:-t]
    got = csh.shard_tile_multi(_torch(u), [_torch(s) for s in strips], nsub,
                               r0, c0, nx, ny, 0.1, 0.1, csh.FORM_LITERAL)
    assert np.abs(got.numpy() - want).max() <= _tol(nsub, want)


@pytest.mark.parametrize("nsub", [1, 3])
@pytest.mark.parametrize("si,sj", POSITIONS)
def test_h13_plain_vs_golden_chunk_and_residual(si, sj, nsub, rng):
    """H13's plain version against the golden chunk and ``residual_sq``
    of its last step pair (D2R's result; D2R cannot run off a TPU). The
    residual within rtol 2e-3: a delta is the difference of two nearly
    equal f32 values, so an ulp of the grid is ~1e-3 of it."""
    nx = ny = 32
    t, bm = 3, 16
    g = _global(nx, ny, t, rng)
    r0, c0 = si * bm, sj * bm
    ext = g[r0:r0 + bm + 2 * t, c0:c0 + bm + 2 * t]
    u, strips = _strips(ext, t)
    planes = _golden(ext, t, r0 - t, c0 - t, nx, ny, n=nsub)
    last, prev = (p[t:-t, t:-t] for p in planes[-1:-3:-1])
    want_r = float(jresidual_sq(jnp.asarray(last), jnp.asarray(prev)))
    got, r = csh.shard_tile_multi_resid(_torch(u), [_torch(s) for s in strips],
                                        nsub, r0, c0, nx, ny, 0.1, 0.1,
                                        csh.FORM_LITERAL)
    assert np.abs(got.numpy() - last).max() <= _tol(nsub, last)
    assert float(r) == pytest.approx(want_r, rel=2e-3)


def test_h13_residual_skips_pad_cells():
    """A shard of an uneven dist1d decomposition (rows past nx are pad):
    the pad cells are held and the residual counts only domain cells."""
    nx, ny, t = 10, 12, 2
    u = torch.zeros(4, ny)
    u[:2, 1:-1] = 5.0                      # rows 8, 9 of the domain
    strips = [torch.ones(t, ny), torch.zeros(t, ny), torch.zeros(4 + 2 * t, t),
              torch.zeros(4 + 2 * t, t)]
    got, r = csh.shard_tile_multi_resid(u, strips, 2, 8, 0, nx, ny, 0.1, 0.1)
    np.testing.assert_array_equal(got[2:].numpy(), 0.0)
    last = csh.shard_tile_multi(u, strips, 2, 8, 0, nx, ny, 0.1, 0.1)
    one = csh.shard_tile_multi(u, strips, 1, 8, 0, nx, ny, 0.1, 0.1)
    assert float(r) == pytest.approx(float(((last - one) ** 2)[:2].sum()))


def _blocks(g, t, gx, gy, bm, bn):
    return [[_torch(g[t + i * bm:t + (i + 1) * bm, t + j * bn:t + (j + 1) * bn])
             for j in range(gy)] for i in range(gx)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1), (1, 3), (2, 4)])
def test_h14_plain_bitwise_vs_collective(mesh, form, rng):
    """H14's plain version (the exchange, then the overlap schedule)
    equals the collective route (H12's plain version after the
    exchange) bit for bit in both step forms, at every shard."""
    tf, _ = FORMS[form]
    gx, gy = mesh
    bm, bn, t = 8, 12, 3
    nx, ny = gx * bm, gy * bn
    blocks = _blocks(_global(nx, ny, t, rng), t, gx, gy, bm, bn)
    got = csh.shard_fused(blocks, t, nx, ny, 0.1, 0.1, tf)
    strips = halo.exchange_halo_strips(blocks, t)
    for i in range(gx):
        for j in range(gy):
            want = csh.shard_tile_multi(blocks[i][j], strips[i][j], t, i * bm,
                                        j * bn, nx, ny, 0.1, 0.1, tf)
            np.testing.assert_array_equal(got[i][j].numpy(), want.numpy())


def test_h14_rejects_shards_too_small_for_the_frames():
    blocks = [[torch.zeros(4, 4), torch.zeros(4, 4)]]
    with pytest.raises(ValueError, match="at least 6x6"):
        csh.shard_fused(blocks, 3, 4, 8, 0.1, 0.1)


def test_wrappers_reject_bad_strips():
    u = torch.zeros(8, 8)
    good = [torch.zeros(2, 8), torch.zeros(2, 8), torch.zeros(12, 2),
            torch.zeros(12, 2)]
    with pytest.raises(ValueError, match="layout"):
        csh.shard_tile_multi(u, good[:2] + [torch.zeros(8, 2)] * 2, 1, 0, 0,
                             8, 8, 0.1, 0.1)
    with pytest.raises(ValueError, match="nsub"):
        csh.shard_tile_multi(u, good, 3, 0, 0, 8, 8, 0.1, 0.1)
    with pytest.raises(ValueError):
        csh.shard_tile_multi_resid(u.double(), good, 1, 0, 0, 8, 8, 0.1, 0.1)


def test_plain_versions_count_no_launches(rng):
    csh.reset_launch_counts()
    blocks = [[torch.zeros(6, 6) for _ in range(2)] for _ in range(2)]
    strips = halo.exchange_halo_strips(blocks, 2)
    csh.shard_tile_multi(blocks[0][0], strips[0][0], 2, 0, 0, 12, 12, 0.1,
                         0.1)
    csh.shard_tile_multi_resid(blocks[0][1], strips[0][1], 1, 0, 6, 12, 12,
                               0.1, 0.1)
    csh.shard_fused(blocks, 2, 12, 12, 0.1, 0.1)
    assert set(csh.launch_counts().values()) == {0}


SWEEP_SHARDS = {"74x106 on 2x2": (74, 106, 2, 2),
                "4099x4096 on 4x1": (4099, 4096, 4, 1),
                "2048^2 of 4096^2 on 2x2": (4096, 4096, 2, 2)}


@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("case", list(SWEEP_SHARDS))
def test_plan_shard_sweep(case, t):
    """H12/H13's tiles (the strip sweep, 16 warps a block): the ext tiles
    of a block fit the opt-in limit and two blocks share an SM (228 KB,
    1 KB a block for the system, H13's warp sums); the tiles cover every
    shard of the mesh, none of them wholly past its block."""
    nx, ny, gx, gy = SWEEP_SHARDS[case]
    bm, bn = -(-nx // gx), -(-ny // gy)
    plan = cs.plan_strip_sweep(bm, bn, t)
    assert plan.tsteps == t and cs.STRIP_WARPS == 16
    assert plan.smem_bytes + 4 * cs.STRIP_WARPS <= 232448
    assert 2 * (plan.smem_bytes + 1024 + 4 * cs.STRIP_WARPS) <= 233472
    assert plan.grid[0] * plan.ty >= bm > (plan.grid[0] - 1) * plan.ty
    assert plan.grid[1] * plan.tx >= bn > (plan.grid[1] - 1) * plan.tx
    assert (plan.ty, plan.tx) == (min(64, -(-bm // 8) * 8),
                                  min(128, -(-bn // 32) * 32))
    for i in range(gx):
        for j in range(gy):
            kinds = csh.tile_paths(plan, i * bm, j * bn, bm, bn, nx, ny)
            assert kinds["fast"] + kinds["edge"] == plan.ntiles


@pytest.mark.parametrize("nx, ny, gx, gy, t, shard, fast, edge, held", [
    (4096, 4096, 2, 2, 8, (0, 0), 420, 92, 0),   # the sharded path's shard
    (4096, 4096, 2, 2, 8, (1, 1), 420, 92, 0),
    (74, 106, 2, 2, 8, (1, 0), 0, 1, 0),         # all edge tiles
    (4099, 4096, 4, 1, 1, (3, 0), 420, 124, 30),  # the pad row at T = 1
    (4099, 4096, 4, 1, 8, (3, 0), 420, 124, 0),
    (543, 300, 4, 1, 8, (3, 0), 0, 9, 1),        # the pad row at T = 8
])
def test_shard_sweep_tile_paths(nx, ny, gx, gy, t, shard, fast, edge, held):
    """Which tiles of a shard take the strip sweep's fast path: those
    whose ext lies inside the shard's block (no strip loads) and inside
    the domain (no held cell). A tile inside the block can still cross
    the domain's edge on pad rows, and is swept with the held rule."""
    bm, bn = -(-nx // gx), -(-ny // gy)
    plan = cs.plan_strip_sweep(bm, bn, t)
    got = csh.tile_paths(plan, shard[0] * bm, shard[1] * bn, bm, bn, nx, ny)
    assert got == {"fast": fast, "edge": edge, "in_block_held": held}


@pytest.mark.parametrize("nx, ny, gx, gy, nsub, fast, edge, held", [
    (4096, 4096, 2, 2, 8, 1680, 368, 0),  # the sharded path's launch
    (4096, 4096, 2, 2, 1, 1680, 368, 0),  # border tiles read neighbours
    (74, 106, 2, 2, 8, 0, 4, 0),          # no fast tile
    (74, 106, 2, 2, 3, 0, 4, 0),
    (543, 300, 4, 1, 8, 3, 33, 1),        # a pad row inside a block
])
def test_fused_tile_paths(nx, ny, gx, gy, nsub, fast, edge, held):
    """The planner's count of H14's tiles by path over the mesh: H12's
    test (``tile_paths``) on every shard, summed."""
    bm, bn = -(-nx // gx), -(-ny // gy)
    plan = cs.tile_plan(bm, bn, nsub, "cpu")
    got = csh.fused_tile_paths(plan, gx, gy, bm, bn, nx, ny)
    assert got == {"fast": fast, "edge": edge, "in_block_held": held}
    per_shard = [csh.tile_paths(plan, i * bm, j * bn, bm, bn, nx, ny)
                 for i in range(gx) for j in range(gy)]
    assert got == {k: sum(d[k] for d in per_shard) for k in csh.TILE_PATHS}
    assert got["fast"] + got["edge"] == gx * gy * plan.ntiles


def test_path_counter_on_the_cpu():
    """A ``paths`` count is one zeroed int32 word per path; the plain
    versions, which CPU tensors take, count no tile."""
    counted = csh.path_counter("cpu")
    assert counted.dtype == torch.int32 and counted.tolist() == [0, 0, 0]
    assert csh.TILE_PATHS == ("fast", "edge", "in_block_held")
    u = torch.rand(12, 12)
    strips = halo.exchange_halo_strips([[u]], 2)[0][0]
    got = csh.shard_tile_multi(u, strips, 2, 0, 0, 12, 12, 0.1, 0.1,
                               paths=counted)
    _, r = csh.shard_tile_multi_resid(u, strips, 2, 0, 0, 12, 12, 0.1, 0.1,
                                      paths=counted)
    assert torch.equal(got, csh.shard_tile_multi_plain(
        u, strips, 2, 0, 0, 12, 12, 0.1, 0.1))
    blocks = [[u[:6, :6], u[:6, 6:]], [u[6:, :6], u[6:, 6:]]]
    fused = csh.shard_fused(blocks, 2, 12, 12, 0.1, 0.1, paths=counted)
    assert torch.equal(fused[1][0], csh.shard_fused_plain(
        blocks, 2, 12, 12, 0.1, 0.1)[1][0])
    assert counted.tolist() == [0, 0, 0]


def test_sharded_grid_views():
    g = ShardedGrid([[torch.zeros(3, 4)] * 2] * 3, 8, 7)
    assert g.block_shape == (3, 4)
    assert len(g.tensors()) == 6
    assert g.with_blocks(g.blocks).nx == 8
