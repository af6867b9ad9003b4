"""Each CUDA kernel's plain PyTorch version (what its wrapper runs on a
CPU tensor) against the JAX kernel it replaces, run as tests/test_pallas.py
runs it: Pallas in interpret mode on the CPU.

H4 resident <- multi_step_vmem (A); H1 step <- band_step (B);
H2 tile_multi <- band_multi_step / band_chunk (C, C2);
H3 tile_multi_resid <- stencil_step x nsub + residual_sq (C2R's result).
H4's schedule (the on-chip resident sweep on one member, stated in plain
PyTorch by ``ops/resident.emulate_resident``) is bitwise equal to the
plain steps and held against multi_step_vmem; the route gate and H2's
strip-sweep plans are pure Python and checked at the H100's limits.

Tolerance, both step forms: rtol=1e-6, atol=1e-4 on the inidat grids
(values up to ~4e6): XLA's CPU backend may contract the step's
multiply-adds into FMAs, torch eager rounds each operation. Residuals:
rtol=2e-3, because each delta of the last step pair is the difference of
two nearly equal f32 values, so an ulp of the grid is ~1e-3 of a delta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu.ops import inidat as jinidat
from heat2d_tpu.ops import pallas_stencil as ps
from heat2d_tpu.ops.stencil import residual_sq, stencil_step
from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops import resident as rs

FORMS = {"fma": (cs.FORM_FMA, ps._step_value),
         "literal": (cs.FORM_LITERAL, ps._step_value_literal)}
TOL = dict(rtol=1e-6, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(shape, rng=None):
    """The same grid for both stacks: inidat, plus seeded noise when an
    rng is given (so held boundary values are not all zero)."""
    u = np.asarray(jinidat(*shape))
    if rng is not None:
        u = u + rng.random(shape, dtype=np.float32) * 1000
    return jnp.asarray(u), torch.from_numpy(u.copy())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(16, 16), (32, 128)])
def test_resident_plain_vs_multi_step_vmem(shape, form, rng):
    tf, jf = FORMS[form]
    uj, ut = _pair(shape, rng)
    want = jax.jit(lambda u: ps.multi_step_vmem(u, 5, 0.1, 0.1,
                                                step=jf))(uj)
    got = cs.resident(ut, 5, 0.1, 0.1, tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cs.resident(ut, 0, 0.1, 0.1, tf) is ut


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape,bm", [((32, 128), 8), ((64, 256), None)])
def test_step_plain_vs_band_step(shape, bm, form, rng):
    tf, jf = FORMS[form]
    uj, ut = _pair(shape, rng)
    want = jax.jit(lambda u: ps.band_step(u, 0.1, 0.1, bm=bm, step=jf))(uj)
    got = cs.step(ut, 0.1, 0.1, tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tsteps", [1, 2, 3, 7])
def test_tile_multi_plain_vs_band_multi_step(tsteps, form):
    tf, jf = FORMS[form]
    uj, ut = _pair((64, 128))
    want = jax.jit(lambda u: ps.band_multi_step(u, tsteps, 0.1, 0.1, bm=16,
                                                step=jf))(uj)
    got = cs.tile_multi(ut, tsteps, 0.1, 0.1, tf, tsteps=tsteps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [1, 7, 8, 9, 20])
def test_tiled_chunk_vs_band_chunk(n, form):
    tf, jf = FORMS[form]
    uj, ut = _pair((64, 128))
    want = jax.jit(lambda u: ps.band_chunk(u, n, 0.1, 0.1, tsteps=4, bm=16,
                                           step=jf))(uj)
    got = cs.tiled_chunk(ut, n, 0.1, 0.1, tf, tsteps=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nsub", [1, 3, 8])
def test_tile_multi_resid_plain_vs_steps_and_residual(nsub, form):
    tf, _ = FORMS[form]
    uj, ut = _pair((48, 64))
    prev = uj
    for _ in range(nsub - 1):
        prev = stencil_step(prev, 0.1, 0.1)
    last = stencil_step(prev, 0.1, 0.1)
    got, r = cs.tile_multi_resid(ut, nsub, 0.1, 0.1, tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(last), **TOL)
    assert float(r) == pytest.approx(float(residual_sq(last, prev)),
                                     rel=2e-3)


def test_wrappers_reject_bad_depth_and_dtype():
    u = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        cs.tile_multi(u, 9, 0.1, 0.1)
    with pytest.raises(ValueError):
        cs.tile_multi_resid(u, 0, 0.1, 0.1)
    with pytest.raises(ValueError):
        cs.step(u.double(), 0.1, 0.1)


def test_plain_versions_count_no_launches():
    cs.reset_launch_counts()
    u = torch.zeros(12, 12)
    cs.step(u, 0.1, 0.1)
    cs.tiled_chunk(u, 9, 0.1, 0.1)
    cs.tile_multi_resid(u, 2, 0.1, 0.1)
    cs.resident(u, 3, 0.1, 0.1)
    assert set(cs.launch_counts().values()) == {0}


def _h4_plan(shape):
    """H4's own plan for a 37x53 grid, or three tiles of a ragged grid
    stacked in x (K = 4: steps 5 and 9 exchange rings)."""
    if shape == (37, 53):
        return cs.resident_plan(*shape, "cpu")
    return rs.ResidentPlan(1, *shape, 1, 4, 9, 40, 3, 1, 1)


@pytest.mark.parametrize("steps", [1, 5, 9])
@pytest.mark.parametrize("shape", [(37, 53), (25, 40)])
@pytest.mark.parametrize("form", FORMS)
def test_resident_schedule_vs_plain_and_multi_step_vmem(form, shape, steps,
                                                        rng):
    """H4's schedule on one member with the host's scalars: bitwise the
    plain steps (so the kernel, which runs it, is the plain step's bits
    in the literal form), and within TOL of the JAX kernel A."""
    tf, jf = FORMS[form]
    plan = _h4_plan(shape)
    assert plan.nb == 1 and (plan.nx, plan.ny) == shape
    assert plan.tiles > 1 and (plan.gx - 1) * plan.ty < shape[0]
    uj, ut = _pair(shape, rng)
    got = rs.emulate_resident(
        ut[None], steps, plan, lambda t, m: cs.step_plain(t, 0.1, 0.1, tf),
        seed=steps)[0]
    assert torch.equal(got, cs.multi_step_plain(ut, steps, 0.1, 0.1, tf))
    want = jax.jit(lambda u: ps.multi_step_vmem(u, steps, 0.1, 0.1,
                                                step=jf))(uj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


#: Grids around the end of the on-chip budget: 1800^2 (3.24 M cells)
#: would also fit two f32 planes in half the L2, 1900^2 (3.61 M) only the
#: plan, 1940^2 (3.76 M) and the larger ones neither.
GATE_SHAPES = [(10, 10), (3, 7), (640, 1024), (641, 1023), (2048, 1536),
               (1800, 1800), (1900, 1900), (1940, 1940), (2560, 2048),
               (4096, 4096)]


@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_resident_gate_follows_the_plan(shape):
    """Every grid either has H4's plan and takes the resident route, or
    has none and takes the streamed route: the choice is made before any
    launch, never after a failure."""
    plan = cs.resident_plan(*shape, "cpu")
    assert cs.fits_resident(shape, "cpu") == (plan is not None)
    if plan is not None:
        assert (plan.nb, plan.nx, plan.ny, plan.ring_w) == (1, *shape, 1)
        assert plan.smem_bytes <= cs.smem_limit("cpu")
        assert plan.blocks <= rs.H100_SM_COUNT
    cfg = HeatConfig(nxprob=shape[0], nyprob=shape[1], steps=1,
                     mode="pallas")
    runner = cs.make_single_chip_runner(cfg, "cpu")
    assert runner.route == ("resident" if plan is not None else "streamed")
    assert (plan is not None) == (shape[0] * shape[1] <= 1900 * 1900)


@pytest.mark.parametrize("shape,fast,edge", [((4096, 4096), 1860, 188),
                                             ((4099, 4097), 1860, 285),
                                             ((37, 53), 0, 1)])
@pytest.mark.parametrize("tsteps", [4, 6, 8])
def test_strip_sweep_plan(shape, tsteps, fast, edge):
    """H2/H3's tiles: centres of at most 64 x 128 cells covering the grid,
    two ext planes within half an SM beside the system's 1 KB and the
    warps' partial sums (two blocks an SM), and the tiles by path: fast
    where the tile's ext lies inside the grid."""
    plan = cs.tile_plan(*shape, tsteps, "cpu")
    assert plan.tsteps == tsteps and plan.ty <= 64 and plan.tx <= 128
    assert (plan.grid[0] - 1) * plan.ty < shape[0] <= plan.grid[0] * plan.ty
    assert (plan.grid[1] - 1) * plan.tx < shape[1] <= plan.grid[1] * plan.tx
    per_block = (plan.smem_bytes + cs.BLOCK_RESERVED_SMEM
                 + 4 * cs.STRIP_WARPS)
    assert 2 * per_block <= cs.SM_SMEM_BYTES
    assert plan == cs.plan_strip_sweep(*shape, tsteps)
    paths = cs.tile_paths(plan, *shape)
    assert paths == {"fast": fast, "edge": edge}
    # the kernel's test, tile by tile (ext_inside of csrc/tile.cuh)
    h, (ey, ex) = tsteps, (plan.ty + 2 * tsteps, plan.tx + 2 * tsteps)
    inside = sum(a * plan.ty - h >= 0 and b * plan.tx - h >= 0
                 and a * plan.ty - h + ey <= shape[0]
                 and b * plan.tx - h + ex <= shape[1]
                 for a in range(plan.grid[0]) for b in range(plan.grid[1]))
    assert inside == fast and fast + edge == plan.ntiles


def test_path_counter_and_paths_on_the_cpu():
    """The count H2/H3 add their tiles to: zeroed int32 words, one per
    path; the plain versions on the CPU take it and count nothing, and a
    malformed count is refused before a launch."""
    buf = cs.path_counter("cpu")
    assert buf.dtype == torch.int32 and tuple(buf.shape) == (2,)
    assert not bool(buf.any())
    u = torch.rand(20, 24)
    cs.reset_launch_counts()
    assert torch.equal(cs.tile_multi(u, 3, 0.1, 0.1, paths=buf),
                       cs.multi_step_plain(u, 3, 0.1, 0.1))
    cs.tile_multi_resid(u, 3, 0.1, 0.1, paths=buf)
    assert not bool(buf.any()) and set(cs.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="path_counter"):
        cs._check_paths(torch.zeros(3, dtype=torch.int32), 2, u.device)
