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
from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops import resident as rs
from tests._torch_recording import record_launches

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
    _build.reset_launch_counts()
    u = torch.zeros(12, 12)
    cs.step(u, 0.1, 0.1)
    cs.tiled_chunk(u, 9, 0.1, 0.1)
    cs.tile_multi_resid(u, 2, 0.1, 0.1)
    cs.resident(u, 3, 0.1, 0.1)
    assert set(_build.launch_counts("stencil").values()) == {0}


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
        assert plan.smem_bytes <= _build.smem_limit("cpu")
        assert plan.blocks <= _build.H100_SM_COUNT
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
    per_block = (plan.smem_bytes + _build.BLOCK_RESERVED_SMEM
                 + 4 * cs.STRIP_WARPS)
    assert 2 * per_block <= _build.SM_SMEM_BYTES
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
    _build.reset_launch_counts()
    assert torch.equal(cs.tile_multi(u, 3, 0.1, 0.1, paths=buf),
                       cs.multi_step_plain(u, 3, 0.1, 0.1))
    cs.tile_multi_resid(u, 3, 0.1, 0.1, paths=buf)
    assert not bool(buf.any())
    assert set(_build.launch_counts("stencil").values()) == {0}
    with pytest.raises(ValueError, match="path_counter"):
        cs._check_paths(torch.zeros(3, dtype=torch.int32), 2, u.device)


# ------------------------------------------------------------------ #
# The calling seam (ops/_build.py): launches, their counts, the caps
# ------------------------------------------------------------------ #

def test_device_caps_answer_the_h100_for_the_cpu():
    """A tensor on the CPU plans against the H100's limits: 232,448 bytes
    of opt-in shared memory a block (less the tile kernel's static 32),
    132 SMs, cooperative launches."""
    caps = _build.device_caps("cpu")
    assert caps == _build.DeviceCaps(_build.H100_L2_BYTES,
                                     _build.H100_SMEM_OPTIN,
                                     _build.H100_SM_COUNT, True)
    assert (caps.smem_optin, caps.sm_count) == (232448, 132)
    assert _build.device_caps(torch.device("cpu")) == caps
    assert _build.smem_limit("cpu") == 232448 - _build.STATIC_SMEM == 232416


#: Plans at the benchmark's and the tests' shapes, as the planners gave
#: them before the caps moved to ``_build``: (planner, arguments, plan).
PINNED_PLANS = [
    ("tile", (2560, 2048, 8), (64, 128, 8, (40, 16))),
    ("tile", (640, 1024, 8), (64, 128, 8, (10, 8))),
    ("tile", (4099, 4097, 8), (64, 128, 8, (65, 33))),
    ("tile", (37, 53, 4), (40, 64, 4, (1, 1))),
    ("tile", (4096, 4096, 8, 16), (16, 128, 8, (256, 32))),
    ("resident", (640, 1024), (1, 640, 1024, 1, 7, 46, 114, 14, 9, 1)),
    ("resident", (640, 1024, 4), (1, 640, 1024, 1, 4, 46, 114, 14, 9, 1)),
    ("resident", (96, 80), (1, 96, 80, 1, 6, 6, 80, 16, 1, 1)),
    ("resident", (2560, 2048), None),
    ("ensemble", (8, 640, 1024, 1), (8, 640, 1024, 1, 4, 59, 342, 11, 3, 4)),
    ("ensemble", (3, 96, 80, 2), (3, 96, 80, 2, 4, 8, 80, 12, 1, 3)),
    ("td_rows", (1, 2560, 2048), (1, True, 53248, 256, 4, 640, 44)),
    ("td_rows_rhs", (1, 2560, 2048), (1, True, 61952, 256, 4, 640, 44)),
    ("td_lanes", (1, 2560, 2048), (1, True, 50176, 80, 1, 0, 0)),
    ("td_lanes_rhs", (1, 2560, 2048), (1, True, 52288, 80, 1, 0, 0)),
    ("td_rows_rhs", (8, 640, 1024), (2, True, 88064, 128, 1, 0, 0)),
    ("td_lanes_rhs", (8, 640, 1024), (2, True, 80000, 80, 1, 0, 0)),
    ("td_rows", (200, 4096, 4096), (4, True, 163840, 6400, 1, 0, 0)),
    ("td_rows_rhs", (1, 4096, 4096), (1, True, 74240, 256, 2, 2048, 44)),
    ("td_rows_rhs", (4, 2560, 2048), (2, True, 103424, 128, 1, 0, 0)),
]


@pytest.mark.parametrize("planner,args,want", PINNED_PLANS)
def test_plans_are_pinned_on_the_cpu(planner, args, want):
    """``tile_plan``, ``resident_plan``, ``plan_resident``,
    ``plan_td_rows`` and ``plan_td_lanes`` on the CPU: the plans the card
    would launch at these shapes, unchanged but for H10's split where a
    batch has fewer panels than SMs (P = 4 at 1 x 2560 x 2048, 2 at 1 x
    4096^2; at 4 x 2560 x 2048 the unsplit plan). A split plan proves
    that the H100 holds all its blocks at once."""
    from heat2d_tpu_torch.ops import tridiag as td
    if planner == "tile":
        nx, ny, t, *ty = args
        got = cs.tile_plan(nx, ny, t, "cpu", *ty)
    elif planner == "resident":
        nx, ny, *k = args
        got = cs.resident_plan(nx, ny, "cpu", *k)
    elif planner == "ensemble":
        nb, nx, ny, w = args
        got = rs.plan_resident(nb, nx, ny, w, "cpu")
    else:
        fn = td.plan_td_rows if planner.startswith("td_rows") \
            else td.plan_td_lanes
        rhs = planner.endswith("_rhs")
        got = fn(*args, rhs=rhs)
        if got.segments > 1:
            per_sm = td.rows_per_sm("cpu", rhs, got.coef_smem,
                                    got.smem_bytes)
            assert per_sm in (3, 4) and got.blocks <= 132 * per_sm
    assert got == want


#: The wrapper names the counts were kept under before they moved to
#: ``_build``: the union of the five kernel modules' counters, in order.
LAUNCH_KEYS = ["step", "tile_multi", "tile_multi_resid", "resident",
               "ens_resident", "ens_tile_multi", "ens_tile_multi_conv",
               "fam_resident", "fam_tile_multi", "shard_tile_multi",
               "shard_tile_multi_resid", "shard_fused", "td_coeffs",
               "td_rows", "td_lanes"]


def _launch_stencil(monkeypatch):
    u = torch.zeros(40, 56)
    cs._tile_launch(u, 3, 0.1, 0.1, cs.FORM_FMA, 8, False)
    cs._tile_launch(u, 3, 0.1, 0.1, cs.FORM_FMA, 8, True)
    cs._resident_launch(u, 5, 0.1, 0.1, cs.FORM_FMA,
                        cs.resident_plan(40, 56, "cpu"))
    return {"step": 0, "tile_multi": 1, "tile_multi_resid": 1,
            "resident": 1}


def _launch_ensemble(monkeypatch):
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    u, c = torch.zeros(2, 40, 56), torch.full((2,), 0.1)
    ce._tile_launch(u, 3, c, c, None, False, "ens_tile_multi")
    ce._tile_launch(u, 3, c, c, torch.ones(2, dtype=torch.int32), True,
                    "ens_tile_multi_conv")
    ce._resident_launch(u, 5, c, c, rs.plan_resident(2, 40, 56, 1, "cpu"))
    return {"ens_resident": 1, "ens_tile_multi": 1,
            "ens_tile_multi_conv": 1}


def _launch_family(monkeypatch):
    from heat2d_tpu_torch.ops import cuda_family as cf
    u, c = torch.zeros(2, 40, 56), torch.full((2,), 0.05)
    scal = cf.scalar_block("heat9", c, c)
    cf._resident_launch(u, 5, scal, "heat9",
                        rs.plan_resident(2, 40, 56, 2, "cpu"))
    cf._tile_launch(u, 3, scal, "heat9",
                    cf.tile_plan(40, 56, "heat9", "cpu", 3))
    return {"fam_resident": 1, "fam_tile_multi": 1}


def _launch_shard(monkeypatch):
    import contextlib

    from heat2d_tpu_torch.ops import cuda_shard as csh
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    u, t = torch.zeros(40, 56), 8
    strips = [torch.zeros(t, 56), torch.zeros(t, 56), torch.zeros(56, t),
              torch.zeros(56, t)]
    for resid in (False, True):
        csh._shard_launch(u, strips, 3, 0, 0, 80, 112, 0.1, 0.1,
                          csh.FORM_FMA, resid)
    return {"shard_tile_multi": 1, "shard_tile_multi_resid": 1,
            "shard_fused": 0}


def _launch_tridiag(monkeypatch):
    from heat2d_tpu_torch.ops import tridiag as td
    x, c = torch.zeros(2, 70, 37), torch.ones(2)
    td._launch("td_rows", x, c, td.td_coeffs(c, 70))
    td._launch("td_lanes", x, c, td.td_coeffs(c, 37), c)
    return {"td_coeffs": 0, "td_rows": 1, "td_lanes": 1}


@pytest.mark.parametrize("library,drive", [
    ("stencil", _launch_stencil), ("ensemble", _launch_ensemble),
    ("family", _launch_family), ("shard", _launch_shard),
    ("tridiag", _launch_tridiag)])
def test_each_wrapper_launch_counts_under_its_name(library, drive,
                                                   monkeypatch):
    """Each kernel module's card side, its launches sent to a recording
    library: every launch reaches its library's entry point with the
    entry's full C signature, the current stream last, and counts once
    under its wrapper's name (``_build.launch_counts``) and its entry's
    (``_build.entry_launches``); the registry's keys are the kernel
    modules' former counters, which ``analysis.launch_pin`` reads."""
    from heat2d_tpu_torch.analysis import launch_pin
    recorded = record_launches(monkeypatch)
    _build.reset_launch_counts()
    entries = list(_build.SIGNATURES[library])
    before = [_build.entry_launches(e) for e in entries]
    want = drive(monkeypatch)
    assert _build.launch_counts(library) == want
    assert sum(_build.launch_counts().values()) == sum(want.values())
    assert list(launch_pin.launch_counts()) == LAUNCH_KEYS
    assert len(recorded) == sum(want.values())
    for entry, args in recorded:
        assert len(args) == len(_build.SIGNATURES[library][entry][1])
        assert args[-1] == 7
    made = [e for e, _ in recorded]
    assert [_build.entry_launches(e) - b for e, b in
            zip(entries, before)] == [made.count(e) for e in entries]
