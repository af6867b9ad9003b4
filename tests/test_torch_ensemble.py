"""The port's ensembles (``heat2d_tpu_torch/models/ensemble.py`` and the
plain versions of the ensemble kernels, ``ops/cuda_ensemble.py``) against
``heat2d_tpu/models/ensemble.py`` on the CPU, on the same inputs made
with numpy from a seed.

The JAX kernels run as its own tests run them here: B5 (``pallas``) and
B6 (``band``, the VMEM budget pinned small so members stream in several
bands) in interpret mode. B7 and B8 do not run on the CPU (they set no
interpret flag), so the streamed convergence reference is the JAX
package's pair-tracked loop over B6, whose steps and residual pairs are
the fused schedule's.

Tolerance for the grids: ``n * 2**-21 * max|u|`` after n steps (the port
rounds every operation, XLA's CPU backend may contract multiply-adds).
``steps_done`` must be equal.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat2d_tpu.ops.pallas_stencil as ps
from heat2d_tpu.models import ensemble as jens
from heat2d_tpu.ops.init import inidat as jinidat
from heat2d_tpu.ops.stencil import residual_sq as jres
from heat2d_tpu_torch.models import ensemble as tens
from heat2d_tpu_torch.ops import cuda_ensemble as ce
from heat2d_tpu_torch.ops import cuda_stencil as cs

SHAPES = [(16, 128), (36, 128), (24, 32)]
MEMBERS = [1, 3, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_vmem(monkeypatch):
    """Pin the JAX package's VMEM budget small: its band route then
    streams every member in 8-row bands with pad rows."""
    monkeypatch.setattr(ps, "VMEM_BUDGET_BYTES", 8 * 128 * 4 * 4)


def _inputs(rng, b, shape, noise=True):
    """Per-member f32 (cx, cy) in the stability box, and a batch of
    inidat grids with seeded noise (so held boundary values vary)."""
    cxs = rng.uniform(0.01, 0.24, b).astype(np.float32)
    cys = rng.uniform(0.01, 0.24, b).astype(np.float32)
    u = np.broadcast_to(np.asarray(jinidat(*shape)), (b,) + shape).copy()
    if noise:
        u += rng.random(u.shape, dtype=np.float32) * 1000
    return cxs, cys, u


def _close(got, want, n):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = max(1, n) * 2.0 ** -21 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


# ------------------------------------------------------------------ #
# run_ensemble, route by route
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("b", MEMBERS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", ["jnp", "pallas", "band"])
def test_run_ensemble_matches_jax(method, shape, b, rng, small_vmem):
    cxs, cys, u = _inputs(rng, b, shape)
    steps = 11
    want = jens.run_ensemble(*shape, steps, cxs, cys, u0=u, method=method)
    got = tens.run_ensemble(*shape, steps, cxs, cys, u0=u, method=method,
                            device="cpu")
    _close(got, want, steps)


def test_default_u0_is_inidat_copies():
    got = tens.run_ensemble(12, 16, 0, [0.1, 0.2], [0.1, 0.1],
                            device="cpu")
    want = np.asarray(jens.run_ensemble(12, 16, 0, [0.1, 0.2],
                                        [0.1, 0.1]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_auto_routes_like_the_card():
    assert tens._pick_method("auto", 640, 1024, "cpu") == "pallas"
    assert tens._pick_method("auto", 4096, 4096, "cpu") == "band"
    assert tens._pick_method("jnp", 4096, 4096, "cpu") == "jnp"


# ------------------------------------------------------------------ #
# Each kernel's plain version against the JAX kernel it replaces
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("b", MEMBERS)
def test_ens_resident_plain_vs_ensemble_kernel(b, rng):
    """H5 <- B5 (``_run_batch_pallas``, interpret mode)."""
    cxs, cys, u = _inputs(rng, b, (16, 128))
    want = jax.jit(lambda v: jens._run_batch_pallas(
        v, jnp.asarray(cxs), jnp.asarray(cys), steps=9))(u)
    got = ce.ens_resident(torch.from_numpy(u), 9, torch.from_numpy(cxs),
                          torch.from_numpy(cys))
    _close(got, want, 9)


@pytest.mark.parametrize("nsub", [1, 5, 8])
@pytest.mark.parametrize("shape", [(36, 128), (24, 32)])
def test_ens_tile_multi_plain_vs_band_kernel(shape, nsub, rng, small_vmem):
    """H6 <- B6 (``_run_batch_band``: band sweeps, interpret mode)."""
    cxs, cys, u = _inputs(rng, 3, shape)
    want = jax.jit(lambda v: jens._run_batch_band(
        v, jnp.asarray(cxs), jnp.asarray(cys), steps=nsub))(u)
    got = ce.ens_tile_multi(torch.from_numpy(u), nsub,
                            torch.from_numpy(cxs), torch.from_numpy(cys))
    _close(got, want, nsub)


@pytest.mark.parametrize("nsub", [1, 5, 8])
def test_ens_tile_multi_conv_plain_vs_band_and_residual(nsub, rng,
                                                         small_vmem):
    """H7 <- B8, whose result is: active members advanced ``nsub`` steps
    (B6 here), frozen ones unchanged, each active member's residual of
    the last step pair, frozen ones 0."""
    cxs, cys, u = _inputs(rng, 4, (36, 128))
    active = np.array([1, 0, 1, 0], np.int32)
    jc, jy = jnp.asarray(cxs), jnp.asarray(cys)
    prev = jens._run_batch_band(jnp.asarray(u), jc, jy, steps=nsub - 1) \
        if nsub > 1 else jnp.asarray(u)
    last = jens._run_batch_band(prev, jc, jy, steps=1)
    got, res = ce.ens_tile_multi_conv(
        torch.from_numpy(u), nsub, torch.from_numpy(cxs),
        torch.from_numpy(cys), torch.from_numpy(active), resid=True)
    for m in range(4):
        if active[m]:
            _close(got[m], last[m], nsub)
            want = float(jres(last[m], prev[m]))
            assert float(res[m]) == pytest.approx(want, rel=2e-3)
        else:
            assert torch.equal(got[m], torch.from_numpy(u[m]))
            assert float(res[m]) == 0.0


def test_k0_is_float32_arithmetic():
    """k0 = (1 - 2cx) - 2cy in f32, as B5-B8 compute it from their f32
    scalars (the single-grid kernels take k0 computed in double)."""
    cxs = torch.tensor([0.1, 0.07, 0.2], dtype=torch.float32)
    cys = torch.tensor([0.07, 0.1, 0.13], dtype=torch.float32)
    k0 = cs._k0(*ce.member_coefs(cxs, cys))
    one, two = np.float32(1), np.float32(2)
    for i in range(3):
        cx, cy = np.float32(cxs[i]), np.float32(cys[i])
        assert np.float32(k0[i, 0, 0]) == one - two * cx - two * cy
    # the double-precision k0 of cs._k0 differs by an ulp here
    assert np.float32(cs._k0(float(cxs[0]), float(cys[0]))) \
        != np.float32(k0[0, 0, 0])


def test_plain_versions_count_no_launches(rng):
    ce.reset_launch_counts()
    cxs, cys, u = (torch.from_numpy(a) for a in _inputs(rng, 2, (12, 12)))
    ce.ens_resident(u, 3, cxs, cys)
    ce.ens_tiled_chunk(u, 11, cxs, cys)
    ce.ens_tile_multi_conv(u, 2, cxs, cys, torch.ones(2, dtype=torch.int32),
                           resid=True)
    assert set(ce.launch_counts().values()) == {0}


# ------------------------------------------------------------------ #
# H6/H7's plan: H2's strip sweep, one member at a time
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("shape", [(36, 128), (24, 32), (4096, 4096),
                                   (4099, 4097)])
def test_tile_plan_is_the_strip_sweeps(shape):
    """H6/H7 tile a member as H2 tiles a grid: ``plan_strip_sweep`` at
    depth T within the H100's limits (two blocks of 16 warps an SM)."""
    plan = ce.tile_plan(*shape, "cpu")
    assert plan == cs.plan_strip_sweep(*shape, cs.DEFAULT_TSTEPS)
    assert plan == cs.tile_plan(*shape, cs.DEFAULT_TSTEPS, "cpu")
    assert plan.tsteps == cs.DEFAULT_TSTEPS and ce.STRIP == 8


@pytest.mark.parametrize("b", MEMBERS)
@pytest.mark.parametrize("shape, fast, edge", [
    ((4096, 4096), 1860, 188),    # legs (b) and (c): 2048 tiles a member
    ((4099, 4097), 1860, 285),    # a member too large for H5
    ((37, 53), 0, 1),             # edge tiles only
])
def test_tile_paths_are_h2s_times_members(shape, fast, edge, b):
    """The planner's count of H6/H7's tiles by path is H2's on one member
    times the members (a frozen member's tiles count too)."""
    plan = ce.tile_plan(*shape, "cpu")
    assert cs.tile_paths(plan, *shape) == {"fast": fast, "edge": edge}
    assert ce.tile_paths(plan, b, *shape) == {"fast": b * fast,
                                              "edge": b * edge}
    assert cs.TILE_PATHS == ("fast", "edge")


@pytest.mark.parametrize("resid", [False, True])
def test_tile_launch_passes_the_strip_plan(monkeypatch, resid):
    """What one H6/H7 launch hands the kernel: the batch's shape, the
    plan's ring, depth and tile, a (B, tiles) buffer of partials with
    ``resid``, and the ``paths`` count (the kernel's C entry point stubbed
    out: the CPU has no card)."""
    calls = []

    class Lib:
        def heat_ens_tile(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(ce, "_lib", Lib)
    monkeypatch.setattr(ce, "_stream", lambda u: ctypes.c_void_p(0))
    b, nx, ny = 3, 300, 520
    u = torch.zeros(b, nx, ny)
    cxs = cys = torch.full((b,), 0.1)
    active = torch.ones(b, dtype=torch.int32)
    counted = cs.path_counter("cpu")
    ce.reset_launch_counts()
    name = "ens_tile_multi_conv" if resid else "ens_tile_multi"
    _, parts = ce._tile_launch(u, 5, cxs, cys, active if resid else None,
                               resid, name, counted)
    plan = ce.tile_plan(nx, ny, "cpu")
    (args,) = calls
    assert args[7:14] == (b, nx, ny, plan.tsteps, 5, plan.ty, plan.tx)
    assert args[3].value == counted.data_ptr()
    assert (args[6].value is not None) == resid
    if resid:
        assert tuple(parts.shape) == (b, plan.ntiles)
        assert args[2].value == parts.data_ptr()
    else:
        assert parts is None and args[2].value is None
    assert ce.launch_counts()[name] == 1


def test_paths_count_nothing_on_the_cpu(rng):
    """The plain versions, which CPU tensors take, add no tile to a
    ``paths`` count."""
    cxs, cys, u = (torch.from_numpy(a) for a in _inputs(rng, 2, (36, 128)))
    counted = cs.path_counter("cpu")
    got = ce.ens_tile_multi(u, 8, cxs, cys, paths=counted)
    assert torch.equal(got, ce.ens_multi_step_plain(u, 8, cxs, cys))
    ce.ens_tile_multi_conv(u, 8, cxs, cys, torch.ones(2, dtype=torch.int32),
                           resid=True, paths=counted)
    assert counted.dtype == torch.int32 and counted.tolist() == [0, 0]


@pytest.mark.parametrize("bad", [
    dict(u=torch.zeros(2, 8, 8, dtype=torch.float64)),
    dict(cxs=torch.zeros(3)),
    dict(cxs=torch.zeros(2, dtype=torch.float64)),
    dict(nsub=9),
    dict(nsub=0),
])
def test_wrappers_reject_bad_inputs(bad):
    kw = dict(u=torch.zeros(2, 8, 8), cxs=torch.zeros(2),
              cys=torch.zeros(2), nsub=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        ce.ens_tile_multi(kw["u"], kw["nsub"], kw["cxs"], kw["cys"])


# ------------------------------------------------------------------ #
# Convergence: steps_done exactly, grids within tolerance
# ------------------------------------------------------------------ #

#: Binary-exact diffusivities (k0 is the same in f32 and in double), and
#: a sensitivity between the members' chunk-1 residuals: the slow member
#: exits at chunk 1, the fast one runs the budget and the remainder.
CONV_CASES = [
    # (shape, steps, interval, sensitivity, cxs)
    ((36, 128), 200, 10, 2e8, [0.03125, 0.25]),
    ((16, 128), 150, 20, 1e8, [0.03125, 0.25, 0.0625]),
    ((24, 32), 57, 8, 2.4e6, [0.25, 0.03125, 0.125]),
]


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("method", ["jnp", "pallas", "band"])
def test_convergence_matches_jax(method, case, small_vmem):
    shape, steps, interval, sens, cxs = case
    if method == "band":
        # B7/B8 have no CPU route; the reference is the JAX package's
        # pair-tracked loop over its B6 band runner.
        want, kw = jax.jit(lambda u: jens._run_batch_conv_kernel(
            u, jnp.asarray(cxs, jnp.float32), jnp.asarray(cxs, jnp.float32),
            steps=steps, interval=interval, sensitivity=sens,
            runner=jens._run_batch_band))(
                jnp.broadcast_to(jinidat(*shape), (len(cxs),) + shape))
    else:
        want, kw = jens.run_ensemble_convergence(
            *shape, steps, interval, sens, cxs, cxs, method=method)
    got, kg = tens.run_ensemble_convergence(
        *shape, steps, interval, sens, cxs, cxs, method=method,
        device="cpu")
    kw = [int(k) for k in kw]
    assert kg.tolist() == kw
    assert len(set(kw)) > 1, kw
    for m, k in enumerate(kw):
        _close(got[m], np.asarray(want)[m], k)


def test_band_convergence_equals_pallas_convergence():
    """The fused H7 schedule and the pair-tracked loop over H5 are the
    same computation in the plain versions: equal bit for bit."""
    args = (36, 128, 200, 10, 2e8, [0.03125, 0.25], [0.03125, 0.25])
    a, ka = tens.run_ensemble_convergence(*args, method="band",
                                          device="cpu")
    b, kb = tens.run_ensemble_convergence(*args, method="pallas",
                                          device="cpu")
    assert ka.tolist() == kb.tolist()
    assert torch.equal(a, b)


def test_convergence_taps_one_read_per_chunk():
    reads = []
    _, k = tens.run_ensemble_convergence(
        16, 32, 95, 10, 1e3, [0.1, 0.2], [0.1, 0.1], method="band",
        tap=lambda i, k, res, done: reads.append((i, k.tolist())),
        device="cpu")
    # no early exit at this sensitivity: 9 checked chunks, then the
    # unchecked 5-step remainder
    assert k.tolist() == [95, 95]
    assert [r[0] for r in reads] == list(range(1, 10))
    assert reads[-1][1] == [90, 90]


# ------------------------------------------------------------------ #
# Entry points
# ------------------------------------------------------------------ #

def test_timed_ensemble_and_summary(rng):
    cxs, cys, u = _inputs(rng, 3, (16, 32), noise=False)
    r = tens.timed_ensemble(16, 32, 40, cxs, cys, convergence=True,
                            interval=10, sensitivity=1.0, device="cpu")
    assert r.method == "pallas" and r.elapsed > 0
    assert r.residual_reads == 4          # the timed run's reads only
    jb, jk, _ = jens.timed_ensemble(16, 32, 40, cxs, cys, convergence=True,
                                    interval=10, sensitivity=1.0)
    assert r.steps_done.tolist() == [int(k) for k in jk]
    want = jens.ensemble_summary(np.asarray(jb), steps_done=jk)
    got = tens.ensemble_summary(r.batch, steps_done=r.steps_done)
    assert got["members"] == want["members"] == 3
    assert got["steps_done"] == want["steps_done"]
    np.testing.assert_allclose(got["total_heat"], want["total_heat"],
                               rtol=1e-5)
    fixed = tens.timed_ensemble(16, 32, 5, cxs, cys, device="cpu")
    assert fixed.steps_done is None and fixed.residual_reads == 0


def test_batch_runner_is_memoized_per_signature():
    tens.batch_runner.cache_clear()
    a = tens.batch_runner(24, 32, 6, "auto", device="cpu")
    assert tens.batch_runner(24, 32, 6, "auto", device="cpu") is a
    assert a.method == "pallas"
    c = tens.batch_runner(24, 32, 6, "auto", True, 3, 0.5, device="cpu")
    assert c is not a
    assert tens.batch_runner.cache_info().currsize == 2


@pytest.mark.parametrize("kw,match", [
    (dict(problem="reactdiff", method="adi"), "does not support method"),
    (dict(problem="heat9", method="mg"), "does not support method"),
    (dict(problem="varcoef", method="band"), "no 'band' kernel template"),
    (dict(method="rk4"), "not in"),
])
def test_unported_methods_and_problems_raise(kw, match):
    """What the ensembles still refuse: the combinations the capability
    matrix rules out (``ConfigError``, a ``ValueError``) and unknown
    methods."""
    with pytest.raises(ValueError, match=match):
        tens.run_ensemble(8, 8, 1, [0.1], [0.1], device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(method="adi"), dict(method="mg"),
                                dict(problem="heat9")])
def test_implicit_methods_and_families_run_like_jax(kw):
    """The methods and the family this port once refused run, and agree
    with the JAX package (tolerance of tests/test_torch_implicit.py and
    tests/test_torch_problems.py: n * 66 * 2**-24 * max|u| covers both
    at this size)."""
    cxs, cys = [0.1, 0.2], [0.15, 0.1]
    want = np.asarray(jens.run_ensemble(8, 8, 3, cxs, cys, **kw))
    got = tens.run_ensemble(8, 8, 3, cxs, cys, device="cpu", **kw).numpy()
    assert np.abs(got - want).max() <= 3 * 66 * 2.0 ** -24 * np.abs(
        want).max()


def test_validates_shapes_like_jax():
    for args, kw in [((8, 8, 1, [0.1, 0.2], [0.1]), {}),
                     ((8, 8, 1, [0.1], [0.1]),
                      dict(u0=np.zeros((2, 8, 8), np.float32)))]:
        with pytest.raises(ValueError):
            jens.run_ensemble(*args, **kw)
        with pytest.raises(ValueError):
            tens.run_ensemble(*args, device="cpu", **kw)


# --------------------------------------------------------------------- #
# Members over several device slots: sharded and spatial ensembles
# --------------------------------------------------------------------- #

def _slots(n):
    from heat2d_tpu_torch.parallel.mesh import host_devices
    return host_devices(n, "cpu")


@pytest.mark.parametrize("method", ["jnp", "pallas", "band"])
@pytest.mark.parametrize("members", [3, 8, 9])
def test_sharded_matches_single_and_jax(members, method):
    """Members over 8 CPU slots (uneven counts padded with inert members)
    equal the single-device batch bit for bit, and the JAX package's
    sharded run within the bound."""
    cxs = [0.02 * (i + 1) for i in range(members)]
    cys = [0.1] * members
    got = tens.run_ensemble_sharded(8, 16, 12, cxs, cys, method=method,
                                    devices=_slots(8))
    assert tuple(got.shape) == (members, 8, 16)
    assert torch.equal(got, tens.run_ensemble(8, 16, 12, cxs, cys,
                                              method=method,
                                              device="cpu"))
    want = np.asarray(jens.run_ensemble_sharded(8, 16, 12, cxs, cys,
                                                method="jnp"))
    _close(got.numpy(), want, 12)


@pytest.mark.parametrize("method", ["jnp", "band", "pallas"])
def test_convergence_sharded_matches_single_and_jax(method):
    """Convergence over the slots (a loop per slot, driven a chunk at a
    time in turn; inert pads converge at once): bitwise the single-device
    run, steps_done equal to it and to the JAX package's."""
    cxs = [0.02, 0.05, 0.1, 0.15, 0.2]
    cys = list(cxs)
    want, kw = tens.run_ensemble_convergence(12, 16, 400, 20, 5.0, cxs,
                                             cys, method=method,
                                             device="cpu")
    got, kg = tens.run_ensemble_convergence_sharded(
        12, 16, 400, 20, 5.0, cxs, cys, method=method, devices=_slots(8))
    assert tuple(got.shape) == (5, 12, 16)
    assert kg.tolist() == kw.tolist()
    assert torch.equal(got, want)
    jwant, jk = jens.run_ensemble_convergence_sharded(
        12, 16, 400, 20, 5.0, cxs, cys, method="jnp")
    assert kg.tolist() == [int(x) for x in jk]
    assert len(set(kg.tolist())) > 1
    _close(got.numpy(), np.asarray(jwant), int(kg.max()))


def test_drive_all_launches_every_slot_before_a_read():
    """The round-robin driver: each loop's chunk is issued before any
    loop resumes to read its flag."""
    log = []

    def loop(name, chunks):
        for i in range(chunks):
            log.append((name, "launch", i))
            yield
            log.append((name, "read", i))
        return name

    assert tens._drive_all([loop("a", 2), loop("b", 3)]) == ["a", "b"]
    assert log[:2] == [("a", "launch", 0), ("b", "launch", 0)]
    assert log.index(("b", "launch", 0)) < log.index(("a", "read", 0))


@pytest.mark.parametrize("halo", ["collective", "fused"])
@pytest.mark.parametrize("grid,members", [((2, 1), 2), ((2, 2), 3)])
def test_spatial_bitwise_vs_dist2d_runs(grid, members, halo):
    """Each member on its own (gridx, gridy) submesh equals its own
    dist2d run of the same (cx, cy) bit for bit (the uneven batch pads an
    inert member), and the JAX package's spatial run within the bound."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    gx, gy = grid
    cxs, cys = [0.05, 0.1, 0.2][:members], [0.1, 0.05, 0.15][:members]
    batch, ks = tens.run_ensemble_spatial(16, 12, 25, cxs, cys, gridx=gx,
                                          gridy=gy, halo=halo,
                                          halo_depth=2, devices=_slots(8))
    assert tuple(batch.shape) == (members, 16, 12)
    assert ks.tolist() == [25] * members
    for i, (cx, cy) in enumerate(zip(cxs, cys)):
        cfg = HeatConfig(nxprob=16, nyprob=12, steps=25, mode="dist2d",
                         gridx=gx, gridy=gy, cx=cx, cy=cy, halo=halo,
                         halo_depth=2)
        want = Heat2DSolver(cfg, devices=_slots(gx * gy)).run(timed=False)
        assert np.array_equal(batch[i].numpy(), want.u)
    jb, jk = jens.run_ensemble_spatial(16, 12, 25, cxs, cys, gridx=gx,
                                       gridy=gy, halo=halo, halo_depth=2)
    assert [int(k) for k in jk] == ks.tolist()
    _close(batch.numpy(), np.asarray(jb), 25)


def test_spatial_convergence_matches_individual_and_jax():
    """Per-member early exit on the batch x spatial mesh (masked
    completion): steps_done and planes bit for bit the individual dist2d
    convergence runs; steps_done equal to the JAX package's."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    cxs, cys = [0.02, 0.2], [0.02, 0.2]
    steps, interval, sens = 400, 20, 5.0
    batch, ks = tens.run_ensemble_spatial(
        12, 16, steps, cxs, cys, gridx=2, gridy=1, convergence=True,
        interval=interval, sensitivity=sens, devices=_slots(4))
    for i, (cx, cy) in enumerate(zip(cxs, cys)):
        cfg = HeatConfig(nxprob=12, nyprob=16, steps=steps, mode="dist2d",
                         gridx=2, gridy=1, cx=cx, cy=cy, convergence=True,
                         interval=interval, sensitivity=sens)
        r = Heat2DSolver(cfg, devices=_slots(2)).run(timed=False)
        assert int(ks[i]) == r.steps_done
        assert np.array_equal(batch[i].numpy(), r.u)
    assert len(set(ks.tolist())) > 1
    jb, jk = jens.run_ensemble_spatial(
        12, 16, steps, cxs, cys, gridx=2, gridy=1, convergence=True,
        interval=interval, sensitivity=sens)
    assert [int(k) for k in jk] == ks.tolist()
    _close(batch.numpy(), np.asarray(jb), int(ks.max()))


def test_spatial_refuses_too_few_slots_like_jax():
    with pytest.raises(ValueError) as t:
        tens.run_ensemble_spatial(16, 16, 2, [0.1], [0.1], gridx=2,
                                  gridy=2, devices=_slots(3))
    with pytest.raises(ValueError) as j:
        jens.run_ensemble_spatial(16, 16, 2, [0.1], [0.1], gridx=2,
                                  gridy=2, devices=jax.devices()[:3])
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("args", [
    (16, 16, 2, 2, "collective", None), (16, 16, 2, 2, "fused", 2),
    (48, 64, 2, 4, "fused", None), (15, 18, 2, 4, "fused", None),
    (64, 64, 1, 1, "fused", None), (24, 24, 4, 2, "fused", 20)])
def test_spatial_halo_plan_equals_jax(args):
    nx, ny, gx, gy, halo, depth = args
    assert tens.spatial_halo_plan(nx, ny, gx, gy, halo=halo,
                                  halo_depth=depth) == \
        jens.spatial_halo_plan(nx, ny, gx, gy, halo=halo,
                               halo_depth=depth)


def test_timed_ensemble_sharded_and_spatial():
    """``timed_ensemble`` over the slots: the sharded route reports the
    slots' method, the spatial route ``spatial``; both match the
    single-device run; a family other than heat5 is refused with the
    JAX package's text."""
    cxs, cys = [0.1, 0.2, 0.15], [0.1, 0.1, 0.05]
    single = tens.timed_ensemble(8, 16, 5, cxs, cys, method="jnp",
                                 device="cpu")
    sharded = tens.timed_ensemble(8, 16, 5, cxs, cys, method="jnp",
                                  sharded=True, devices=_slots(2))
    spatial = tens.timed_ensemble(8, 16, 5, cxs, cys, spatial_grid=(2, 2),
                                  devices=_slots(8))
    assert sharded.method == "jnp" and spatial.method == "spatial"
    assert single.steps_done is None and spatial.steps_done is None
    assert torch.equal(sharded.batch, single.batch)
    assert torch.equal(spatial.batch, single.batch)
    assert sharded.elapsed > 0 and spatial.elapsed > 0
    conv = tens.timed_ensemble(8, 16, 40, cxs, cys, method="band",
                               sharded=True, devices=_slots(2),
                               convergence=True, interval=10,
                               sensitivity=1e3)
    assert conv.residual_reads >= 2
    from heat2d_tpu_torch.config import ConfigError
    with pytest.raises(ConfigError) as t:
        tens.timed_ensemble(8, 16, 5, cxs, cys, problem="heat9",
                            sharded=True, devices=_slots(2))
    with pytest.raises(Exception) as j:
        jens.timed_ensemble(8, 16, 5, cxs, cys, problem="heat9",
                            sharded=True)
    assert str(t.value) == str(j.value)
