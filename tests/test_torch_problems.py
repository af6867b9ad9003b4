"""The port's problem families (``heat2d_tpu_torch/problems/``, the plain
versions of the family kernels H8/H9 in ``ops/cuda_family.py``, the
family stability bounds and the family branch of config and serving
admission) against ``heat2d_tpu/problems`` on the CPU, on the same
inputs made with numpy from a seed.

The JAX kernels B9 (``pallas``) and B10 (``band``) run as its own tests
run them here, in interpret mode. Tolerance of a grid after n steps:
``n * C * 2**-24 * max|u|``, with ``C`` the family's rounding factor
(``cuda_family.rounding_factor``: rounded operations of one update times
its largest partial result; 8 for heat5 and varcoef); the port rounds
every operation, XLA's CPU backend may contract multiply-adds. Error
texts are compared with JAX's word for word (its em dash is the port's
hyphen).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu import config as jcfg
from heat2d_tpu.models import ensemble as jens
from heat2d_tpu.ops import stability as jstab
from heat2d_tpu.ops.stencil import stencil_step_var as jstep_var
from heat2d_tpu.problems import get_family as jget
from heat2d_tpu.problems import kernels as jk
from heat2d_tpu.problems import runners as jrun
from heat2d_tpu.serve.schema import SolveRequest as JRequest
from heat2d_tpu_torch import config as tcfg
from heat2d_tpu_torch.models import ensemble as tens
from heat2d_tpu_torch.ops import cuda_family as cf
from heat2d_tpu_torch.ops import stability as tstab
from heat2d_tpu_torch.ops.stencil import stencil_step, stencil_step_var
from heat2d_tpu_torch.problems import family_names, get_family
from heat2d_tpu_torch.problems import kernels as tk
from heat2d_tpu_torch.problems import runners as trun
from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest
from heat2d_tpu_torch.vocab import PROBLEMS

FAMILIES = PROBLEMS
KERNEL_FAMILIES = ("heat9", "advdiff", "reactdiff")
#: per-family (cx, cy) ranges inside each explicit bound
COEFS = {"heat5": (0.01, 0.24), "varcoef": (0.01, 0.24),
         "heat9": (0.01, 0.17), "advdiff": (0.01, 0.24),
         "reactdiff": (0.01, 0.24)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _factor(fam):
    return cf.rounding_factor(fam) if fam in KERNEL_FAMILIES else 8.0


def _close(got, want, n, fam):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = max(1, n) * _factor(fam) * 2.0 ** -24 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


def _state(rng, shape):
    """A positive O(1) field (inside every family's stable regime)."""
    return rng.uniform(0.2, 1.0, shape).astype(np.float32)


def _coefs(rng, fam, b):
    lo, hi = COEFS[fam]
    return (rng.uniform(lo, hi, b).astype(np.float32),
            rng.uniform(lo, hi, b).astype(np.float32))


def _norm(msg: str) -> str:
    return msg.replace("—", "").replace("-", "")


# ------------------------------------------------------------------ #
# The registry and each family's plain step
# ------------------------------------------------------------------ #

def test_registry_matches_jax():
    assert family_names() == FAMILIES
    for fam in FAMILIES:
        f = get_family(fam)
        assert f.name == fam and f.spec.min_grid == jget(fam).spec.min_grid
        ops = f.scalars(torch.tensor([0.1]), torch.tensor([0.2]))
        jops = jget(fam).scalars(jnp.asarray(np.float32([0.1])),
                                 jnp.asarray(np.float32([0.2])))
        assert len(ops) == len(jops) == f.spec.n_scalars
        for a, b in zip(ops, jops):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (f.mode_factor is None) == (fam not in ("heat5", "heat9"))


@pytest.mark.parametrize("fam", FAMILIES)
def test_family_step_matches_jax(fam, rng):
    u = _state(rng, (20, 24))
    cx, cy = (float(c[0]) for c in _coefs(rng, fam, 1))
    uj, ut = jnp.asarray(u), torch.from_numpy(u)
    for _ in range(10):
        uj = jget(fam).step(uj, cx, cy)
        ut = get_family(fam).step(ut, cx, cy)
    _close(ut, uj, 10, fam)


@pytest.mark.parametrize("fam", FAMILIES)
def test_family_step_matches_numpy_oracle(fam, rng):
    """The plain step against the float64 oracle, cast back each step
    (rtol 2e-5, atol 2e-6: the JAX package's own bound for its steps)."""
    u = _state(rng, (18, 22))
    ut, un = torch.from_numpy(u), u.copy()
    for _ in range(10):
        ut = get_family(fam).step(ut, 0.1, 0.12)
        un = get_family(fam).np_step(un, 0.1, 0.12)
    np.testing.assert_allclose(ut.numpy(), un, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("fam", FAMILIES)
def test_numpy_oracle_equals_jax(fam, rng):
    u = _state(rng, (14, 17))
    np.testing.assert_array_equal(get_family(fam).np_step(u, 0.1, 0.12),
                                  jget(fam).np_step(u, 0.1, 0.12))


@pytest.mark.parametrize("fam", FAMILIES)
def test_batched_step_is_per_member_step(fam, rng):
    """(B, 1, 1) float32 coefficients give every member the operations of
    its single-grid step, bit for bit."""
    u = torch.from_numpy(np.stack([_state(rng, (13, 19))
                                   for _ in range(3)]))
    cxs, cys = (torch.from_numpy(c) for c in _coefs(rng, fam, 3))
    got = get_family(fam).step(u, cxs.reshape(-1, 1, 1),
                               cys.reshape(-1, 1, 1))
    for m in range(3):
        want = get_family(fam).step(u[m], float(cxs[m]), float(cys[m]))
        assert torch.equal(got[m], want)


@pytest.mark.parametrize("fam", KERNEL_FAMILIES)
def test_constants_as_operands_give_the_plain_step(fam, rng):
    """The kernels' plain version, the family constants read as operands
    from the scalar block, is the plain step bit for bit."""
    u = torch.from_numpy(np.stack([_state(rng, (12, 16))
                                   for _ in range(2)]))
    cxs, cys = (torch.from_numpy(c) for c in _coefs(rng, fam, 2))
    scal = cf.scalar_block(fam, cxs, cys)
    got = cf.fam_multi_step_plain(u, 3, scal, fam)
    want = u
    for _ in range(3):
        want = get_family(fam).step(want, cxs.reshape(-1, 1, 1),
                                    cys.reshape(-1, 1, 1))
    assert torch.equal(got, want)


def test_heat9_mode_factor_equals_jax():
    for nx, ny, cx, cy in [(17, 23, 0.1, 0.2), (65, 33, 0.05, 0.3)]:
        assert get_family("heat9").mode_factor(nx, ny, cx, cy) == \
            pytest.approx(jk.heat9_mode_factor(nx, ny, cx, cy), rel=1e-15)


def test_varcoef_profiles_within_an_ulp_of_jax():
    px, py = tk.varcoef_profiles(19, 27)
    jx, jy = jk.varcoef_profiles(19, 27)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=2 ** -23)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=2 ** -23)


def test_stencil_step_var(rng):
    """Constant fields give the constant step bit for bit; random fields
    match JAX's ``stencil_step_var``."""
    u = torch.from_numpy(_state(rng, (15, 21)))
    full = torch.full_like(u, 0.1)
    assert torch.equal(stencil_step_var(u, full, 0.5 * full),
                       stencil_step(u, 0.1, 0.05, accum_dtype=None))
    kx = rng.uniform(0.01, 0.2, (15, 21)).astype(np.float32)
    ky = rng.uniform(0.01, 0.2, (15, 21)).astype(np.float32)
    want = jstep_var(jnp.asarray(u.numpy()), jnp.asarray(kx),
                     jnp.asarray(ky))
    got = stencil_step_var(u, torch.from_numpy(kx), torch.from_numpy(ky))
    _close(got, want, 1, "varcoef")


# ------------------------------------------------------------------ #
# H8 / H9 plain versions against the JAX kernels (interpret mode)
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("fam", KERNEL_FAMILIES)
def test_fam_resident_plain_vs_family_ensemble_kernel(fam, b, rng):
    """H8 <- B9 (``_run_batch_pallas_family``)."""
    u = np.stack([_state(rng, (24, 40)) for _ in range(b)])
    cxs, cys = _coefs(rng, fam, b)
    want = jrun.fixed_runner(fam, "pallas")(
        jnp.asarray(u), jnp.asarray(cxs), jnp.asarray(cys), steps=7)
    scal = cf.scalar_block(fam, torch.from_numpy(cxs), torch.from_numpy(cys))
    got = cf.fam_resident(torch.from_numpy(u), 7, scal, fam)
    _close(got, want, 7, fam)


@pytest.mark.parametrize("nsub", [1, 5, 8])
@pytest.mark.parametrize("fam", KERNEL_FAMILIES)
def test_fam_tile_multi_plain_vs_family_band_kernel(fam, nsub, rng):
    """H9 <- B10 (``_run_batch_band_family``: band sweeps of depth w*T)."""
    u = np.stack([_state(rng, (36, 24)) for _ in range(3)])
    cxs, cys = _coefs(rng, fam, 3)
    want = jrun.fixed_runner(fam, "band")(
        jnp.asarray(u), jnp.asarray(cxs), jnp.asarray(cys), steps=nsub)
    scal = cf.scalar_block(fam, torch.from_numpy(cxs), torch.from_numpy(cys))
    got = cf.fam_tile_multi(torch.from_numpy(u), nsub, scal, fam)
    _close(got, want, nsub, fam)


def test_plain_versions_count_no_launches(rng):
    cf.reset_launch_counts()
    u = torch.from_numpy(np.stack([_state(rng, (12, 12))] * 2))
    scal = cf.scalar_block("heat9", torch.tensor([0.1, 0.1]),
                           torch.tensor([0.1, 0.2]))
    cf.fam_resident(u, 3, scal, "heat9")
    cf.fam_tiled_chunk(u, 11, scal, "heat9")
    assert set(cf.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", [
    dict(problem="heat5"),
    dict(problem="varcoef"),
    dict(u=torch.zeros(2, 4, 8)),             # heat9 needs 5x5
    dict(u=torch.zeros(2, 8, 8, dtype=torch.float64)),
    dict(scal=torch.zeros(2, 3)),
    dict(nsub=9),
    dict(nsub=0),
])
def test_wrappers_reject_bad_inputs(bad):
    kw = dict(u=torch.zeros(2, 8, 8), scal=torch.zeros(2, 2), nsub=2,
              problem="heat9")
    kw.update(bad)
    with pytest.raises(ValueError):
        cf.fam_tile_multi(kw["u"], kw["nsub"], kw["scal"], kw["problem"])


def test_tile_plan_rings_scale_with_the_halo_width():
    """H9 plans with a W*T ring: heat9's tiles carry a 16-deep ring and
    still fit the H100's shared memory."""
    p9 = cf.tile_plan(4096, 4096, "heat9", "cpu")
    p1 = cf.tile_plan(4096, 4096, "advdiff", "cpu")
    assert (p9.tsteps, p1.tsteps) == (16, 8)
    assert p9.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("fam", KERNEL_FAMILIES)
@pytest.mark.parametrize("tsteps", [1, 3, 4, 6, 8])
def test_family_plan_fits_the_card(fam, tsteps):
    """H9's plan for sweeps of T steps: a ring of W * T (at least what T
    steps consume), two ext tiles within one block's 232,448 bytes, and
    the blocks per SM it states within the SM's 228 KB (1 KB reserved a
    block) and 2048 threads. The paths' depth keeps two blocks an SM."""
    w = get_family(fam).spec.halo_width
    plan = cf.tile_plan(4096, 4096, fam, "cpu", tsteps)
    assert plan.tsteps == w * tsteps
    assert plan.smem_bytes == 2 * (plan.ty + 2 * plan.tsteps) * (
        plan.tx + 2 * plan.tsteps) * 4 <= 232448
    k = cf.blocks_per_sm(plan)
    assert k >= 1 and k * (plan.smem_bytes + 1024) <= 228 * 1024
    assert k * 32 * cf.FAM_WARPS <= 2048
    if tsteps == cf.SWEEP_TSTEPS[fam]:
        assert k >= 2


@pytest.mark.parametrize("fam", KERNEL_FAMILIES)
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 19])
def test_fam_tiled_chunk_sweeps_at_the_plan_depth(fam, n, rng, monkeypatch):
    """``fam_tiled_chunk`` splits n steps into sweeps of the family's
    depth and one partial sweep (``sweep_schedule``), each within the
    wrapper's range, and still equals n plain steps."""
    t = cf.SWEEP_TSTEPS[fam]
    want = [t] * (n // t) + ([n % t] if n % t else [])
    assert cf.sweep_schedule(n, fam) == want
    depths = []
    real = cf.fam_tile_multi

    def spy(u, nsub, scal, problem):
        depths.append(nsub)
        return real(u, nsub, scal, problem)
    monkeypatch.setattr(cf, "fam_tile_multi", spy)
    u = torch.from_numpy(np.stack([_state(rng, (14, 18)) for _ in range(2)]))
    cxs, cys = _coefs(rng, fam, 2)
    scal = cf.scalar_block(fam, torch.from_numpy(cxs), torch.from_numpy(cys))
    got = cf.fam_tiled_chunk(u, n, scal, fam)
    assert depths == want and all(1 <= d <= 8 for d in depths)
    assert torch.equal(got, cf.fam_multi_step_plain(u, n, scal, fam))


# ------------------------------------------------------------------ #
# Routes, config, stability and admission: JAX's rules and texts
# ------------------------------------------------------------------ #

def test_pick_route():
    assert trun.pick_route("heat9", "auto", 640, 1024, "cpu") == "pallas"
    assert trun.pick_route("advdiff", "auto", 4096, 4096, "cpu") == "band"
    assert trun.pick_route("varcoef", "auto", 16, 16, "cpu") == "jnp"
    assert trun.pick_route("reactdiff", "band", 16, 16, "cpu") == "band"
    assert trun.pick_route("heat5", "adi", 16, 16, "cpu") == "adi"
    assert trun.pick_route("heat5", "auto", 640, 1024, "cpu") == \
        tens._pick_method("auto", 640, 1024, "cpu")


@pytest.mark.parametrize("problem,method", [
    ("varcoef", "band"), ("varcoef", "pallas"), ("reactdiff", "adi"),
    ("heat9", "mg"), ("advdiff", "adi"), ("varcoef", "mg")])
def test_pick_route_errors_equal_jax(problem, method):
    with pytest.raises(jcfg.ConfigError) as je:
        jrun.pick_route(problem, method, 16, 16)
    with pytest.raises(tcfg.ConfigError) as te:
        trun.pick_route(problem, method, 16, 16, "cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(problem="heat9", method="adi"),
    dict(problem="reactdiff", method="mg"),
    dict(problem="heat9", nxprob=4, nyprob=10),
    dict(problem="heat9", cx=0.2, cy=0.2),
    dict(problem="advdiff", cx=0.001),
    dict(problem="reactdiff", cx=0.3, cy=0.3),
    dict(problem="varcoef", mode="pallas"),
    dict(problem="varcoef", cx=-0.1),
])
def test_family_config_errors_equal_jax(kw):
    with pytest.raises(jcfg.ConfigError) as je:
        jcfg.HeatConfig(**kw)
    with pytest.raises(tcfg.ConfigError) as te:
        tcfg.HeatConfig(**kw)
    assert _norm(str(te.value)) == _norm(str(je.value))


@pytest.mark.parametrize("kw", [
    dict(problem="heat9", cx=0.2, cy=0.1, steps=5),
    dict(problem="advdiff", cx=0.05, cy=0.05),
    dict(problem="reactdiff", nxprob=3, nyprob=3),
    dict(problem="heat5", method="mg", cx=40.0, cy=20.0),
])
def test_family_configs_accepted_like_jax(kw):
    assert tcfg.HeatConfig(**kw).to_dict() == jcfg.HeatConfig(**kw).to_dict()


@pytest.mark.parametrize("problem,cx,cy", [
    ("heat9", 0.2, 0.2), ("heat9", -0.1, 0.1), ("advdiff", 0.004, 0.1),
    ("advdiff", 0.1, 0.004), ("reactdiff", 0.3, 0.3), ("varcoef", 0.3, 0.3),
    ("heat5", 0.4, 0.2), ("wave", 0.1, 0.1)])
def test_stability_errors_equal_jax(problem, cx, cy):
    with pytest.raises(jcfg.ConfigError) as je:
        jstab.check_problem_stability(problem, cx, cy)
    with pytest.raises(tcfg.ConfigError) as te:
        tstab.check_problem_stability(problem, cx, cy)
    assert _norm(str(te.value)) == _norm(str(je.value))


def test_stability_constants_equal_jax():
    assert tstab.HEAT9_COEFF_LIMIT == jstab.HEAT9_COEFF_LIMIT
    assert tstab.EXPLICIT_COEFF_LIMIT == jstab.EXPLICIT_COEFF_LIMIT
    for m in ("explicit", "adi", "mg", "jnp"):
        assert tstab.is_implicit(m) == jstab.is_implicit(m)
    for fam, cx, cy in [("heat9", 0.18, 0.19), ("advdiff", 0.006, 0.2),
                        ("reactdiff", 0.25, 0.25)]:
        tstab.check_problem_stability(fam, cx, cy)
        jstab.check_problem_stability(fam, cx, cy)


@pytest.mark.parametrize("fields", [
    dict(problem="reactdiff", method="adi"),
    dict(problem="heat9", method="mg"),
    dict(problem="varcoef", method="band"),
    dict(problem="varcoef", method="pallas"),
    dict(problem="advdiff", method="adi"),
    dict(problem="heat9", nx=4, ny=16),
])
def test_admission_rejections_equal_jax(fields):
    from heat2d_tpu.serve.schema import Rejected as JRejected
    fields = dict(dict(nx=16, ny=16, steps=5), **fields)
    with pytest.raises(JRejected) as je:
        JRequest(**fields).validate()
    with pytest.raises(Rejected) as te:
        SolveRequest(**fields).validate()
    assert te.value.code == je.value.code
    assert te.value.message == je.value.message
    assert te.value.to_record() == je.value.to_record()


# ------------------------------------------------------------------ #
# Ensembles of every family against JAX's run_ensemble
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("fam,method", [
    (f, m) for f in KERNEL_FAMILIES for m in ("jnp", "pallas", "band",
                                               "auto")]
    + [("varcoef", "jnp"), ("varcoef", "auto")])
def test_run_ensemble_families_match_jax(fam, method, rng):
    b, shape = 3, (20, 28)
    u = np.stack([_state(rng, shape) for _ in range(b)])
    cxs, cys = _coefs(rng, fam, b)
    want = jens.run_ensemble(*shape, 9, cxs, cys, u0=u, method=method,
                             problem=fam)
    got = tens.run_ensemble(*shape, 9, cxs, cys, u0=u, method=method,
                            problem=fam, device="cpu")
    _close(got, want, 9, fam)


def test_varcoef_kernel_routes_refused():
    for method in ("pallas", "band"):
        with pytest.raises(tcfg.ConfigError, match="no '.*' kernel"):
            tens.run_ensemble(12, 12, 1, [0.1], [0.1], method=method,
                              problem="varcoef", device="cpu")


@pytest.mark.parametrize("method", ["jnp", "pallas", "band"])
@pytest.mark.parametrize("fam", KERNEL_FAMILIES)
def test_family_convergence_matches_jax(fam, method):
    """The pair-tracked loop over the family's runner. The members start
    from the reference initial condition scaled by 0.05 and by 1, so
    their chunk-1 residuals lie ~400x apart; a sensitivity between them
    makes the members exit at different chunks in both stacks."""
    from heat2d_tpu_torch.ops.init import inidat
    shape, steps, interval = (16, 20), 60, 10
    cxs, cys = [0.08, 0.12], [0.1, 0.05]
    u0 = np.stack([s * inidat(*shape, device="cpu").numpy()
                   for s in (0.05, 1.0)])
    first = tens.run_ensemble(*shape, interval, cxs, cys, u0=u0,
                              method="jnp", problem=fam, device="cpu")
    prev = tens.run_ensemble(*shape, interval - 1, cxs, cys, u0=u0,
                             method="jnp", problem=fam, device="cpu")
    res = [float(r) for r in torch.sum((first - prev) ** 2, dim=(1, 2))]
    assert res[1] > 16 * res[0], res
    sens = (res[0] * res[1]) ** 0.5
    want, kw = jens.run_ensemble_convergence(
        *shape, steps, interval, sens, cxs, cys, u0=u0, method=method,
        problem=fam)
    got, kg = tens.run_ensemble_convergence(
        *shape, steps, interval, sens, cxs, cys, u0=u0, method=method,
        problem=fam, device="cpu")
    kw = [int(k) for k in kw]
    assert kg.tolist() == kw and len(set(kw)) == 2, kw
    for m, k in enumerate(kw):
        _close(got[m], np.asarray(want)[m], k, fam)


def test_timed_ensemble_family_and_route():
    r = tens.timed_ensemble(16, 20, 12, [0.05, 0.1], [0.1, 0.1],
                            problem="heat9", device="cpu")
    assert r.method == "pallas" and r.steps_done is None
    jb, _, _ = jens.timed_ensemble(16, 20, 12, [0.05, 0.1], [0.1, 0.1],
                                   problem="heat9")
    _close(r.batch, jb, 12, "heat9")
    a = tens.batch_runner(16, 20, 12, "band", problem="advdiff",
                          device="cpu")
    assert a.method == "band"
    assert tens.batch_runner(16, 20, 12, "band", problem="advdiff",
                             device="cpu") is a
