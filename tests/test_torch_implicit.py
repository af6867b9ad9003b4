"""The port's implicit methods (``ops/tridiag.py`` with the plain versions
of H10/H11, ``ops/multigrid.py``, ``ops/analytic.py``,
``models/solution.py``, and the adi/mg routes of the solver, the
ensembles and the server) against ``heat2d_tpu`` on the CPU, on the same
inputs made with numpy from a seed.

Tolerances: float64 solves within 1e-12 (the same operations, in another
order only where stated); float32 ADI results within ``steps * (1 + cx +
cy) * 2**-22 * max|u|`` (an ADI half step forms intermediates ~c times
the state, so its roundoff is ~c eps per step, and XLA's CPU backend may
contract multiply-adds); the H10/H11 plain versions against the JAX TD
kernel in interpret mode (the same arithmetic) within ``(1 + c) * 2**-22
* max|u|``, and ADI through them against the JAX scan route at
``atol=5e-6``, as the JAX package's own test holds its kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu.config import HeatConfig as JConfig
from heat2d_tpu.models import ensemble as jens
from heat2d_tpu.models import solution as jsol
from heat2d_tpu.models.solver import Heat2DSolver as JSolver
from heat2d_tpu.ops import analytic as jan
from heat2d_tpu.ops import multigrid as jmg
from heat2d_tpu.ops import tridiag as jtd
from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.models import ensemble as tens
from heat2d_tpu_torch.models import solution as tsol
from heat2d_tpu_torch.models.solver import Heat2DSolver
from heat2d_tpu_torch.obs.metrics import get_registry
from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops import analytic as tan
from heat2d_tpu_torch.ops import multigrid as tmg
from heat2d_tpu_torch.ops import tridiag as ttd
from heat2d_tpu_torch.serve.engine import EnsembleEngine
from heat2d_tpu_torch.serve.schema import SolveRequest
from heat2d_tpu_torch.serve.server import Client, SolveServer
from tests._td_split import emulate_split, split_plan
from tests._torch_recording import record_launches


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adi_close(got, want, steps, cx, cy, scale=None):
    """``scale``: the largest |u| the run went through (default: of
    ``want``). ADI contracts, so roundoff made while the state was large
    only decays: a run that decays far is held against its start."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    tol = max(1, steps) * (1 + cx + cy) * 2.0 ** -22 * scale
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


def random_bands(rng, n, *batch):
    dl = np.zeros((n,) + batch)
    du = np.zeros((n,) + batch)
    d = np.ones((n,) + batch)
    dl[1:-1] = rng.normal(size=(n - 2,) + batch) * 0.3
    du[1:-1] = rng.normal(size=(n - 2,) + batch) * 0.3
    d[1:-1] = 3.0 + rng.normal(size=(n - 2,) + batch) * 0.2
    return dl, d, du


def dense(dl, d, du):
    return (np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1))


# ------------------------------------------------------------------ #
# thomas_solve, forward and backward
# ------------------------------------------------------------------ #

def test_thomas_matches_dense_and_jax(rng):
    n = 23
    dl, d, du = random_bands(rng, n)
    rhs = rng.normal(size=(n, 7))
    got = ttd.thomas_solve(*(torch.from_numpy(a) for a in (dl, d, du, rhs)))
    np.testing.assert_allclose(got.numpy(),
                               np.linalg.solve(dense(dl, d, du), rhs),
                               atol=1e-12)
    want = jtd.thomas_solve(*(jnp.asarray(a) for a in (dl, d, du, rhs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-14)


def test_thomas_backward_matches_jax_vjp(rng):
    """The transpose-solve backward against ``jax.grad`` through JAX's
    ``custom_vjp`` (float64; within 1e-10 relative)."""
    n = 11
    dl, d, du = random_bands(rng, n)
    rhs = rng.normal(size=(n, 3))

    def jloss(*a):
        return jnp.sum(jnp.sin(jtd.thomas_solve(*a)))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (dl, d, du, rhs)))
    args = [torch.tensor(a, requires_grad=True) for a in (dl, d, du, rhs)]
    torch.sin(ttd.thomas_solve(*args)).sum().backward()
    for a, w in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   rtol=1e-10, atol=1e-12)


def test_thomas_batched_bands_backward_is_per_member(rng):
    """(n, B, 1) bands: member b's gradients are those of its own (n,)
    solve."""
    n, b = 9, 3
    dl, d, du = random_bands(rng, n, b, 1)
    rhs = rng.normal(size=(n, b, 4))
    args = [torch.tensor(a, requires_grad=True) for a in (dl, d, du, rhs)]
    torch.sin(ttd.thomas_solve(*args)).sum().backward()
    for m in range(b):
        one = [torch.tensor(a[:, m, 0] if a is not rhs else a[:, m],
                            requires_grad=True) for a in (dl, d, du, rhs)]
        torch.sin(ttd.thomas_solve(*one)).sum().backward()
        for a, o in zip(args, one):
            got = a.grad[:, m, 0] if a.dim() == 3 and a.shape[2] == 1 \
                else a.grad[:, m]
            np.testing.assert_allclose(got.numpy(), o.grad.numpy(),
                                       rtol=1e-12, atol=1e-14)


# ------------------------------------------------------------------ #
# The ADI step
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("cx,cy", [(0.1, 0.2), (5.0, 7.0), (51.2, 51.2)])
@pytest.mark.parametrize("shape", [(16, 24), (33, 17)])
def test_adi_multi_step_matches_jax(shape, cx, cy, rng):
    u = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    want = jtd.adi_multi_step(jnp.asarray(u), 3, cx, cy)
    got = ttd.adi_multi_step(torch.from_numpy(u), 3, cx, cy)
    _adi_close(got, want, 3, cx, cy)


def test_adi_step_exact_mode_factor():
    """The separable mode is an eigenvector of the PR-ADI step: one step
    scales it by the analytic factor to float64 precision."""
    nx, ny = 33, 41
    v = torch.from_numpy(tan.separable_mode(nx, ny, np.float64))
    for cx, cy in ((0.1, 0.2), (5.0, 7.0), (300.0, 100.0)):
        got = ttd.adi_step(v, cx, cy).numpy()
        fac = tan.adi_mode_factor(nx, ny, cx, cy)
        np.testing.assert_allclose(got[1:-1, 1:-1] / v.numpy()[1:-1, 1:-1],
                                   fac, rtol=1e-12)


def test_adi_step_holds_edges_and_constants(rng):
    u = torch.from_numpy(rng.normal(size=(12, 15)))
    got = ttd.adi_step(u, 9.0, 4.0)
    for edge in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        assert torch.equal(got[edge], u[edge])
    c = torch.full((9, 9), 2.5, dtype=torch.float64)
    np.testing.assert_allclose(ttd.adi_step(c, 50.0, 50.0).numpy(), 2.5,
                               rtol=1e-12)


def test_adi_step_gradient_matches_jax(rng):
    """Autograd through the bands and the half-step stencils against
    ``jax.grad`` of JAX's adi_step (float64)."""
    u = rng.normal(size=(10, 13))
    w = rng.normal(size=(10, 13))

    def jloss(v, cx, cy):
        return jnp.sum(jtd.adi_step(v, cx, cy) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(u), 3.0, 2.0)
    ut = torch.tensor(u, requires_grad=True)
    cx = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    cy = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    (ttd.adi_step(ut, cx, cy) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((ut.grad, cx.grad, cy.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-10, atol=1e-12)


def test_batched_adi_scan_matches_jax(rng):
    ub = rng.normal(size=(3, 16, 24)).astype(np.float32)
    cxs = np.asarray([0.5, 2.0, 10.0], np.float32)
    cys = np.asarray([1.0, 3.0, 0.3], np.float32)
    want = jtd.batched_adi_scan(jnp.asarray(ub), cxs, cys, steps=3)
    got = ttd.batched_adi_scan(torch.from_numpy(ub), torch.from_numpy(cxs),
                               torch.from_numpy(cys), steps=3)
    _adi_close(got, want, 3, 10.0, 3.0)


# ------------------------------------------------------------------ #
# H10 / H11 plain versions against the JAX TD kernel (interpret mode)
# ------------------------------------------------------------------ #

CS = np.asarray([51.2, 0.5, 7.0], np.float32)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", [(16, 24), (37, 19)])
def test_td_rows_plain_vs_rows_kernel(shape, b, rng):
    """H10 <- ``_tridiag_rows_kernel``: the same (cp, mi) elimination."""
    rhs = rng.normal(size=(b,) + shape).astype(np.float32)
    c = CS[:b]
    want = jtd._solve_rows(jnp.asarray(c).reshape(b, 1, 1),
                           jnp.asarray(rhs), shape[1])
    got = ttd.td_rows(torch.from_numpy(rhs), torch.from_numpy(c))
    tol = (1 + c.max()) * 2.0 ** -22 * np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= tol


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", [(16, 24), (37, 19)])
def test_td_lanes_plain_vs_lanes_kernel(shape, b, rng):
    """H11 <- ``_tridiag_lanes_kernel``: the same along the lanes."""
    rhs = rng.normal(size=(b,) + shape).astype(np.float32)
    c = CS[:b]
    want = jtd._solve_lanes(jnp.asarray(c).reshape(b, 1, 1),
                            jnp.asarray(rhs), shape[0])
    got = ttd.td_lanes(torch.from_numpy(rhs), torch.from_numpy(c))
    tol = (1 + c.max()) * 2.0 ** -22 * np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= tol


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [2, 3, 33, 70])
@pytest.mark.parametrize("rows", [1, 31, 33])
def test_td_lanes_plain_on_ragged_shapes(rows, n, b, rng):
    """H11's plain version at the shapes its kernel masks (rows not a
    multiple of the 32-row panel, n not a multiple of the 32-column stage
    or below it, identity rows only at n < 3): against the JAX TD route
    (``_tridiag_lanes_kernel`` in interpret mode) within its tolerance,
    and bit for bit with and without the hoisted ``td_coeffs``."""
    rhs = rng.normal(size=(b, rows, n)).astype(np.float32)
    c = CS[:b]
    want = jtd._solve_lanes(jnp.asarray(c).reshape(b, 1, 1),
                            jnp.asarray(rhs), rows)
    t_rhs, t_c = torch.from_numpy(rhs), torch.from_numpy(c)
    got = ttd.td_lanes(t_rhs, t_c)
    tol = (1 + c.max()) * 2.0 ** -22 * np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= tol
    assert torch.equal(ttd.td_lanes(t_rhs, t_c, ttd.td_coeffs(t_c, n)), got)
    if n < 3:
        # identity rows only: the solve returns rhs
        assert torch.equal(got, t_rhs)


@pytest.mark.parametrize("variant", ["xpose", "strided"])
def test_adi_kernel_route_matches_jax_scan(variant, rng):
    """ADI through the H10/H11 plain versions (x half along the rows, y
    half along the lanes, no transpose) against JAX's kernel route TD in
    interpret mode, for both of its y-half strategies, and against JAX's
    scan route, each at the JAX package's own tolerance for its kernel
    (atol 5e-6; about 11 ulp of max|u| apart in practice)."""
    ub = rng.normal(size=(3, 16, 24)).astype(np.float32)
    cxs = np.asarray([0.5, 2.0, 10.0], np.float32)
    cys = np.asarray([1.0, 3.0, 0.3], np.float32)
    got = ttd.batched_adi_kernel(torch.from_numpy(ub), torch.from_numpy(cxs),
                                 torch.from_numpy(cys), steps=3).numpy()
    kern = jtd.batched_adi_kernel(jnp.asarray(ub), cxs, cys, steps=3,
                                  variant=variant)
    np.testing.assert_allclose(got, np.asarray(kern), atol=5e-6)
    want = jtd.batched_adi_scan(jnp.asarray(ub), cxs, cys, steps=3)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-6)


def test_td_coefficients_and_validation(rng):
    c = torch.tensor([51.2, 3.0])
    a, cp, mi = ttd.cn_coeffs(c, 6)
    assert a.shape == cp.shape == mi.shape == (6, 2, 1)
    assert float(cp[0, 0]) == 0.0 and float(mi[0, 0]) == 1.0
    assert float(mi[-1, 0]) == 1.0 and float(a[-1, 0]) == 0.0
    _build.reset_launch_counts()
    ttd.td_rows(torch.zeros(2, 6, 5), c)
    assert _build.launch_counts("tridiag") == {
        "td_coeffs": 0, "td_rows": 0, "td_lanes": 0}
    for bad in (torch.zeros(2, 6, 5, dtype=torch.float64),
                torch.zeros(6, 5)):
        with pytest.raises(ValueError):
            ttd.td_rows(bad, c)
    with pytest.raises(ValueError):
        ttd.td_lanes(torch.zeros(3, 6, 5), c)
    with pytest.raises(ValueError, match="c must be"):
        ttd.adi_sweep_kernel(torch.zeros(2, 6, 5), c[:1], c)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", [(1, 5), (2, 7), (3, 4), (37, 19)])
def test_td_solves_take_hoisted_coefficients_bitwise(shape, b, rng):
    """``td_coeffs`` is ``cn_coeffs``' (cp, mi) in the kernels' (B, 2, n)
    layout, and H10/H11 (plain versions here) with ``coef=`` equal the
    same calls without it, bit for bit, on both axes."""
    rhs = torch.from_numpy(rng.normal(size=(b,) + shape).astype(np.float32))
    c = torch.from_numpy(CS[:b])
    n = shape[0]
    coef = ttd.td_coeffs(c, n)
    _, cp, mi = ttd.cn_coeffs(c, n)
    assert coef.shape == (b, 2, n) and coef.is_contiguous()
    assert torch.equal(coef[:, 0], cp[:, :, 0].T)
    assert torch.equal(coef[:, 1], mi[:, :, 0].T)
    assert torch.equal(ttd.td_rows(rhs, c, coef), ttd.td_rows(rhs, c))
    lanes = rhs.transpose(1, 2).contiguous()
    assert torch.equal(ttd.td_lanes(lanes, c, coef), ttd.td_lanes(lanes, c))


def test_td_coefficient_validation():
    c = torch.tensor([51.2, 3.0])
    rhs = torch.zeros(2, 6, 5)
    for bad in (torch.zeros(2, 2, 5), torch.zeros(1, 2, 6),
                torch.zeros(2, 2, 6, dtype=torch.float64),
                torch.zeros(2, 6, 2).transpose(1, 2)):
        with pytest.raises(ValueError, match="coef must be"):
            ttd.td_rows(rhs, c, bad)
    with pytest.raises(ValueError, match="td_coeffs"):
        ttd.td_coeffs(c.double(), 6)
    with pytest.raises(ValueError, match="td_coeffs"):
        ttd.td_coeffs(c, 0)


class _CountCoeffs:
    """``td_coeffs`` wrapped to count its calls (``n`` per call)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = ttd.td_coeffs

        def counted(c, n):
            self.calls.append(n)
            return real(c, n)
        monkeypatch.setattr(ttd, "td_coeffs", counted)


def test_batched_adi_kernel_computes_each_axis_once(rng, monkeypatch):
    """The run hoists (cp, mi): one ``td_coeffs`` per axis for all steps
    (cx over nx rows, cy over ny columns), and the result still matches
    JAX's scan at the JAX package's kernel tolerance."""
    count = _CountCoeffs(monkeypatch)
    ub = rng.normal(size=(3, 16, 24)).astype(np.float32)
    cxs = np.asarray([0.5, 2.0, 10.0], np.float32)
    cys = np.asarray([1.0, 3.0, 0.3], np.float32)
    got = ttd.batched_adi_kernel(torch.from_numpy(ub), torch.from_numpy(cxs),
                                 torch.from_numpy(cys), steps=4).numpy()
    assert count.calls == [16, 24]
    want = jtd.batched_adi_scan(jnp.asarray(ub), cxs, cys, steps=4)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-6)
    count.calls.clear()
    coefs = ttd.adi_coeffs(torch.from_numpy(ub), torch.from_numpy(cxs),
                           torch.from_numpy(cys))
    again = ttd.batched_adi_kernel(torch.from_numpy(ub),
                                   torch.from_numpy(cxs),
                                   torch.from_numpy(cys), steps=4,
                                   coefs=coefs).numpy()
    assert count.calls == [16, 24]          # adi_coeffs' two, none more
    assert np.array_equal(again, got)


def test_solver_adi_kernel_route_hoists_coefficients(monkeypatch):
    """Mode pallas with adi: a convergence run (a multi-step per chunk and
    a tracked step per check) computes each axis's (cp, mi) once, and
    ends where mode serial (the plain scan) does."""
    count = _CountCoeffs(monkeypatch)
    cfg = HeatConfig(nxprob=12, nyprob=20, steps=30, cx=6.0, cy=4.0,
                     method="adi", mode="pallas", convergence=True,
                     interval=10, sensitivity=1e-30)
    got = Heat2DSolver(cfg, device="cpu").run(timed=False)
    assert count.calls == [12, 20]
    want = Heat2DSolver(cfg.replace(mode="serial"),
                        device="cpu").run(timed=False)
    assert got.steps_done == want.steps_done == 30
    from heat2d_tpu_torch.ops.init import inidat
    _adi_close(got.u, want.u, 30, 6.0, 4.0,
               scale=float(inidat(12, 20).abs().max()))


@pytest.mark.parametrize("nb, n, m, warps, coef_smem, blocks", [
    (1, 4096, 4096, 1, True, 256),   # the ADI path: 2 segments a system
    (4, 4096, 4096, 4, True, 128),   # leg (f): 4 warps a block
    (3, 4099, 4097, 3, True, 129),
    (1, 37, 1, 1, True, 1),
    (1, 30000, 36, 1, False, 126),   # 8n too large: cached reads; split
])
def test_plan_td_rows(nb, n, m, warps, coef_smem, blocks):
    """H10's launch on the H100's 132 SMs and 232,448 bytes: panels of 32
    columns, up to 4 a block so that every panel runs in one wave, (cp,
    mi) in shared memory where their 8n bytes (rounded up to 16) fit
    beside the rings; a batch of fewer panels than SMs split into
    segments of rows, a block each."""
    plan = ttd.plan_td_rows(nb, n, m)
    assert (plan.warps, plan.coef_smem, plan.blocks) == (
        warps, coef_smem, blocks)
    assert plan.smem_bytes <= 232448
    assert plan.smem_bytes == (-(-8 * n // 16) * 16 if coef_smem else 0) \
        + warps * ttd.TD_RING_BYTES


@pytest.mark.parametrize("nb, rows, n, warps, coef_smem, blocks", [
    (1, 4096, 4096, 1, True, 128),   # the ADI path's y half: one wave
    (4, 4096, 4096, 4, True, 128),   # leg (f): 4 warps a block
    (3, 4097, 4099, 3, True, 129),
    (1, 1, 37, 1, True, 1),
    (3, 33, 70, 1, True, 6),
    (1, 40, 30000, 1, False, 2),     # 8n too large: cached reads
])
def test_plan_td_lanes(nb, rows, n, warps, coef_smem, blocks):
    """H11's launch on the H100's 132 SMs and 232,448 bytes: panels of 32
    rows, up to 4 a block so that every panel of the nb members runs in
    one wave, (cp, mi) in shared memory where their 8n bytes fit beside
    the rings of 32 x 33-float slots."""
    plan = ttd.plan_td_lanes(nb, rows, n)
    assert (plan.warps, plan.coef_smem, plan.blocks) == (
        warps, coef_smem, blocks)
    assert plan.smem_bytes <= 232448
    assert plan.smem_bytes == (-(-8 * n // 16) * 16 if coef_smem else 0) \
        + warps * ttd.TD_LANES_RING_BYTES
    assert ttd.TD_LANES_RING_BYTES == 8 * 32 * 33 * 4
    if rows == 4096:
        assert plan.blocks <= 132 and plan.blocks * plan.warps == nb * 128


# ------------------------------------------------------------------ #
# One launch an ADI half: H10's and H11's right-hand-side builds
# ------------------------------------------------------------------ #

def _half_x(u, cxs, cys, kx):
    """The x half as the step loop composed it before the builds: the
    right-hand side, H10's plain solve, the held edges."""
    return ttd._hold_edges(ttd.td_rows_plain(
        ttd._rhs_half(u, cys.reshape(-1, 1, 1), 1), cxs, kx), u)


def _half_y(ustar, cxs, cys, ky, u):
    return ttd._hold_edges(ttd.td_lanes_plain(
        ttd._rhs_half(ustar, cxs.reshape(-1, 1, 1), 0), cys, ky), u)


def _halves():
    reg = get_registry()
    return [sum(reg.find_counters(k).values())
            for k in ("adi_halves_total", "adi_halves_fused_total")]


@pytest.mark.parametrize("c", [0.3, 25.0, 51.2])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", [(1, 5), (2, 7), (3, 3), (31, 33),
                                   (70, 37)])
def test_adi_half_builds_equal_the_composition(shape, b, c, rng):
    """The builds' plain versions (what ``td_rows_rhs``/``td_lanes_rhs``
    run on the CPU) equal ``_hold_edges(solve(_rhs_half(u)), u)`` bit for
    bit, with and without the hoisted coefficients; u's four edges pass
    through both halves; nothing counts as a launch."""
    u = torch.from_numpy((rng.normal(size=(b,) + shape) * 500)
                         .astype(np.float32))
    cxs = torch.tensor([c, c / 2, c * 2][:b])
    cys = torch.tensor([c * 2, c, c / 2][:b])
    kx, ky = ttd.adi_coeffs(u, cxs, cys)
    _build.reset_launch_counts()
    ustar = ttd.td_rows_rhs(u, cxs, cys, kx)
    assert torch.equal(ustar, _half_x(u, cxs, cys, kx))
    assert torch.equal(ttd.td_rows_rhs_plain(u, cxs, cys, kx), ustar)
    assert torch.equal(ttd.td_rows_rhs(u, cxs, cys), ustar)
    y = ttd.td_lanes_rhs(ustar, cys, cxs, ky)
    assert torch.equal(y, _half_y(ustar, cxs, cys, ky, u))
    assert torch.equal(ttd.td_lanes_rhs_plain(ustar, cys, cxs, ky), y)
    assert torch.equal(ttd.td_lanes_rhs(ustar, cys, cxs), y)
    for v in (ustar, y):
        assert torch.equal(v[:, [0, -1]], u[:, [0, -1]])
        assert torch.equal(v[:, :, [0, -1]], u[:, :, [0, -1]])
    assert _build.launch_counts("tridiag") == {
        "td_coeffs": 0, "td_rows": 0, "td_lanes": 0}


def test_batched_adi_kernel_is_the_composed_loop_and_counts_halves(rng):
    """Four steps of ``batched_adi_kernel`` equal a step loop of the
    composition, bit for bit; the registry counts 2 x 4 halves in one
    call, none of them one launch on the CPU; ``adi_sweep_kernel`` counts
    its step's 2."""
    ub = torch.from_numpy((rng.normal(size=(3, 31, 33)) * 500)
                          .astype(np.float32))
    cxs = torch.tensor([0.3, 25.0, 51.2])
    cys = torch.tensor([51.2, 0.3, 25.0])
    before = _halves()
    got = ttd.batched_adi_kernel(ub, cxs, cys, steps=4)
    assert [a - b for a, b in zip(_halves(), before)] == [8, 0]
    kx, ky = ttd.adi_coeffs(ub, cxs, cys)
    u = ub
    for _ in range(4):
        u = _half_y(_half_x(u, cxs, cys, kx), cxs, cys, ky, u)
    assert torch.equal(got, u)
    before = _halves()
    one = ttd.adi_sweep_kernel(ub, cxs, cys)
    assert [a - b for a, b in zip(_halves(), before)] == [2, 0]
    assert torch.equal(one, _half_y(_half_x(ub, cxs, cys, kx), cxs, cys,
                                    ky, ub))
    before = _halves()
    assert ttd.batched_adi_kernel(ub, cxs, cys, steps=0) is ub
    assert _halves() == before


@pytest.mark.parametrize("rhs", [False, True])
@pytest.mark.parametrize("kernel", ["td_rows", "td_lanes"])
def test_launch_passes_each_build_its_entry_and_plan(kernel, rhs,
                                                     monkeypatch):
    """``_launch`` (the card's side of the wrappers, here against a
    library that records its calls): a right-hand-side build goes to its
    own entry point with the stencil's diffusion numbers after c, on the
    plan of its wider ring, and counts as its solve kernel's launch."""
    calls = record_launches(monkeypatch)
    x = torch.zeros(2, 70, 37)
    c, s = torch.ones(2), torch.full((2,), 2.0)
    coef = ttd.td_coeffs(c, 70 if kernel == "td_rows" else 37)
    _build.reset_launch_counts()
    out = ttd._launch(kernel, x, c, coef, s if rhs else None)
    [(name, args)] = calls
    assert name == f"heat_{kernel}" + ("_rhs" if rhs else "")
    assert len(args) == len(_build.SIGNATURES["tridiag"][name][1])
    ptrs = [x, out, c] + ([s] if rhs else []) + [coef]
    assert list(args[:len(ptrs)]) == [t.data_ptr() for t in ptrs]
    planner = ttd.plan_td_rows if kernel == "td_rows" else ttd.plan_td_lanes
    plan = planner(2, 70, 37, rhs=rhs)
    assert args[len(ptrs):-1] == (2, 70, 37, plan.warps,
                                  int(plan.coef_smem))
    assert _build.launch_counts("tridiag")[kernel] == 1


@pytest.mark.parametrize("steps", [1, 3])
def test_fused_halves_are_counted_at_the_launch(steps, monkeypatch):
    """``adi_halves_fused_total`` counts the right-hand-side builds that
    ``_launch`` ran, not the device: with each half's build sent to a
    recording library, as a card's wrappers send it, a call of
    ``batched_adi_kernel`` counts 2 x steps halves and as many launches,
    one entry point a half in turn; ``adi_sweep_kernel`` counts its 2."""
    calls = record_launches(monkeypatch)
    monkeypatch.setattr(ttd, "td_rows_rhs", lambda u, c, s, coef:
                        ttd._launch("td_rows", u, c, coef, s))
    monkeypatch.setattr(ttd, "td_lanes_rhs", lambda u, c, s, coef:
                        ttd._launch("td_lanes", u, c, coef, s))
    u = torch.zeros(2, 7, 9)
    cxs, cys = torch.tensor([0.3, 25.0]), torch.tensor([51.2, 0.3])
    before = _halves()
    ttd.batched_adi_kernel(u, cxs, cys, steps=steps)
    assert [a - b for a, b in zip(_halves(), before)] == [2 * steps] * 2
    assert [name for name, _ in calls] == [
        "heat_td_rows_rhs", "heat_td_lanes_rhs"] * steps
    before = _halves()
    ttd.adi_sweep_kernel(u, cxs, cys)
    assert [a - b for a, b in zip(_halves(), before)] == [2, 2]


@pytest.mark.parametrize("nb, n1, n2", [(1, 2560, 2048), (4, 4096, 4096),
                                        (3, 70, 37), (1, 30000, 36)])
def test_plan_rhs_builds_count_their_wider_rings(nb, n1, n2):
    """The right-hand-side builds plan H10 and H11 as the solves do, with
    their rings: H10's two halo columns beside each ring row, H11's slots
    of 34 rows; every plan fits the H100's 232,448 bytes."""
    assert ttd.TD_RHS_RING_BYTES == 8 * 32 * 32 * 4 + 2 * 32 * 34 * 4
    assert ttd.TD_LANES_RHS_RING_BYTES == 8 * 34 * 33 * 4
    for planner, ring in ((ttd.plan_td_rows, ttd.TD_RHS_RING_BYTES),
                          (ttd.plan_td_lanes, ttd.TD_LANES_RHS_RING_BYTES)):
        plan = planner(nb, n1, n2, rhs=True)
        solve = planner(nb, n1, n2)
        assert (plan.warps, plan.blocks) == (solve.warps, solve.blocks)
        n = n1 if planner is ttd.plan_td_rows else n2
        coef = -(-8 * n // 16) * 16
        assert plan.coef_smem == (coef + plan.warps * ring <= 232448)
        assert plan.smem_bytes == (coef if plan.coef_smem else 0) \
            + plan.warps * ring <= 232448


# ------------------------------------------------------------------ #
# H10's split: segments of rows, speculative warm-ups, verified joins
# ------------------------------------------------------------------ #

def _live_panels(m: int, rhs: bool) -> int:
    """Panels of 32 columns with a lane the split checks: any column,
    or in the right-hand-side build an inner one."""
    cols = range(1, m - 1) if rhs else range(m)
    return len({j // 32 for j in cols})


@pytest.mark.parametrize("build", ["solve", "rhs"])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("nb, n, m", [(1, 700, 37), (2, 660, 64),
                                      (3, 650, 33)])
def test_split_schedule_is_the_unsplit_sweep(nb, n, m, p, build, rng):
    """The split schedule (``tests/_td_split.emulate_split``, what the
    SPLIT builds of H10 run on the card) equals ``td_rows_plain`` /
    ``td_rows_rhs_plain`` bit for bit, at c in [12.5, 50] on ragged
    panels: at the planner's warm-up on noise and on the solver's smooth
    grid (``inidat``), replaying at most every speculative segment; and
    with the warm-up forced to 0 rows on noise, where every speculative
    segment with a checked lane replays."""
    from heat2d_tpu_torch.ops.init import inidat
    c = torch.tensor([12.5, 50.0, 31.0][:nb])
    s = torch.tensor([50.0, 12.5, 20.0][:nb]) if build == "rhs" else None
    coef = ttd.td_coeffs_plain(c, n)

    def plain(x):
        return (ttd.td_rows_plain(x, c, coef) if s is None
                else ttd.td_rows_rhs_plain(x, c, s, coef))
    joins = 2 * nb * _live_panels(m, s is not None) * (p - 1)
    noise = torch.from_numpy((rng.normal(size=(nb, n, m)) * 500)
                             .astype(np.float32))
    smooth = torch.stack([inidat(n, m)] * nb).contiguous()
    plan = split_plan(nb, n, m, p, rhs=s is not None)
    assert plan.segments == p
    for x in (noise, smooth):
        got, replays = emulate_split(x, c, coef, plan, s)
        assert torch.equal(got, plain(x)) and replays <= joins
    forced = split_plan(nb, n, m, p, warm_bits=0, rhs=s is not None)
    got, replays = emulate_split(noise, c, coef, forced, s)
    assert torch.equal(got, plain(noise)) and replays == joins


@pytest.mark.parametrize("c", [12.5, 25.0, 50.0])
def test_split_joins_hit_on_the_adi_cells_grid(c):
    """At the planner's warm-up, the x half of an ADI step on the solver's
    grid (``inidat``, here 1280 x 256, 4 segments of 320 rows) joins
    without a replay at c = 12.5, 25 and 50: the rule's margin past the
    ulp, on the grid the ADI cell solves."""
    from heat2d_tpu_torch.ops.init import inidat
    n, m = 1280, 256
    u = inidat(n, m)[None].contiguous()
    cc, s = torch.tensor([c]), torch.tensor([75.0 - c])
    coef = ttd.td_coeffs_plain(cc, n)
    plan = split_plan(1, n, m, 4, rhs=True)
    got, replays = emulate_split(u, cc, coef, plan, s)
    assert torch.equal(got, ttd.td_rows_rhs_plain(u, cc, s, coef))
    assert replays == 0


@pytest.mark.parametrize("bits, c, rows", [
    (0, 25.0, 0), (ttd.WARM_BITS, 0.3, 32), (ttd.WARM_BITS, 12.5, 96),
    (ttd.WARM_BITS, 25.0, 128), (ttd.WARM_BITS, 50.0, 160),
    (80, 51.2, ttd.WARM_MAX_ROWS)])
def test_split_warm_up_follows_the_members_cp(bits, c, rows):
    """W from the member's fixed-point cp (``warm_rows``, the kernel's
    rule in float32): longer where the recurrence contracts slower, 0
    rows at 0 bits, at most ``WARM_MAX_ROWS``."""
    cp = float(ttd.td_coeffs_plain(torch.tensor([c]), 2560)[0, 0, 2558])
    assert ttd.warm_rows(cp, bits) == rows


@pytest.mark.parametrize("rhs", [False, True])
def test_split_launch_takes_its_entry_joins_and_counts(rhs, monkeypatch):
    """A split plan (here the planner's: 2 segments of 320 rows for a
    600-row member of two panels) goes to the split entry point with the
    stream's join buffer and a new epoch each launch; the registry counts
    2 x panels x (segments - 1) speculative segments a launch, and
    ``collect_split_replays`` reads the buffer's replay word in (0: no
    card ran)."""
    calls = record_launches(monkeypatch)
    monkeypatch.setattr(ttd, "_joins", {})
    monkeypatch.setattr(ttd, "_replays_read", 0)
    x = torch.zeros(1, 600, 37)
    c, s = torch.ones(1), torch.full((1,), 2.0)
    coef = ttd.td_coeffs(c, 600)
    plan = ttd.plan_td_rows(1, 600, 37, rhs=rhs)
    assert (plan.segments, plan.seg_rows, plan.blocks) == (2, 320, 4)
    reg = get_registry()

    def segments():
        return sum(reg.find_counters("td_split_segments_total").values())
    before = segments()
    _build.reset_launch_counts()
    for _ in range(2):
        ttd._launch("td_rows", x, c, coef, s if rhs else None)
    assert segments() - before == 2 * 4
    assert _build.launch_counts("tridiag")["td_rows"] == 2
    name = "heat_td_rows" + ("_rhs" if rhs else "") + "_split"
    assert [n for n, _ in calls] == [name, name]
    [words] = [w for w, _ in ttd._joins.values()]
    assert words.dtype == torch.int64
    assert words.numel() == ttd.SYNC_HEAD + 2 * 132 * ttd.JOIN_WORDS
    for epoch, (_, args) in enumerate(calls, 1):
        ptrs = 6 if rhs else 5
        assert args[ptrs - 1] == words.data_ptr()
        assert args[ptrs:-1] == (1, 600, 37, 320, ttd.WARM_BITS, 1, epoch)
    replays = reg.find_counters("td_split_replays_total")
    ttd.collect_split_replays()
    got = reg.find_counters("td_split_replays_total")
    assert sum(got.values()) == sum(replays.values())
    assert got


# ------------------------------------------------------------------ #
# Multigrid
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("fn", ["cn_apply", "cn_rhs"])
def test_cn_operators_match_jax(fn, rng):
    u = rng.normal(size=(17, 21))
    got = getattr(tmg, fn)(torch.from_numpy(u), 6.0, 9.0)
    want = getattr(jmg, fn)(jnp.asarray(u), 6.0, 9.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13)


def test_mg_transfers_and_smoother_match_jax(rng):
    r = rng.normal(size=(17, 33))
    r[0], r[-1], r[:, 0], r[:, -1] = 0, 0, 0, 0
    np.testing.assert_allclose(tmg.restrict(torch.from_numpy(r)).numpy(),
                               np.asarray(jmg.restrict(jnp.asarray(r))),
                               rtol=1e-13, atol=1e-14)
    e = rng.normal(size=(9, 17))
    np.testing.assert_allclose(
        tmg.prolong(torch.from_numpy(e), (17, 33)).numpy(),
        np.asarray(jmg.prolong(jnp.asarray(e), (17, 33))), rtol=1e-13,
        atol=1e-14)
    u, rhs = rng.normal(size=(2, 17, 21))
    cx, cy = torch.tensor(6.0, dtype=torch.float64), torch.tensor(
        9.0, dtype=torch.float64)
    got = tmg.smooth(torch.from_numpy(u), torch.from_numpy(rhs), cx, cy)
    want = jmg.smooth(jnp.asarray(u), jnp.asarray(rhs), 6.0, 9.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13)
    res = tmg.residual(torch.from_numpy(u), torch.from_numpy(rhs), cx, cy)
    np.testing.assert_allclose(
        res.numpy(), np.asarray(jmg.residual(jnp.asarray(u),
                                             jnp.asarray(rhs), 6.0, 9.0)),
        rtol=1e-13, atol=1e-13)
    assert tmg.can_coarsen(17, 33) and not tmg.can_coarsen(16, 33)


@pytest.mark.parametrize("shape", [(33, 33), (17, 33), (32, 48)])
def test_mg_multi_step_matches_jax(shape, rng):
    """float32, 3 steps at cx = 5, cy = 7 (coarsenable and even sizes):
    within (1 + cx + cy) * 2**-20 * max|u| per step."""
    u = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    want = np.asarray(jmg.mg_multi_step(jnp.asarray(u), 3, 5.0, 7.0))
    got = tmg.mg_multi_step(torch.from_numpy(u), 3, 5.0, 7.0).numpy()
    tol = 3 * 13 * 2.0 ** -20 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


def test_mg_step_matches_unsplit_cn_factor():
    nx = ny = 33
    cx, cy = 6.0, 9.0
    v = torch.from_numpy(tan.separable_mode(nx, ny, np.float64))
    lx, ly = tan.mode_eigenvalues(nx, ny)
    a = cx * lx / 2 + cy * ly / 2
    got = tmg.mg_step(v, cx, cy).numpy()
    np.testing.assert_allclose(got[1:-1, 1:-1] / v.numpy()[1:-1, 1:-1],
                               (1 - a) / (1 + a), rtol=5e-4)


def test_batched_mg_is_per_member(rng):
    u = torch.from_numpy(rng.uniform(size=(2, 17, 17)).astype(np.float32))
    got = tmg.mg_multi_step(u, 2, [8.0, 2.0], [4.0, 1.0])
    for m, (cx, cy) in enumerate([(8.0, 4.0), (2.0, 1.0)]):
        assert torch.equal(got[m], tmg.mg_multi_step(u[m], 2, cx, cy))


# ------------------------------------------------------------------ #
# The analytic oracle and time to solution
# ------------------------------------------------------------------ #

def test_analytic_equals_jax():
    np.testing.assert_array_equal(tan.separable_mode(17, 23),
                                  jan.separable_mode(17, 23))
    assert tan.mode_eigenvalues(65, 33) == jan.mode_eigenvalues(65, 33)
    np.testing.assert_array_equal(
        tan.mode_solution(17, 23, 3.0, 1.5, np.float64),
        jan.mode_solution(17, 23, 3.0, 1.5, np.float64))
    for f in ("explicit_mode_factor", "adi_mode_factor"):
        assert getattr(tan, f)(33, 41, 5.0, 7.0) == \
            getattr(jan, f)(33, 41, 5.0, 7.0)
    a, b = np.arange(12.0), np.arange(12.0) + 0.5
    assert tan.l2_error(a, b) == jan.l2_error(a, b)
    assert tan.l2_error(a, 0 * b) == jan.l2_error(a, 0 * b)


def test_time_to_solution_matches_jax():
    kw = dict(steps_explicit=128, step_ratio=16, cx=0.2, cy=0.2,
              methods=("explicit", "adi", "mg"))
    got = tsol.time_to_solution(33, 33, device="cpu", **kw)
    want = jsol.time_to_solution(33, 33, **kw)
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["method"], g["steps"]) == (w["method"], w["steps"])
        assert g["cx"] == pytest.approx(w["cx"])
        assert g["modeled_s"] == w["modeled_s"]
        assert g["accuracy"] == pytest.approx(w["accuracy"], rel=1e-2,
                                              abs=1e-6)
    for k in ("adi_matched_accuracy", "mg_matched_accuracy",
              "adi_steps_ratio", "adi_modeled_speedup"):
        assert got["summary"][k] == want["summary"][k]
    assert tsol.STEP_UNITS == jsol.STEP_UNITS
    assert tsol.accuracy_floor(np.float32) == jsol.accuracy_floor(
        np.float32)


def test_time_to_solution_explicit_leg_validates_stability():
    from heat2d_tpu_torch.config import ConfigError
    with pytest.raises(ConfigError, match="explicit stability limit"):
        tsol.time_to_solution(17, 17, steps_explicit=8, step_ratio=2,
                              cx=0.3, cy=0.3, device="cpu")


def test_bench_tts_uses_the_kernels_on_the_cpu_plain():
    _build.reset_launch_counts()
    out = tsol.bench_tts(quick=True, device="cpu")
    assert [r["method"] for r in out["rows"]] == ["explicit", "adi"]
    assert out["summary"]["adi_matched_accuracy"]
    assert set(_build.launch_counts("tridiag").values()) == {0}


# ------------------------------------------------------------------ #
# Solver, ensembles and serving
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("mode", ["serial", "pallas"])
@pytest.mark.parametrize("method", ["adi", "mg"])
def test_solver_implicit_vs_jax(method, mode):
    kw = dict(nxprob=33, nyprob=33, steps=4, cx=16.0, cy=16.0,
              method=method, mode=mode)
    got = Heat2DSolver(HeatConfig(**kw), device="cpu").run(timed=False)
    want = JSolver(JConfig(**kw)).run(timed=False)
    assert got.steps_done == want.steps_done == 4
    assert got.route == {"adi": "adi-kernel" if mode == "pallas"
                         else "adi-scan", "mg": "mg"}[method]
    _adi_close(got.u, want.u, 4, 16.0, 16.0)


@pytest.mark.parametrize("mode", ["serial", "pallas"])
def test_solver_implicit_convergence_vs_jax(mode):
    """Early exit on a violent decay: the first check (step 10) in both
    stacks; then a run to the budget with its remainder."""
    for sens, steps in ((1e30, 400), (0.0, 25)):
        kw = dict(nxprob=33, nyprob=33, steps=steps, cx=40.0, cy=40.0,
                  method="adi", mode=mode, convergence=True, interval=10,
                  sensitivity=sens)
        got = Heat2DSolver(HeatConfig(**kw), device="cpu").run(timed=False)
        want = JSolver(JConfig(**kw)).run(timed=False)
        assert got.steps_done == want.steps_done
        assert got.residual_reads == (steps // 10 if sens == 0 else 1)
        # inidat(33, 33) peaks at 16^4
        _adi_close(got.u, want.u, got.steps_done, 40.0, 40.0, 16.0 ** 4)


@pytest.mark.parametrize("method", ["adi", "mg"])
def test_run_ensemble_implicit_vs_jax(method):
    cxs, cys = [4.0, 9.0, 1.5], [2.0, 3.0, 8.0]
    want = jens.run_ensemble(17, 21, 5, cxs, cys, method=method)
    got = tens.run_ensemble(17, 21, 5, cxs, cys, method=method,
                            device="cpu")
    _adi_close(got, want, 5, 9.0, 8.0)


def test_ensemble_adi_is_per_member_solver():
    """Each member of the batched ADI route is the solver's pallas-mode
    ADI run of its own (cx, cy), bit for bit."""
    cxs, cys = [4.0, 9.0], [2.0, 3.0]
    out = tens.run_ensemble(17, 21, 5, cxs, cys, method="adi", device="cpu")
    for m, (cx, cy) in enumerate(zip(cxs, cys)):
        r = Heat2DSolver(HeatConfig(nxprob=17, nyprob=21, steps=5, cx=cx,
                                    cy=cy, method="adi", mode="pallas"),
                         device="cpu").run(timed=False)
        np.testing.assert_array_equal(out[m].numpy(), r.u)


@pytest.mark.parametrize("method,sens", [("adi", 1e-4), ("mg", 1.0)])
def test_ensemble_implicit_convergence_vs_jax(method, sens):
    """The pair-tracked loop drives the implicit runner: the fast member
    freezes while the slow one runs on, in both stacks."""
    args = (17, 17, 50, 5, sens, [8.0, 0.5], [8.0, 0.5])
    want, kw = jens.run_ensemble_convergence(*args, method=method)
    got, kg = tens.run_ensemble_convergence(*args, method=method,
                                            device="cpu")
    kw = [int(k) for k in kw]
    assert kg.tolist() == kw and kw[0] < kw[1], kw
    for m, k in enumerate(kw):
        # inidat(17, 17) peaks at 8^4
        _adi_close(got[m], np.asarray(want)[m], k, 8.0, 8.0, 8.0 ** 4)


def test_served_adi_and_mg_vs_jax():
    reqs = [SolveRequest(nx=20, ny=24, steps=3, cx=cx, cy=cy, method=m)
            for m in ("adi", "mg") for cx, cy in [(8.0, 6.0), (3.0, 2.0)]]
    with SolveServer(device="cpu", max_delay=0.05) as srv:
        client = Client(srv)
        futs = [client.submit(r) for r in reqs]
        got = [f.result(timeout=60) for f in futs]
    assert srv.engine.launches == 2
    assert [row["method"] for row in srv.engine.launch_log] == ["adi", "mg"]
    for i, m in enumerate(("adi", "mg")):
        want = jens.run_ensemble(20, 24, 3, [8.0, 3.0], [6.0, 2.0],
                                 method=m)
        for j in range(2):
            assert got[2 * i + j].steps_done == 3
            _adi_close(got[2 * i + j].u, np.asarray(want)[j], 3, 8.0, 6.0)


def test_serve_engine_adi_bitwise_across_capacities():
    req = SolveRequest(nx=16, ny=24, steps=3, cx=8.0, cy=6.0, method="adi")
    twin = SolveRequest(nx=16, ny=24, steps=3, cx=3.0, cy=2.0, method="adi")
    a = EnsembleEngine(max_batch=8, device="cpu").solve_batch([req])[0]
    b = EnsembleEngine(max_batch=8, device="cpu").solve_batch(
        [req, twin])[0]
    assert np.asarray(a[0]).tobytes() == np.asarray(b[0]).tobytes()
