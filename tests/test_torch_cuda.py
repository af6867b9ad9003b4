"""The CUDA kernels on the card, against their plain PyTorch versions on
the same card. Marked ``cuda``: they skip where no card is present, and
run on the H100 with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Literal form: bitwise. FMA form: within ``n * 2**-21 * max|plain|``
after n steps (the kernel contracts each update into FMAs, the plain
version rounds every operation)."""

import pytest
import torch

from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.models import ensemble
from heat2d_tpu_torch.models.solver import Heat2DSolver
from heat2d_tpu_torch.ops import cuda_ensemble as ce
from heat2d_tpu_torch.ops import cuda_stencil as cs

pytestmark = pytest.mark.cuda

FORMS = [cs.FORM_FMA, cs.FORM_LITERAL]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _close(got, ref, n, form):
    err = float((got.double() - ref.double()).abs().max())
    tol = 0.0 if form == cs.FORM_LITERAL else (
        n * 2.0 ** -21 * float(ref.abs().max()))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(37, 53), (130, 257)])
def test_kernels_match_plain(card, shape, form):
    g = torch.Generator(device=card)
    g.manual_seed(7)
    u = torch.rand(shape, generator=g, device=card)
    cs.reset_launch_counts()
    _close(cs.step(u, 0.1, 0.1, form), cs.step_plain(u, 0.1, 0.1, form),
           1, form)
    for t, nsub in [(1, 1), (3, 2), (8, 8), (8, 5)]:
        _close(cs.tile_multi(u, nsub, 0.1, 0.1, form, t),
               cs.multi_step_plain(u, nsub, 0.1, 0.1, form), nsub, form)
        got, r = cs.tile_multi_resid(u, nsub, 0.1, 0.1, form, t)
        ref, r_ref = cs.tile_multi_resid_plain(u, nsub, 0.1, 0.1, form)
        _close(got, ref, nsub, form)
        assert float(r) == pytest.approx(float(r_ref), rel=1e-4)
    for n in (1, 2, 9):
        _close(cs.resident(u, n, 0.1, 0.1, form),
               cs.multi_step_plain(u, n, 0.1, 0.1, form), n, form)
    assert set(cs.launch_counts().values()) != {0}
    assert min(cs.launch_counts().values()) > 0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(37, 53), (641, 1023), (1900, 1900)])
def test_resident_equals_the_h2_route_bitwise(card, shape, form):
    """H4 (the on-chip resident sweep on one member) against the H2 route:
    the same per-cell arithmetic, so the same bits in both forms, and in
    the literal form the plain step's bits; 1900x1900 is near the on-chip
    budget's edge (K = 1)."""
    g = torch.Generator(device=card)
    g.manual_seed(8)
    u = torch.rand(shape, generator=g, device=card)
    for n in (1, 8, 9, 27):
        cs.reset_launch_counts()
        got = cs.resident(u, n, 0.1, 0.1, form)
        assert cs.launch_counts()["resident"] == 1
        assert cs.launch_counts()["tile_multi"] == 0
        assert torch.equal(got, cs.tiled_chunk(u, n, 0.1, 0.1, form))
        _close(got, cs.multi_step_plain(u, n, 0.1, 0.1, form), n, form)


def test_resident_refuses_a_grid_without_a_plan(card):
    """4096^2 does not stay in the card's shared memory: the gate sends
    it to the streamed route, and the wrapper raises before a launch."""
    u = torch.zeros((4096, 4096), device=card)
    assert cs.resident_plan(4096, 4096, card) is None
    assert not cs.fits_resident((4096, 4096), card)
    cs.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        cs.resident(u, 3, 0.1, 0.1)
    assert cs.launch_counts()["resident"] == 0


def test_resident_gives_up_and_raises(card):
    """H4 on a plan whose one tile row stops short of the grid: the ring
    below it is never published, the blocks give up after ~2 s and the
    wrapper raises; the next launch runs as ever."""
    from heat2d_tpu_torch.ops.resident import ResidentPlan
    u = torch.rand((64, 256), device=card)
    short = ResidentPlan(1, 64, 256, 1, 4, 32, 128, 1, 2, 1)
    with pytest.raises(RuntimeError, match="gave up"):
        cs._resident_launch(u, 9, 0.1, 0.1, cs.FORM_FMA, short)
    assert torch.equal(cs.resident(u, 9, 0.1, 0.1),
                       cs.tiled_chunk(u, 9, 0.1, 0.1))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(37, 53), (300, 520), (640, 1024)])
def test_tile_sweep_paths(card, shape, form):
    """H2/H3 on grids with edge tiles only (37x53) and with both paths:
    the kernels count their tiles by path as the planner does
    (``tile_paths``), and H3's grid is H2's."""
    g = torch.Generator(device=card)
    g.manual_seed(shape[0])
    u = torch.rand(shape, generator=g, device=card)
    counted = cs.path_counter(card)
    got = cs.tile_multi(u, 8, 0.1, 0.1, form, paths=counted)
    _close(got, cs.multi_step_plain(u, 8, 0.1, 0.1, form), 8, form)
    got_r, r = cs.tile_multi_resid(u, 8, 0.1, 0.1, form, paths=counted)
    assert torch.equal(got_r, got)
    _, r_ref = cs.tile_multi_resid_plain(u, 8, 0.1, 0.1, form)
    assert float(r) == pytest.approx(float(r_ref), rel=1e-4)
    planned = cs.tile_paths(cs.tile_plan(*shape, 8, card), *shape)
    assert dict(zip(cs.TILE_PATHS, counted.tolist())) == {
        k: 2 * v for k, v in planned.items()}
    assert (planned["fast"] > 0) == (shape != (37, 53))


@pytest.mark.parametrize("streamed", [False, True])
def test_pallas_solver_on_the_card(card, monkeypatch, streamed):
    if streamed:
        monkeypatch.setattr(cs, "fits_resident", lambda shape, dev: False)
    cfg = HeatConfig(nxprob=96, nyprob=160, steps=57, mode="pallas",
                     convergence=True, interval=7, sensitivity=1e3,
                     bitwise_parity=True)
    got = Heat2DSolver(cfg).run(timed=False)
    want = Heat2DSolver(cfg.replace(mode="serial")).run(timed=False)
    assert got.steps_done == want.steps_done
    assert (got.u == want.u).all()


def _batch(card, b, shape, seed=11):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    u = torch.rand((b,) + shape, generator=g, device=card)
    cxs = torch.rand(b, generator=g, device=card) * 0.24 + 0.01
    cys = torch.rand(b, generator=g, device=card) * 0.24 + 0.01
    return u, cxs, cys


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("shape", [(37, 53), (130, 257)])
def test_ens_resident_matches_plain(card, shape, b):
    u, cxs, cys = _batch(card, b, shape)
    ce.reset_launch_counts()
    for n in (1, 2, 9):
        _close(ce.ens_resident(u, n, cxs, cys),
               ce.ens_multi_step_plain(u, n, cxs, cys), n, cs.FORM_FMA)
    assert ce.launch_counts()["ens_resident"] == 3


@pytest.mark.parametrize("b", [1, 3, 40])
@pytest.mark.parametrize("shape", [(37, 53), (641, 1023)])
def test_ens_resident_equals_the_tile_sweeps_bitwise(card, shape, b):
    """H5's on-chip sweep (one tile or many, one wave or ten, steps below,
    at and past a chunk) against the H6 route: the same per-cell
    arithmetic, so the same bits."""
    u, cxs, cys = _batch(card, b, shape)
    for n in (1, 8, 9, 27):
        ce.reset_launch_counts()
        got = ce.ens_resident(u, n, cxs, cys)
        assert ce.launch_counts() == {"ens_resident": 1, "ens_tile_multi": 0,
                                      "ens_tile_multi_conv": 0}
        assert torch.equal(got, ce.ens_tiled_chunk(u, n, cxs, cys))


def test_oversize_members_take_the_tile_sweeps(card):
    """A member beyond the on-chip budget (``plan_resident`` gives no
    plan) is advanced by H6 / H9 sweeps and counted there."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops.resident import plan_resident
    u, cxs, cys = _batch(card, 2, (2100, 2050))
    assert plan_resident(2, 2100, 2050, 1, card) is None
    ce.reset_launch_counts()
    got = ce.ens_resident(u, 11, cxs, cys)
    assert ce.launch_counts() == {"ens_resident": 0, "ens_tile_multi": 2,
                                  "ens_tile_multi_conv": 0}
    _close(got, ce.ens_multi_step_plain(u, 11, cxs, cys), 11, cs.FORM_FMA)
    scal = cf.scalar_block("heat9", cxs * 0.6, cys * 0.6)
    cf.reset_launch_counts()
    got = cf.fam_resident(u, 11, scal, "heat9")
    assert cf.launch_counts() == {
        "fam_resident": 0,
        "fam_tile_multi": len(cf.sweep_schedule(11, "heat9"))}
    assert torch.equal(got, cf.fam_tiled_chunk(u, 11, scal, "heat9"))


def test_resident_sweep_gives_up_and_raises(card):
    """A plan whose one tile row stops short of the member: the ring below
    it is never published, so its blocks wait ~2 s, set the error word and
    the wrapper raises; the next launch runs as ever."""
    from heat2d_tpu_torch.ops.resident import ResidentPlan
    u, cxs, cys = _batch(card, 1, (64, 256))
    short = ResidentPlan(1, 64, 256, 1, 4, 32, 128, 1, 2, 1)
    with pytest.raises(RuntimeError, match="gave up"):
        ce._resident_launch(u, 9, cxs, cys, short)
    assert torch.equal(ce.ens_resident(u, 9, cxs, cys),
                       ce.ens_tiled_chunk(u, 9, cxs, cys))


@pytest.mark.parametrize("window", [False, True])
def test_resident_step_loops_agree_bitwise(card, window):
    """Either step loop (``tile_steps``, ``window_steps``) under H5 and
    H8: the same per-cell arithmetic, so the tile route's bits."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops.resident import plan_resident
    u, cxs, cys = _batch(card, 3, (641, 1023))
    plan = plan_resident(3, 641, 1023, 1, card)
    assert torch.equal(ce._resident_launch(u, 27, cxs, cys, plan, window),
                       ce.ens_tiled_chunk(u, 27, cxs, cys))
    for problem in ("heat9", "advdiff", "reactdiff"):
        scal = cf.scalar_block(problem, cxs * 0.6, cys * 0.6)
        plan = plan_resident(3, 641, 1023,
                             2 if problem == "heat9" else 1, card)
        assert torch.equal(
            cf._resident_launch(u, 27, scal, problem, plan, window),
            cf.fam_tiled_chunk(u, 27, scal, problem))


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("shape", [(37, 53), (130, 257)])
def test_ens_tile_multi_matches_plain(card, shape, b):
    u, cxs, cys = _batch(card, b, shape)
    for nsub in (1, 2, 5, 8):
        _close(ce.ens_tile_multi(u, nsub, cxs, cys),
               ce.ens_multi_step_plain(u, nsub, cxs, cys), nsub,
               cs.FORM_FMA)


@pytest.mark.parametrize("b", [1, 3, 8])
def test_ens_tile_multi_conv_matches_plain(card, b):
    u, cxs, cys = _batch(card, b, (130, 257))
    active = torch.tensor([i % 2 for i in range(b)], dtype=torch.int32,
                          device=card)
    frozen = active == 0
    for nsub in (1, 5, 8):
        got, r = ce.ens_tile_multi_conv(u, nsub, cxs, cys, active,
                                        resid=True)
        ref, r_ref = ce.ens_conv_sweep_plain(u, nsub, cxs, cys, active,
                                             True)
        _close(got, ref, nsub, cs.FORM_FMA)
        assert torch.equal(got[frozen], u[frozen])
        assert bool((r[frozen] == 0).all())
        on = ~frozen
        assert torch.allclose(r[on], r_ref[on], rtol=1e-4, atol=0)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", [(37, 53), (300, 520), (641, 1023)])
def test_ens_tile_strip_sweep_paths(card, shape, b):
    """H6/H7 on the strip sweep at ragged shapes with mixed ``active``:
    H6 against plain, H7's active members bitwise H6's (the same sweep),
    frozen members unchanged with a 0 residual; the kernels count their
    tiles by path as the planner does (edge tiles only at 37x53, both
    paths at the others)."""
    u, cxs, cys = _batch(card, b, shape, seed=shape[0])
    active = torch.tensor([(i + 1) % 2 for i in range(b)],
                          dtype=torch.int32, device=card)
    frozen = active == 0
    counted = cs.path_counter(card)
    for nsub in (1, 5, 8):
        h6 = ce.ens_tile_multi(u, nsub, cxs, cys, paths=counted)
        _close(h6, ce.ens_multi_step_plain(u, nsub, cxs, cys), nsub,
               cs.FORM_FMA)
        got, r = ce.ens_tile_multi_conv(u, nsub, cxs, cys, active,
                                        resid=True, paths=counted)
        assert torch.equal(got[~frozen], h6[~frozen])
        assert torch.equal(got[frozen], u[frozen])
        assert bool((r[frozen] == 0).all())
        _, r_ref = ce.ens_conv_sweep_plain(u, nsub, cxs, cys, active, True)
        assert torch.allclose(r[~frozen], r_ref[~frozen], rtol=1e-4, atol=0)
    planned = ce.tile_paths(ce.tile_plan(*shape, card), b, *shape)
    assert dict(zip(cs.TILE_PATHS, counted.tolist())) == {
        k: 6 * v for k, v in planned.items()}
    assert (planned["fast"] > 0) == (shape != (37, 53))


def test_ensemble_convergence_on_the_card(card):
    """The H7 route against the pair-tracked loop over H5 on the card:
    the same steps_done, grids within tolerance."""
    args = (36, 128, 200, 10, 2e8, [0.03125, 0.25], [0.03125, 0.25])
    ce.reset_launch_counts()
    a, ka = ensemble.run_ensemble_convergence(*args, method="band")
    b, kb = ensemble.run_ensemble_convergence(*args, method="pallas")
    assert ka.tolist() == kb.tolist() and len(set(ka.tolist())) == 2
    _close(a, b, 200, cs.FORM_FMA)
    counts = ce.launch_counts()
    assert counts["ens_tile_multi_conv"] > 0 and counts["ens_resident"] > 0


def test_serving_on_the_card(card):
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.serve.schema import SolveRequest
    from heat2d_tpu_torch.serve.server import SolveServer

    reqs = [SolveRequest(nx=64, ny=96, steps=19, cx=0.05 * (i + 1),
                         cy=0.1) for i in range(3)]
    ce.reset_launch_counts()
    with SolveServer(registry=MetricsRegistry(), max_delay=0.2) as srv:
        futs = [srv.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    assert srv.engine.launches == 1
    assert ce.launch_counts()["ens_resident"] == 1
    want = ensemble.run_ensemble(64, 96, 19, [r.cx for r in reqs],
                                 [r.cy for r in reqs], method="jnp")
    for m, r in enumerate(got):
        _close(torch.from_numpy(r.u), want[m].cpu(), 19, cs.FORM_FMA)


# ------------------------------------------------------------------ #
# H8-H11: families and tridiagonal solves
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("problem", ["heat9", "advdiff", "reactdiff"])
def test_family_kernels_match_plain(card, problem, b):
    """H8/H9 against their plain version, within n * factor * 2**-24 *
    max|plain| (``cuda_family.rounding_factor``; 0 is expected: the
    kernels repeat the plain roundings)."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    u, cxs, cys = _batch(card, b, (37, 53))
    scal = cf.scalar_block(problem, cxs * 0.6, cys * 0.6)
    cf.reset_launch_counts()
    for n in (1, 5, 8):
        ref = cf.fam_multi_step_plain(u, n, scal, problem)
        tol = n * cf.rounding_factor(problem) * 2.0 ** -24 * float(
            ref.abs().max())
        for fn in (cf.fam_resident, cf.fam_tile_multi):
            err = float((fn(u, n, scal, problem).double()
                         - ref.double()).abs().max())
            assert err <= tol, (fn.__name__, n, err, tol)
    assert cf.launch_counts() == {"fam_resident": 3, "fam_tile_multi": 3}


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("problem", ["heat9", "advdiff", "reactdiff"])
def test_fam_resident_equals_the_tile_sweeps_bitwise(card, problem, b):
    """H8's on-chip sweep against the H9 route, bit for bit."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    u, cxs, cys = _batch(card, b, (641, 1023))
    scal = cf.scalar_block(problem, cxs * 0.6, cys * 0.6)
    for n in (1, 9, 27):
        cf.reset_launch_counts()
        got = cf.fam_resident(u, n, scal, problem)
        assert cf.launch_counts() == {"fam_resident": 1, "fam_tile_multi": 0}
        assert torch.equal(got, cf.fam_tiled_chunk(u, n, scal, problem))


@pytest.mark.parametrize("shape", [(37, 53), (130, 257)])
def test_tridiag_kernels_match_plain(card, shape):
    """H10/H11 against their plain versions, within (1 + c) * 2**-20 *
    max|plain| (0 expected)."""
    from heat2d_tpu_torch.ops import tridiag as td
    g = torch.Generator(device=card)
    g.manual_seed(12)
    rhs = torch.rand((3,) + shape, generator=g, device=card)
    c = torch.tensor([51.2, 0.3, 7.0], device=card)
    td.reset_launch_counts()
    for fn, plain in ((td.td_rows, td.td_rows_plain),
                      (td.td_lanes, td.td_lanes_plain)):
        ref = plain(rhs, c)
        err = float((fn(rhs, c).double() - ref.double()).abs().max())
        assert err <= 52.2 * 2.0 ** -20 * float(ref.abs().max())
    assert td.launch_counts() == {"td_coeffs": 2, "td_rows": 1,
                                  "td_lanes": 1}


@pytest.mark.parametrize("c", [0.1, 3.2, 51.2])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("m", [1, 31, 33, 1000])
@pytest.mark.parametrize("n", [3, 5, 31, 33, 4097])
def test_td_rows_bitwise_on_ragged_shapes(card, n, m, b, c):
    """H10 (a warp per 32-column panel, rhs staged 32 rows a slot) against
    its plain version, bit for bit: panels cut short by m, systems that
    end inside a stage (n = 31, 33 around the slot's 32 rows), and with
    the hoisted ``td_coeffs``, which equal their plain version."""
    from heat2d_tpu_torch.ops import tridiag as td
    g = torch.Generator(device=card)
    g.manual_seed(n * 7919 + m * 31 + b)
    rhs = torch.rand((b, n, m), generator=g, device=card) * 1e3 - 500
    cc = torch.tensor([c, c / 2, c * 2, 0.3][:b], device=card)
    coef = td.td_coeffs(cc, n)
    assert torch.equal(coef, td.td_coeffs_plain(cc, n))
    ref = td.td_rows_plain(rhs, cc)
    assert torch.equal(td.td_rows(rhs, cc, coef), ref)
    assert torch.equal(td.td_rows(rhs, cc), ref)
    if n * m <= 33 * 1000:
        lanes = rhs.transpose(1, 2).contiguous()
        assert torch.equal(td.td_lanes(lanes, cc, coef),
                           td.td_lanes_plain(lanes, cc))


@pytest.mark.parametrize("c", [0.3, 51.2])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("rows", [1, 31, 33, 100])
@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 70, 4097])
def test_td_lanes_bitwise_on_ragged_shapes(card, n, rows, b, c):
    """H11 (a warp per panel of 32 rows, 32 x 32 tiles transposed in
    shared memory) against its plain version, bit for bit: panels cut
    short by rows, systems shorter than a stage or ending inside one, the
    back sweep's first group cut short, identity rows at n < 3."""
    from heat2d_tpu_torch.ops import tridiag as td
    g = torch.Generator(device=card)
    g.manual_seed(n * 7919 + rows * 31 + b)
    rhs = torch.rand((b, rows, n), generator=g, device=card) * 1e3 - 500
    cc = torch.tensor([c, c / 2, c * 2][:b], device=card)
    coef = td.td_coeffs(cc, n)
    ref = td.td_lanes_plain(rhs, cc, coef)
    assert torch.equal(td.td_lanes(rhs, cc, coef), ref)
    assert torch.equal(td.td_lanes(rhs, cc), ref)


def test_td_lanes_reads_large_systems_through_the_cache(card):
    """H11 on systems too long for (cp, mi) in shared memory: bitwise."""
    from heat2d_tpu_torch.ops import tridiag as td
    rows, n = 40, 30000
    assert not td.plan_td_lanes(1, rows, n).coef_smem
    g = torch.Generator(device=card)
    g.manual_seed(4)
    rhs = torch.rand((1, rows, n), generator=g, device=card)
    c = torch.tensor([51.2], device=card)
    assert torch.equal(td.td_lanes(rhs, c), td.td_lanes_plain(rhs, c))


def test_td_rows_reads_large_systems_through_the_cache(card):
    """Systems too long for (cp, mi) in shared memory (8n bytes beside
    the rings) read them through the read-only cache: still bitwise."""
    from heat2d_tpu_torch.ops import tridiag as td
    n, m = 30000, 40
    assert not td.plan_td_rows(1, n, m).coef_smem
    g = torch.Generator(device=card)
    g.manual_seed(3)
    rhs = torch.rand((1, n, m), generator=g, device=card)
    c = torch.tensor([51.2], device=card)
    assert torch.equal(td.td_rows(rhs, c), td.td_rows_plain(rhs, c))


@pytest.mark.parametrize("shape, b", [((37, 53), 3), ((641, 1023), 2),
                                      ((4099, 4097), 1)])
@pytest.mark.parametrize("problem", ["heat9", "advdiff", "reactdiff"])
def test_fam_tile_multi_bitwise_every_depth(card, problem, shape, b):
    """H9's family sweep against its plain version, bit for bit, for every
    depth 1..8 (the ring W * nsub), on ragged members and on one past the
    on-chip budget; and the path's sweeps (``fam_tiled_chunk``) at the
    plan's depth."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    u, cxs, cys = _batch(card, b, shape)
    scal = cf.scalar_block(problem, cxs * 0.6, cys * 0.6)
    ref = u
    for nsub in range(1, 9):
        ref = cf.fam_multi_step_plain(ref, 1, scal, problem)
        assert torch.equal(cf.fam_tile_multi(u, nsub, scal, problem), ref), \
            nsub
    n = 2 * cf.SWEEP_TSTEPS[problem] + 1
    assert torch.equal(cf.fam_tiled_chunk(u, n, scal, problem),
                       cf.fam_multi_step_plain(u, n, scal, problem))


def test_fam_tile_build_and_occupancy(card):
    """The plan's depth holds the blocks per SM the planner states, with
    no local memory (no spills) in the family sweep."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    for problem in ("heat9", "advdiff", "reactdiff"):
        plan = cf.tile_plan(4096, 4096, problem, card,
                            cf.SWEEP_TSTEPS[problem])
        info = cf.tile_info(problem, plan)
        assert info["local_bytes"] == 0, info
        assert info["blocks_per_sm"] == cf.blocks_per_sm(plan), info


def test_adi_solver_on_the_card(card):
    """Mode pallas (H10/H11) against mode serial (the plain scan) on the card:
    the same steps_done, within steps * (1 + cx + cy) * 2**-22 * max|u|."""
    from heat2d_tpu_torch.ops import tridiag as td
    cfg = HeatConfig(nxprob=96, nyprob=160, steps=40, cx=30.0, cy=20.0,
                     method="adi", mode="pallas", convergence=True,
                     interval=10, sensitivity=1e30)
    td.reset_launch_counts()
    got = Heat2DSolver(cfg).run(timed=False)
    want = Heat2DSolver(cfg.replace(mode="serial")).run(timed=False)
    assert got.steps_done == want.steps_done == 10
    # (cp, mi) of each axis once for the run, then two solves a step
    assert td.launch_counts() == {"td_coeffs": 2, "td_rows": 10,
                                  "td_lanes": 10}
    err = float(abs(got.u.astype("float64") - want.u).max())
    assert err <= 10 * 51 * 2.0 ** -22 * float(abs(want.u).max())


def test_served_family_on_the_card(card):
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.serve.schema import SolveRequest
    from heat2d_tpu_torch.serve.server import SolveServer

    reqs = [SolveRequest(nx=64, ny=96, steps=19, cx=0.05 * (i + 1),
                         cy=0.1, problem="heat9") for i in range(3)]
    cf.reset_launch_counts()
    with SolveServer(registry=MetricsRegistry(), max_delay=0.2) as srv:
        futs = [srv.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    assert srv.engine.launches == 1
    assert cf.launch_counts()["fam_resident"] == 1
    want = ensemble.run_ensemble(64, 96, 19, [r.cx for r in reqs],
                                 [r.cy for r in reqs], method="jnp",
                                 problem="heat9")
    for m, r in enumerate(got):
        ref = want[m].cpu()
        err = float((torch.from_numpy(r.u).double() - ref.double())
                    .abs().max())
        assert err <= 19 * 66 * 2.0 ** -24 * float(ref.abs().max())


# ------------------------------------------------------------------ #
# H12-H14: the shard kernels
# ------------------------------------------------------------------ #

def _shards(card, gx, gy, bm, bn, seed=13):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return [[torch.rand((bm, bn), generator=g, device=card)
             for _ in range(gy)] for _ in range(gx)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1), (2, 3)])
def test_shard_kernels_match_plain(card, mesh, form):
    """Every shard position; T = 8 at nsub 8, 3 and 1 (H12, H13), and
    H14 at depth 3 on the same mesh, against its plain version (the
    overlap schedule) and against H12 bit for bit."""
    from heat2d_tpu_torch.ops import cuda_shard as csh
    from heat2d_tpu_torch.parallel.halo import exchange_halo_strips
    gx, gy = mesh
    bm, bn = 37, 53
    nx, ny = gx * bm - 2, gy * bn - 1          # ragged: pad cells too
    blocks = _shards(card, gx, gy, bm, bn)
    csh.reset_launch_counts()
    strips = exchange_halo_strips(blocks, 8)
    for i in range(gx):
        for j in range(gy):
            u, s = blocks[i][j], strips[i][j]
            args = (i * bm, j * bn, nx, ny, 0.1, 0.1, form)
            s_cpu = [x.cpu() for x in s]
            for nsub in (8, 3, 1):
                ref = csh.shard_tile_multi(u.cpu(), s_cpu, nsub, *args)
                _close(csh.shard_tile_multi(u, s, nsub, *args).cpu(), ref,
                       nsub, form)
                got, r = csh.shard_tile_multi_resid(u, s, nsub, *args)
                ref, r_ref = csh.shard_tile_multi_resid(u.cpu(), s_cpu, nsub,
                                                        *args)
                _close(got.cpu(), ref, nsub, form)
                assert float(r) == pytest.approx(float(r_ref), rel=1e-4)
    fused = csh.shard_fused(blocks, 3, nx, ny, 0.1, 0.1, form)
    cpu = [[b.cpu() for b in row] for row in blocks]
    plain = csh.shard_fused(cpu, 3, nx, ny, 0.1, 0.1, form)
    s3 = exchange_halo_strips(blocks, 3)
    for i in range(gx):
        for j in range(gy):
            _close(fused[i][j].cpu(), plain[i][j], 3, form)
            h12 = csh.shard_tile_multi(blocks[i][j], s3[i][j], 3, i * bm,
                                       j * bn, nx, ny, 0.1, 0.1, form)
            assert torch.equal(fused[i][j], h12)
    counts = csh.launch_counts()
    assert counts["shard_fused"] == 1
    assert counts["shard_tile_multi"] == 3 * gx * gy + gx * gy


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nx, ny, gx, gy", [(1300, 1500, 3, 3),
                                            (543, 300, 4, 1),
                                            (74, 106, 2, 2)])
def test_shard_sweep_fast_and_edge_tiles(card, nx, ny, gx, gy, form):
    """H12/H13 on meshes whose shards take both paths of the strip sweep:
    inner shards have fast tiles; the last shard of 543x300 on 4x1 has a
    tile inside its block that holds a pad row; every tile of 74x106 on
    2x2 is an edge tile. The kernels' own count of their tiles by path
    (``paths``) equals the planner's (``tile_paths``). T = 8 strips at
    nsub 8 and 5, against the plain versions; H14 equal to H12 at depth 8,
    and H13's shard equal to H12's."""
    from heat2d_tpu_torch.ops import cuda_shard as csh
    from heat2d_tpu_torch.parallel.halo import exchange_halo_strips
    bm, bn = -(-nx // gx), -(-ny // gy)
    full = torch.zeros((gx * bm, gy * bn), device=card)
    g = torch.Generator(device=card)
    g.manual_seed(nx + ny)
    full[:nx, :ny] = torch.rand((nx, ny), generator=g, device=card)
    blocks = [[full[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn].contiguous()
               for j in range(gy)] for i in range(gx)]
    strips = exchange_halo_strips(blocks, 8)
    plan = cs.plan_strip_sweep(bm, bn, 8)
    kinds = [csh.tile_paths(plan, i * bm, j * bn, bm, bn, nx, ny)
             for i in range(gx) for j in range(gy)]
    assert any(k["fast"] for k in kinds) == (nx != 74)
    assert any(k["in_block_held"] for k in kinds) == (nx == 543)
    fused = csh.shard_fused(blocks, 8, nx, ny, 0.1, 0.1, form)
    for i in range(gx):
        for j in range(gy):
            u, s = blocks[i][j], strips[i][j]
            for nsub in (8, 5):
                args = (nsub, i * bm, j * bn, nx, ny, 0.1, 0.1, form)
                counted = csh.path_counter(card)
                got = csh.shard_tile_multi(u, s, *args, paths=counted)
                _close(got, csh.shard_tile_multi_plain(u, s, *args), nsub,
                       form)
                if nsub == 8:
                    assert torch.equal(fused[i][j], got)
                got_r, r = csh.shard_tile_multi_resid(u, s, *args,
                                                      paths=counted)
                planned = kinds[i * gy + j]
                assert dict(zip(csh.TILE_PATHS, counted.tolist())) == {
                    k: 2 * v for k, v in planned.items()}
                ref_r, r_ref = csh.shard_tile_multi_resid_plain(u, s, *args)
                _close(got_r, ref_r, nsub, form)
                assert torch.equal(got_r, got)
                rel = 1e-5 if form == cs.FORM_LITERAL else 1e-4
                assert float(r) == pytest.approx(float(r_ref), rel=rel)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nx, ny, gx, gy, nsub", [(8, 10, 2, 2, 2),
                                                  (600, 1040, 2, 2, 8),
                                                  (300, 520, 2, 2, 3),
                                                  (1300, 1500, 3, 3, 8)])
def test_shard_fused_equals_h12_bitwise(card, nx, ny, gx, gy, nsub, form):
    """H14 on the strip sweep against H12 from the exchanged strips, bit
    for bit on every shard in both forms: shards as small as the frames
    allow (4x5 at depth 2: the last tile reaches past the neighbour),
    inner shards with fast tiles, pad cells. Its tiles by path equal the
    planner's (``fused_tile_paths``)."""
    from heat2d_tpu_torch.ops import cuda_shard as csh
    from heat2d_tpu_torch.parallel.halo import exchange_halo_strips
    bm, bn = -(-nx // gx), -(-ny // gy)
    full = torch.zeros((gx * bm, gy * bn), device=card)
    g = torch.Generator(device=card)
    g.manual_seed(nx * ny + nsub)
    full[:nx, :ny] = torch.rand((nx, ny), generator=g, device=card)
    blocks = [[full[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn].contiguous()
               for j in range(gy)] for i in range(gx)]
    counted = csh.path_counter(card)
    fused = csh.shard_fused(blocks, nsub, nx, ny, 0.1, 0.1, form,
                            paths=counted)
    strips = exchange_halo_strips(blocks, nsub)
    for i in range(gx):
        for j in range(gy):
            h12 = csh.shard_tile_multi(blocks[i][j], strips[i][j], nsub,
                                       i * bm, j * bn, nx, ny, 0.1, 0.1, form)
            assert torch.equal(fused[i][j], h12), (i, j)
    planned = csh.fused_tile_paths(cs.tile_plan(bm, bn, nsub, card), gx,
                                   gy, bm, bn, nx, ny)
    assert dict(zip(csh.TILE_PATHS, counted.tolist())) == planned
    assert (planned["fast"] > 0) == (nx >= 300)


@pytest.mark.parametrize("mode,halo", [("dist2d", "collective"),
                                       ("dist1d", "collective"),
                                       ("hybrid", "collective"),
                                       ("hybrid", "fused")])
def test_sharded_solver_on_the_card(card, mode, halo):
    """A 2x2 (or 4-strip) mesh on the one card, literal form, convergence
    on: bitwise equal to serial on the card, with equal steps_done."""
    from heat2d_tpu_torch.parallel.mesh import host_devices
    cfg = HeatConfig(nxprob=98, nyprob=162, steps=57, mode=mode, gridx=2,
                     gridy=2, numworkers=4, halo=halo, convergence=True,
                     interval=7, sensitivity=1e3, bitwise_parity=True)
    got = Heat2DSolver(cfg, devices=host_devices(4)).run(timed=False)
    want = Heat2DSolver(cfg.replace(mode="serial")).run(timed=False)
    assert got.steps_done == want.steps_done
    assert (got.u == want.u).all()
    if mode == "hybrid":
        assert got.halo["tier"] == ("ici" if halo == "fused"
                                    else "collective")


@pytest.mark.parametrize("parity", [False, True])
def test_sharded_solver_across_cards(card, parity):
    """A 2x2 mesh over every visible card (needs two or more): the
    exchange copies between cards, H14 reads its neighbours through peer
    access. Fused equals collective bit for bit; the literal form equals
    serial bit for bit."""
    from heat2d_tpu_torch.ops import cuda_shard as csh
    from heat2d_tpu_torch.parallel.mesh import host_devices
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    devs = host_devices(4)
    cfg = HeatConfig(nxprob=512, nyprob=384, steps=61, mode="hybrid",
                     gridx=2, gridy=2, bitwise_parity=parity)
    csh.reset_launch_counts()
    col = Heat2DSolver(cfg, devices=devs).run(timed=False)
    fused = Heat2DSolver(cfg.replace(halo="fused"),
                         devices=devs).run(timed=False)
    assert fused.halo["tier"] == "ici"
    assert csh.launch_counts()["shard_fused"] > 0
    assert (col.u == fused.u).all()
    want = Heat2DSolver(cfg.replace(mode="serial")).run(timed=False)
    if parity:
        assert (col.u == want.u).all()
    else:
        _close(torch.from_numpy(col.u), torch.from_numpy(want.u), 61,
               cs.FORM_FMA)
    dist = Heat2DSolver(cfg.replace(mode="dist2d"),
                        devices=devs).run(timed=False)
    assert (dist.u == Heat2DSolver(cfg.replace(
        mode="serial", bitwise_parity=False)).run(timed=False).u).all()


# --------------------------------------------------------------------- #
# differentiable solves (heat2d_tpu_torch/diff)
# --------------------------------------------------------------------- #

def _diff_grads(f, u0, w):
    ins = [u0.clone().requires_grad_(),
           torch.tensor(0.1, device=u0.device, requires_grad=True),
           torch.tensor(0.12, device=u0.device, requires_grad=True)]
    out = f(*ins)
    return out.detach(), torch.autograd.grad(torch.sum(w * out), ins)


def test_diff_auto_takes_band_and_launches_h6(card):
    """auto resolves to band at bench.py's 4096^2 x 240 and past the
    resident gate; a band gradient launches one H6 sweep per started T
    steps of each segment, its primal within the FMA bound of the plain
    per-step route's, du0 bit for bit the jnp route's (the step is linear
    in u) and (da, db) within rtol 1e-3; float64 is refused."""
    from heat2d_tpu_torch.diff import make_diff_solve
    from heat2d_tpu_torch.ops.init import inidat
    assert make_diff_solve(4096, 4096, 240).spec.method == "band"
    n, steps = 2048, 20
    f = make_diff_solve(n, n, steps, segment=6)
    assert f.spec.method == "band" and f.spec.schedule == (6, 6, 6, 2)
    u0 = inidat(n, n, device=card)
    u0 = u0 / u0.max()
    ce.reset_launch_counts()
    out, g = _diff_grads(f, u0, u0)
    assert ce.launch_counts()["ens_tile_multi"] == 4
    ref, g_ref = _diff_grads(make_diff_solve(n, n, steps, method="jnp",
                                             segment=6), u0, u0)
    _close(out, ref, steps, cs.FORM_FMA)
    assert torch.equal(g[0], g_ref[0])
    for x, y in zip(g[1:], g_ref[1:]):
        assert float(x) == pytest.approx(float(y), rel=1e-3)
    with pytest.raises(ValueError, match="float32"):
        f(u0.double(), 0.1, 0.1)


def test_diff_checkpoint_equals_full_on_the_card(card):
    from heat2d_tpu_torch.diff import make_diff_solve
    from heat2d_tpu_torch.ops.init import inidat
    n, steps = 256, 13
    u0 = inidat(n, n, device=card)
    u0 = u0 / u0.max()
    w = torch.rand((n, n), generator=torch.Generator(device=card)
                   .manual_seed(3), device=card)
    res = [_diff_grads(make_diff_solve(n, n, steps, adjoint=a, segment=5,
                                       method="jnp"), u0, w)
           for a in ("checkpoint", "full")]
    assert torch.equal(res[0][0], res[1][0])
    assert all(torch.equal(x, y) for x, y in zip(res[0][1], res[1][1]))


def test_diff_leaves_the_forward_paths_unchanged(card):
    """The solver's and the batch runner's results and launch counts are
    the same before and after a band gradient ran."""
    from heat2d_tpu_torch.diff import make_diff_solve

    def forward():
        cs.reset_launch_counts()
        ce.reset_launch_counts()
        u = Heat2DSolver(HeatConfig(nxprob=640, nyprob=1024, steps=24,
                                    mode="pallas")).run(timed=False).u
        run = ensemble.batch_runner(4099, 4097, 16, "band")
        b = torch.ones((2, 4099, 4097), device=card)
        ens = run(b, torch.tensor([0.1, 0.2], device=card),
                  torch.tensor([0.1, 0.05], device=card))
        return (u.tobytes(), ens.cpu().numpy().tobytes(),
                cs.launch_counts(), ce.launch_counts())

    before = forward()
    f = make_diff_solve(2048, 2048, 8)
    u = torch.ones((2048, 2048), device=card, requires_grad=True)
    torch.sum(f(u, 0.1, 0.1)).backward()
    assert forward() == before


def test_inverse_selftest_on_the_card(card):
    from heat2d_tpu_torch.diff.cli import main
    assert main(["--selftest"]) == 0


# --------------------------------------------------------------------- #
# members over device slots, mesh serving, strong scaling
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("method", ["pallas", "band"])
@pytest.mark.parametrize("members", [3, 8])
def test_sharded_ensemble_on_the_card(card, method, members):
    """Members over 4 slots of the card (H5 or H6 per slot) equal the
    one-slot batch bit for bit; the convergence route (H7 per slot) too,
    steps_done included."""
    from heat2d_tpu_torch.parallel.mesh import host_devices
    cxs = [0.02 + 0.02 * i for i in range(members)]
    cys = [0.2 - 0.015 * i for i in range(members)]
    got = ensemble.run_ensemble_sharded(96, 130, 37, cxs, cys,
                                        method=method,
                                        devices=host_devices(4))
    want = ensemble.run_ensemble(96, 130, 37, cxs, cys, method=method)
    assert torch.equal(got, want)
    got, kg = ensemble.run_ensemble_convergence_sharded(
        96, 130, 400, 20, 50.0, cxs, cys, method=method,
        devices=host_devices(4))
    want, kw = ensemble.run_ensemble_convergence(
        96, 130, 400, 20, 50.0, cxs, cys, method=method)
    assert kg.tolist() == kw.tolist()
    assert torch.equal(got, want)


@pytest.mark.parametrize("halo", ["collective", "fused"])
def test_spatial_ensemble_on_the_card(card, halo):
    """Members on a 2x2 submesh of the card equal their dist2d runs bit
    for bit."""
    from heat2d_tpu_torch.parallel.mesh import host_devices
    cxs, cys = [0.1, 0.2, 0.05], [0.1, 0.05, 0.2]
    batch, ks = ensemble.run_ensemble_spatial(
        128, 96, 30, cxs, cys, gridx=2, gridy=2, halo=halo,
        devices=host_devices(8))
    for i, (cx, cy) in enumerate(zip(cxs, cys)):
        cfg = HeatConfig(nxprob=128, nyprob=96, steps=30, mode="dist2d",
                         gridx=2, gridy=2, cx=cx, cy=cy, halo=halo)
        want = Heat2DSolver(cfg, devices=host_devices(4)).run(timed=False)
        assert (batch[i].cpu().numpy() == want.u).all()
    assert ks.tolist() == [30] * 3


def _mesh_parity(devices):
    """The mesh engine over ``devices`` against the one-card engine, bit
    for bit, at every occupancy rung (batch route through H5/H8, spatial
    route against the jnp route)."""
    import numpy as np

    from heat2d_tpu_torch.mesh import MeshEnsembleEngine, MeshScheduler
    from heat2d_tpu_torch.serve.engine import EnsembleEngine
    from heat2d_tpu_torch.serve.schema import SolveRequest
    meshed = MeshEnsembleEngine(devices=devices)
    single = EnsembleEngine(max_batch=8)
    for n in (1, 2, 3, 5, 8):
        for problem in ("heat5", "heat9"):
            rs = [SolveRequest(nx=96, ny=130, steps=37, cx=0.02 + 0.01 * i,
                               cy=0.1, problem=problem) for i in range(n)]
            a, b = meshed.solve_batch(rs), single.solve_batch(rs)
            assert [np.asarray(u).tobytes() for u, _ in a] == \
                [np.asarray(u).tobytes() for u, _ in b]
    spatial = MeshEnsembleEngine(devices=devices, scheduler=MeshScheduler(
        spatial_bytes_threshold=1, devices=devices))
    rs = [SolveRequest(nx=128, ny=96, steps=30, cx=0.1 + 0.02 * i, cy=0.1,
                       method="jnp") for i in range(3)]
    a, b = spatial.solve_batch(rs), single.solve_batch(rs)
    assert spatial.launch_log[-1]["mesh"]["route"] == "spatial"
    assert [np.asarray(u).tobytes() for u, _ in a] == \
        [np.asarray(u).tobytes() for u, _ in b]


def test_mesh_serving_on_the_card(card):
    from heat2d_tpu_torch.parallel.mesh import host_devices
    _mesh_parity(host_devices(4))


def test_mesh_serving_across_cards(card):
    """Mesh serving over every visible card (needs two or more)."""
    from heat2d_tpu_torch.parallel.mesh import visible_devices
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    _mesh_parity(visible_devices())


@pytest.mark.parametrize("halo", ["collective", "fused"])
def test_hybrid_scaling_across_cards(card, halo):
    """Strong scaling in hybrid mode over every visible card (needs two
    or more): H12 for collective, H14 for fused, both launched."""
    from heat2d_tpu_torch.ops import cuda_shard as csh
    from heat2d_tpu_torch.parallel.mesh import visible_devices
    from heat2d_tpu_torch.parallel.scaling import measure_strong_scaling
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    csh.reset_launch_counts()
    rec = measure_strong_scaling(n, 1024, 1024, 64, halo=halo,
                                 mode="hybrid", devices=visible_devices())
    assert rec["halo_tier"] == ("ici" if halo == "fused" else "collective")
    assert rec["mcells_per_s_nchip"] > 0
    name = "shard_fused" if halo == "fused" else "shard_tile_multi"
    assert csh.launch_counts()[name] > 0


@pytest.mark.parametrize("convergence", [False, True])
def test_two_process_hybrid_world_on_the_card(card, tmp_path, convergence):
    """A 2-process world of the port's CLI on the card (gloo, the strips
    staged through pinned host buffers; rank r on cuda:(r % count)):
    hybrid on a 2x2 mesh, two shards a process, running H12 (and H13
    with convergence) per rank, bit for bit the one-process hybrid run
    on host_devices(4), steps_done equal."""
    import json
    import sys

    import numpy as np

    from heat2d_tpu_torch.dist.harness import spawn_world
    from heat2d_tpu_torch.parallel.mesh import host_devices
    cfg = HeatConfig(nxprob=512, nyprob=384, steps=40, mode="hybrid",
                     gridx=2, gridy=2, convergence=convergence,
                     interval=10, sensitivity=1e9 if convergence else 0.1)
    args = ["--mode", "hybrid", "--gridx", "2", "--gridy", "2",
            "--nxprob", "512", "--nyprob", "384", "--steps", "40",
            "--host-device-count", "2", "--binary-dumps",
            "--dat-layout", "none", "--outdir", str(tmp_path),
            "--run-record", str(tmp_path / "rec.json")]
    if convergence:
        args += ["--convergence", "--interval", "10", "--sensitivity",
                 "1e9"]
    res = spawn_world(2, lambda i, coord: [
        sys.executable, "-m", "heat2d_tpu_torch.cli", "--coordinator",
        coord, "--num-processes", "2", "--process-id", str(i)] + args,
        timeout=180)
    assert all(r.ok for r in res), [r.output for r in res]
    ref = Heat2DSolver(cfg, devices=host_devices(4)).run(timed=False)
    got = np.fromfile(tmp_path / "final_binary.dat", np.float32)
    assert got.tobytes() == np.ascontiguousarray(ref.u).tobytes()
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["steps_done"] == ref.steps_done
    name = "shard_tile_multi_resid" if convergence else "shard_tile_multi"
    assert all(row[name] > 0 for row in rec["launches_by_process"])


def test_tune_search_resumes_and_applies_bitwise(card, tmp_path):
    """A two-candidate real search on the card (the tile route at 2048^2:
    the planner's (ty, T) = (64, 8) and (32, 8)), resumed as a pure cache
    hit; the
    applied db steers the main path's plan, bitwise the default plan's
    result, with ``tuned_config`` naming the db's best."""
    import io

    from heat2d_tpu_torch.tune import cli as tcli
    from heat2d_tpu_torch.tune import runtime as tr
    from heat2d_tpu_torch.tune.db import TuningDB
    from heat2d_tpu_torch.tune.space import Problem

    path = str(tmp_path / "db.json")
    problem = Problem(2048, 2048)
    kw = dict(routes=("tile",), ty_grid=(32,), t_ladder=(8,), reps=2,
              device=card, out=io.StringIO())
    s1 = tcli.search_problem(TuningDB(path), problem, **kw)
    assert s1["measured"] == 2 and s1["failed"] == 0, s1
    s2 = tcli.search_problem(TuningDB(path), problem, **kw)
    assert s2["measured"] == 0 and s2["cached"] == s1["measured"]
    best = s1["best"]
    cfg = HeatConfig(nxprob=2048, nyprob=2048, steps=240, mode="pallas")
    want = Heat2DSolver(cfg).run(timed=False).u
    try:
        tr.set_tuning_db(path)
        runner = cs.make_single_chip_runner(cfg)
        assert (runner.plan.ty, runner.plan.tsteps) == (best["bm"],
                                                        best["tsteps"])
        got = Heat2DSolver(cfg).run(timed=False).u
        applied = tr.applied_configs()
    finally:
        tr.set_tuning_db(None)
    assert (got == want).all()
    assert applied[0]["source"] == "exact"
    assert (applied[0]["bm"], applied[0]["tsteps"]) == (best["bm"],
                                                        best["tsteps"])


@pytest.mark.parametrize("shape,steps,kernel,wrapper", [
    ((2048, 2100), 80, "H2", "tile_multi"),
    ((640, 1024), 2000, "H4", "resident")])
def test_profiled_run_counts_and_bits_equal_untraced(card, tmp_path, shape,
                                                     steps, kernel, wrapper):
    """A run under ``profile_span`` and an armed tracer gives the
    untraced run's grid bit for bit and its launch counts, and the
    capture holds one event of the kernel per launch (``trace_report``'s
    H labels)."""
    from heat2d_tpu_torch.obs import trace_report, tracing
    from heat2d_tpu_torch.utils.profiling import profile_span
    cfg = HeatConfig(nxprob=shape[0], nyprob=shape[1], steps=steps,
                     mode="pallas")
    cs.reset_launch_counts()
    want = Heat2DSolver(cfg).run()
    plain = cs.launch_counts()
    tracing.install(tracing.Tracer(str(tmp_path / "trace"), service="t"))
    try:
        cs.reset_launch_counts()
        with profile_span(str(tmp_path / "prof"), device=card):
            got = Heat2DSolver(cfg).run()
        traced = cs.launch_counts()
    finally:
        tracing.uninstall()
    assert (got.u.tobytes() == want.u.tobytes()) and traced == plain
    d = trace_report.report(str(tmp_path / "prof"))
    kern = {k["kernel"]: k for k in d["kernels"]}
    assert kern[kernel]["count"] == traced[wrapper] > 0
    # the run's own kernel is the top compute op (the copies, such as
    # the result's gather to the host, are host/transfer)
    top = [op for op in d["top_ops"] if op["category"] == "compute"][0]
    assert top["kernel"] == kernel
    assert d["lanes"] and d["lanes"][0]["busy_s"] > 0


def test_profile_span_refuses_a_capture_without_kernels(card, tmp_path):
    from heat2d_tpu_torch.utils.profiling import (EmptyCaptureError,
                                                  profile_span)
    with pytest.raises(EmptyCaptureError, match="no CUDA kernel event"):
        with profile_span(str(tmp_path), device=card):
            torch.ones(3).sum()     # on the host: nothing on the card
