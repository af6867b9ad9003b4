"""The inverse cell on the CPU: the plain reference (``reference/inverse.py``)
against its own adjoint identity and against autograd, the port held to
it, the frozen count of ``yardstick_inverse``, the four readers, a whole
run of the cell's files at a small size, and its control and faults
(``controls_inverse.py``) coming out not correct."""

import math

import numpy as np
import pytest
import torch

from portbench import controls_inverse, harness, yardstick
from portbench import yardstick_inverse
from portbench.reference import heat5, inverse
from portbench.tests._small_inverse import CELL, SMALL, run_small, small_cell

H100 = "NVIDIA H100 80GB HBM3"


def _coeffs(b):
    cx = torch.tensor([0.1, 0.17, 0.05][:b], dtype=torch.float64)
    cy = torch.tensor([0.05, 0.2, 0.13][:b], dtype=torch.float64)
    return cx.view(b, 1, 1), cy.view(b, 1, 1)


@pytest.mark.parametrize("shape", [(3, 3), (9, 17), (40, 31)])
@pytest.mark.parametrize("steps", [1, 7])
def test_adjoint_identity_of_the_written_out_transpose(shape, steps):
    gen = torch.Generator().manual_seed(shape[0] + steps)
    u = torch.randn(3, *shape, dtype=torch.float64, generator=gen)
    w = torch.randn(3, *shape, dtype=torch.float64, generator=gen)
    cx, cy = _coeffs(3)
    lhs = (inverse.forward(u, steps, cx, cy) * w).sum(dim=(1, 2))
    rhs = (u * inverse.pullback(w, steps, cx, cy)).sum(dim=(1, 2))
    scale = (u.norm(dim=(1, 2)) * w.norm(dim=(1, 2)))
    assert torch.all((lhs - rhs).abs() <= 1e-12 * scale), (lhs - rhs)


def _plain_loss(p, steps, cx, cy, mask, obs):
    u = p
    for _ in range(steps):
        new = u.clone()
        c = u[:, 1:-1, 1:-1]
        new[:, 1:-1, 1:-1] = (c + cx * (u[:, 2:, 1:-1] + u[:, :-2, 1:-1]
                                        - 2 * c)
                              + cy * (u[:, 1:-1, 2:] + u[:, 1:-1, :-2]
                                      - 2 * c))
        u = new
    r = (u - obs) * mask
    return (r * r).sum(dim=(1, 2)) / mask.sum()


@pytest.mark.parametrize("every", [1, 3])
def test_reference_gradient_equals_autograd_of_a_plain_loop(every):
    nx, ny, steps = 14, 11, 9
    cxs, cys = [0.1, 0.17], [0.05, 0.2]
    mask = inverse.observation_mask(nx, ny, every)
    obs = inverse.observe(inverse.unit_init(nx, ny), steps, cxs, cys, mask)
    p = torch.randn(2, nx, ny, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(every))
    lo, g = inverse.value_and_grad(p, steps, cxs, cys, mask, obs)
    cx, cy = (torch.tensor(c, dtype=torch.float32).double().view(2, 1, 1)
              for c in (cxs, cys))
    pp = p.clone().requires_grad_()
    want = _plain_loss(pp, steps, cx, cy, mask, obs)
    (ga,) = torch.autograd.grad(want.sum(), pp)
    assert torch.allclose(lo, want.detach(), rtol=1e-13, atol=0)
    assert torch.allclose(g, ga, rtol=1e-11, atol=1e-15)


def test_reference_truth_and_mask_are_the_programs():
    from heat2d_tpu_torch.diff.inverse import (observation_mask,
                                               unit_reference_init)
    for nx, ny in ((12, 12), (9, 17), (160, 128)):
        assert np.array_equal(inverse.unit_init(nx, ny).numpy(),
                              unit_reference_init(nx, ny))
        assert np.array_equal(inverse.observation_mask(nx, ny, 3).numpy(),
                              observation_mask(nx, ny, 3))


def test_observations_hold_the_edges_and_keep_members_apart():
    nx, ny = 12, 9
    mask = inverse.observation_mask(nx, ny, 1)
    truth = inverse.unit_init(nx, ny)
    both = inverse.observe(truth, 5, [0.1, 0.2], [0.15, 0.05], mask)
    one = inverse.observe(truth, 5, [0.2], [0.05], mask)
    assert torch.equal(both[1], one[0])
    # the truth is inidat at a unit peak, rounded to float32 (2^-24)
    want = heat5.solve(nx, ny, 5, [0.2], [0.05])[0][0]
    assert torch.allclose(one[0] * float(heat5.inidat(nx, ny).max()),
                          want * mask, rtol=1e-7, atol=0)
    assert not one[0][~mask].any()


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_port_loss_and_gradient_match_the_reference(seed):
    from heat2d_tpu_torch.diff.inverse import InverseProblem
    nx, ny, steps = SMALL
    rng = np.random.default_rng(seed)
    cx, cy = (round(float(v), 6) for v in rng.uniform(0.05, 0.2, 2))
    mask = inverse.observation_mask(nx, ny, 3)
    obs = inverse.observe(inverse.unit_init(nx, ny), steps, [cx], [cy],
                          mask)[0].float()
    prob = InverseProblem(nx, ny, steps, "init", mask.numpy(),
                          obs.numpy(), cx=cx, cy=cy, device="cpu")
    p0 = torch.as_tensor(prob.initial_params())
    assert torch.equal(p0, inverse.first_iterate(mask, obs))
    lo, g = prob.value_and_grad()(p0)
    ref_lo, ref_g = inverse.value_and_grad(p0[None], steps, [cx], [cy],
                                           mask, obs)
    gaps = inverse.gaps(g, ref_g[0])
    assert gaps["grad_gap"] < 1e-5 and gaps["grad_rms_gap"] < 1e-5, gaps
    assert inverse.loss_gap(lo, ref_lo[0]) < 1e-5


@pytest.mark.parametrize("iterations", [1, 4])
def test_reference_adam_is_the_programs_adam_on_the_reference(iterations):
    """``reference.inverse.adam`` takes the steps ``adam_minimize`` takes
    when both run on the float64 reference's loss and gradient."""
    from heat2d_tpu_torch.diff.inverse import adam_minimize
    nx, ny, steps, cx, cy = 20, 16, 12, 0.13, 0.07
    mask = inverse.observation_mask(nx, ny, 3)
    obs = inverse.observe(inverse.unit_init(nx, ny), steps, [cx], [cy],
                          mask)[0].float()
    p0 = inverse.first_iterate(mask, obs)

    def vg(p):
        lo, g = inverse.value_and_grad(p[None], steps, [cx], [cy], mask,
                                       obs)
        return lo[0], g[0]

    want = adam_minimize(vg, p0.double(), iterations=iterations, lr=0.02)
    best, best_loss = inverse.adam(p0, steps, cx, cy, mask, obs,
                                   iterations=iterations, lr=0.02)
    assert best_loss == want.final_loss
    assert np.array_equal(best.numpy(), want.params)
    if iterations > 1:
        assert inverse.step_gap(want.params, best, p0) == 0.0
        # a job that never moved reads 1
        assert inverse.step_gap(p0, best, p0) == 1.0


def test_yardstick_inverse_counts_from_the_sizes_alone():
    upd, flops, nbytes = yardstick_inverse.iteration_work(2560, 2048, 1000)
    assert upd == 5_242_880_000
    assert flops == 21 * upd
    assert nbytes == 6 * 2560 * 2048 * 4
    t, bound = yardstick.least_time(flops, nbytes, yardstick.peaks_for(H100))
    assert bound == "flops" and t == pytest.approx(21 * upd / 67e12)


def _ctx(kind="inverse"):
    upd = 5_242_880_000
    return {"kind": kind, "peaks": yardstick.peaks_for(H100),
            "digest": {"device_ops": [["H6 k_ens_tile", 0.009]],
                       "kernel_s": 0.88, "window_s": 3.0,
                       "idle_pct": {0: 66.7},
                       "work": {"updates": upd, "flops": 21 * upd,
                                "bytes": 6 * 2560 * 2048 * 4}}}


def test_readers_of_the_trace():
    readers = harness.metric_readers()
    value, _ = readers["kernels_roofline.inverse"].read(_ctx())
    assert value == pytest.approx(100 * 21 * 5_242_880_000 / 67e12 / 0.88)
    assert readers["device_idle_pct.inverse"].read(_ctx())[0] == 66.7
    for name in ("kernels_roofline.inverse", "device_idle_pct.inverse",
                 "diff.pullback_share", "diff.host_us_per_pullback_step"):
        assert readers[name].read(_ctx(kind="solve")) is None


def test_whole_small_run_is_correct():
    r = run_small()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"grad_gap", "grad_rms_gap", "loss_gap",
                                "step_gap"}
    assert r["metrics"]["mcells_per_s"]["value"] > 0
    assert r["checks"]["grad_gap"]["value"] < 1e-5


def test_traced_small_run_reads_the_diff_spans():
    r = run_small(trace=True)
    assert r["correct"], r["checks"]
    share = r["metrics"]["diff.pullback_share"]
    assert share["unit"] == "%" and 0 < share["value"] < 100
    per = r["metrics"]["diff.host_us_per_pullback_step"]
    assert per["unit"] == "us" and math.isfinite(per["value"])
    assert per["value"] > 0
    # the other cells' readers have nothing to read here, and on the CPU
    # there are no peaks for a roofline or an idle share
    for name in ("solver.host_ms_per_solve", "adi.host_us_per_step",
                 "kernels_roofline.inverse", "device_idle_pct.inverse"):
        assert name not in r["metrics"]


def test_each_job_runs_the_programs_inverse_solve():
    seen = []

    def on_driver(drv):
        job = drv._job

        def recording(problem, pause=None):
            sol = job(problem, pause)
            seen.append((type(problem).__name__, problem.target,
                         sol.iterations, len(sol.loss_history)))
            return sol
        drv._job = recording

    r = run_small(on_driver=on_driver)
    assert r["correct"], r["checks"]
    iters = small_cell().config["iterations"]
    assert set(seen) == {("InverseProblem", "init", iters, iters)}


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
@pytest.mark.parametrize("variant", ["control", "half_pullback",
                                     "zero_gradient", "half_forward",
                                     "unchanged"])
def test_control_and_faults_are_not_correct(variant, seed):
    r = controls_inverse.run_variant(CELL, variant, seed, 0.3,
                                     device="cpu", cell=small_cell())
    assert not r["correct"], r["readings"]
    assert set(r["checks"]) == set(small_cell().limits)
    if variant == "zero_gradient":
        assert r["readings"]["grad_gap"] == 1.0
        assert r["readings"]["grad_rms_gap"] == 1.0
    if variant in ("zero_gradient", "unchanged"):
        # every job ends where it started
        assert r["readings"]["step_gap"] == 1.0
    if variant == "unchanged":
        # the gradient and the losses are the program's: only the move
        # tells this fault
        limits = small_cell().limits
        assert all(r["readings"][k] <= limits[k]
                   for k in ("grad_gap", "grad_rms_gap", "loss_gap"))


def test_sound_run_is_correct():
    r = controls_inverse.run_variant(CELL, "sound", 2**31 + 11, 0.3,
                                     device="cpu", cell=small_cell())
    assert r["correct"], r["readings"]


def test_driver_refuses_another_target():
    cell = small_cell()
    cell.config["target"] = "diffusivity"
    with pytest.raises(ValueError, match="target"):
        harness.driver_class("closed_loop_inverse")(cell, 1, [
            torch.device("cpu")])
