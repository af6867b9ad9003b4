"""The ADI cell on the CPU: the plain reference (``reference/adi.py``)
against a dense solve and the explicit scheme, the port's ADI solver held
to it, the frozen counts of ``yardstick_adi``, the readers' arithmetic,
and a whole run of the cell's files at a small size."""

import math

import numpy as np
import pytest
import torch

from portbench import yardstick, yardstick_adi
from portbench.reference import adi, heat5
from portbench.tests._small_adi import run_small

H100 = "NVIDIA H100 80GB HBM3"

#: The port against the float64 reference, as a share of max|inidat|.
#: Each half's right-hand side ``u + (c/2)(n + s - 2u)`` carries a
#: float32 rounding of u (2^-24 of it) into the interior multiplied by up
#: to 2c <= 100, about 6e-6 of the field a half; the implicit solve then
#: damps it (every mode's amplification is at most 1), so the halves'
#: errors do not compound. The limit is three times that one-half bound,
#: room for the solves' own roundings; the worst over 16 seeded runs of
#: both modes read 2.1e-6.
PORT_TOL = 2e-5


def _cn_dense(n, c):
    a, b, cc = adi.cn_bands(n, torch.tensor([c], dtype=torch.float64))
    return (torch.diag(b[0]) + torch.diag(a[0, 1:], -1)
            + torch.diag(cc[0, :-1], 1))


@pytest.mark.parametrize("n", [3, 9, 40])
@pytest.mark.parametrize("c", [0.05, 12.5, 50.0])
def test_thomas_matches_a_dense_solve(n, c):
    gen = torch.Generator().manual_seed(n)
    d = torch.randn(2, n, 5, dtype=torch.float64, generator=gen)
    cs = torch.tensor([c, c / 2], dtype=torch.float64)
    x = adi.thomas(adi.system(n, cs), d)
    for k, ck in enumerate((c, c / 2)):
        want = torch.linalg.solve(_cn_dense(n, ck), d[k])
        assert torch.allclose(x[k], want, rtol=1e-12, atol=1e-12)


def test_cn_matrix_has_identity_edge_rows():
    m = _cn_dense(6, 12.5)
    assert m[0].tolist() == [1, 0, 0, 0, 0, 0]
    assert m[5].tolist() == [0, 0, 0, 0, 0, 1]
    assert m[2, 1:4].tolist() == [-6.25, 13.5, -6.25]


def test_reference_holds_the_edges_and_keeps_members_apart():
    both, done = adi.solve(12, 9, 3, [20.0, 40.0], [30.0, 15.0])
    assert done == [3, 3]
    one, _ = adi.solve(12, 9, 3, [40.0], [15.0])
    assert torch.equal(both[1], one[0])
    for g in both:
        assert not g[0].any() and not g[-1].any()
        assert not g[:, 0].any() and not g[:, -1].any()


@pytest.mark.parametrize("c", [0.01, 0.03])
def test_reference_approaches_the_explicit_scheme_at_small_steps(c):
    # CN-ADI and the explicit update are both consistent with the heat
    # equation: at small diffusion numbers they differ by a small share of
    # the change a solve makes
    a, _ = adi.solve(16, 12, 10, [c], [2 * c])
    e, _ = heat5.solve(16, 12, 10, [c], [2 * c])
    gaps = heat5.grid_gaps(a[0], e[0], heat5.inidat(16, 12))
    assert gaps["grid_rms_gap"] < 0.02, gaps


def _pairs(seed, k):
    rng = np.random.default_rng(seed)
    return [tuple(round(float(v), 6) for v in rng.uniform(12.5, 50.0, 2))
            for _ in range(k)]


@pytest.mark.parametrize("mode", ["pallas", "serial"])
@pytest.mark.parametrize("shape", [(34, 27), (33, 64)])
@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_port_adi_matches_the_reference(mode, shape, seed):
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    nx, ny = shape
    pairs = _pairs(seed, 2)
    refs, _ = adi.solve(nx, ny, 6, [p[0] for p in pairs],
                        [p[1] for p in pairs])
    scale = float(heat5.inidat(nx, ny).abs().max())
    for (cx, cy), ref in zip(pairs, refs):
        r = Heat2DSolver(HeatConfig(nxprob=nx, nyprob=ny, steps=6, cx=cx,
                                    cy=cy, method="adi", mode=mode),
                         device="cpu").run(timed=False)
        assert r.route == ("adi-kernel" if mode == "pallas" else "adi-scan")
        gap = float((torch.as_tensor(r.u).double() - ref).abs().max())
        assert gap / scale < PORT_TOL, (cx, cy, gap / scale)


def test_yardstick_adi_counts_from_the_sizes_alone():
    upd, flops, nbytes = yardstick_adi.solve_work(2560, 2048, 40)
    assert upd == 209_715_200
    assert flops == 18 * upd
    assert nbytes == 2 * 2560 * 2048 * 4
    assert yardstick_adi.tridiag_work(upd) == (10 * upd, 16 * upd)
    peaks = yardstick.peaks_for(H100)
    t, bound = yardstick.least_time(flops, nbytes, peaks)
    assert bound == "flops" and t == pytest.approx(18 * upd / 67e12)
    t, bound = yardstick.least_time(*yardstick_adi.tridiag_work(upd), peaks)
    assert bound == "bytes" and t == pytest.approx(16 * upd / 3.35e12)


def _ctx(kind="adi", ops=None, updates=8 * 209_715_200):
    ops = ops if ops is not None else [["H10 k_td_rows", 0.006],
                                       ["H11 k_td_lanes", 0.004],
                                       ["td_coeffs k_td_coeffs", 1e-4]]
    return {"kind": kind, "peaks": yardstick.peaks_for(H100),
            "digest": {"device_ops": ops, "kernel_s": 0.02,
                       "window_s": 0.3, "idle_pct": {0: 12.5},
                       "work": {"updates": updates,
                                "flops": 18 * updates,
                                "bytes": 8 * 2 * 2560 * 2048 * 4}}}


def test_readers_of_the_trace():
    from portbench import harness
    readers = harness.metric_readers()
    value, _ = readers["kernels_roofline.adi_tridiag"].read(_ctx())
    want = 100 * 16 * 8 * 209_715_200 / 3.35e12 / 0.010
    assert value == pytest.approx(want)
    value, _ = readers["kernels_roofline.adi"].read(_ctx())
    assert value == pytest.approx(100 * 18 * 8 * 209_715_200 / 67e12 / 0.02)
    assert readers["device_idle_pct.adi"].read(_ctx())[0] == 12.5
    # nothing to read: another cell, or a solve kernel missing
    for name in ("kernels_roofline.adi_tridiag", "kernels_roofline.adi",
                 "device_idle_pct.adi"):
        assert readers[name].read(_ctx(kind="solve")) is None
    assert readers["kernels_roofline.adi_tridiag"].read(
        _ctx(ops=[["H10 k_td_rows", 0.006]])) is None


def test_whole_small_run_is_correct_on_the_adi_route():
    routes = []

    def on_driver(drv):
        solve = drv._solve

        def recording(cx, cy):
            r = solve(cx, cy)
            routes.append(r.route)
            return r
        drv._solve = recording

    r = run_small(on_driver=on_driver)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"grid_gap", "grid_rms_gap"}
    assert set(routes) == {"adi-kernel"}
    assert r["metrics"]["mcells_per_s"]["value"] > 0


def test_traced_small_run_reads_the_adi_spans():
    from heat2d_tpu_torch.obs.metrics import reset_registry
    reset_registry()
    r = run_small(trace=True)
    assert r["correct"], r["checks"]
    got = r["metrics"]["adi.host_us_per_step"]
    assert got["unit"] == "us" and math.isfinite(got["value"])
    assert got["value"] > 0
    # the heat5 cells' readers have nothing to read here, and on the CPU
    # there are no peaks for a roofline or an idle share
    for name in ("solver.host_ms_per_solve", "kernels_roofline.solve",
                 "kernels_roofline.adi", "device_idle_pct.adi"):
        assert name not in r["metrics"]


def test_driver_refuses_the_convergence_check():
    from portbench import harness
    from portbench.tests._small_adi import small_cell
    cell = small_cell()
    cell.traffic["convergence"] = True
    with pytest.raises(ValueError, match="convergence"):
        harness.driver_class("closed_loop_implicit")(cell, 1, [
            torch.device("cpu")])
