"""On a card: one short run of each cell added beside the ADI cell,
through the harness, comes out correct with its metrics; the inverse
cell's jobs run H6 as often as their forward segments' band sweeps.
Skips where no card is present."""

import pytest

from portbench import harness

CELLS = ["inverse-2560x2048", "serve-640x1024-cached"]
METRIC = {"inverse-2560x2048": "mcells_per_s",
          "serve-640x1024-cached": "solve_p95_ms"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(name, 2**31 + 3, 2.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["metrics"]["setup_s"]["value"] > 0
    assert r["metrics"][METRIC[name]]["value"] > 0


@pytest.mark.cuda
def test_inverse_jobs_take_the_band_route():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from heat2d_tpu_torch.diff.adjoint import segment_schedule
    from heat2d_tpu_torch.ops import _build
    from heat2d_tpu_torch.ops.cuda_ensemble import DEFAULT_TSTEPS
    jobs = []

    def on_driver(drv):
        job = drv._job

        def counted(problem, pause=None):
            _build.reset_launch_counts()
            sol = job(problem, pause)
            jobs.append((sol.iterations,
                         _build.launch_counts("ensemble")["ens_tile_multi"]))
            return sol
        drv._job = counted

    r = harness.run_cell("inverse-2560x2048", 2**31 + 5, 2.0, False,
                         on_driver=on_driver)
    assert r["correct"], r["checks"]
    sweeps = sum(-(-k // DEFAULT_TSTEPS) for k in segment_schedule(1000))
    assert sweeps == 125
    assert jobs and all(h6 == n * sweeps for n, h6 in jobs), jobs
