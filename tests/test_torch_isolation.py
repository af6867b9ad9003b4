"""The port stands alone: no module of heat2d_tpu_torch (and not
chip_smoke.py or bench_torch.py) imports jax or heat2d_tpu; its entry
points (solver, ensembles, serving, differentiable solves, the CLIs)
refuse to run without a card unless asked for the CPU; its tile plans
fit the H100's shared memory; chip_smoke.py refuses to run without a card
or without the package beside it."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat2d_tpu_torch import cli
from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.interop import state_from_numpy
from heat2d_tpu_torch.models.solver import Heat2DSolver
from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.utils.device import DeviceUnavailableError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "heat2d_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "bench_torch.py")


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "heat2d_tpu")


def test_no_module_imports_jax_or_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) >= 36
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported(p) if _forbidden(m)]
    assert bad == []


def test_importing_the_solver_loads_no_jax():
    code = ("import sys; import heat2d_tpu_torch.models.solver, "
            "heat2d_tpu_torch.cli, heat2d_tpu_torch.ops.cuda_stencil; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


def test_importing_ensembles_and_serving_loads_no_jax():
    code = ("import sys; import heat2d_tpu_torch.models.ensemble, "
            "heat2d_tpu_torch.serve.cli, heat2d_tpu_torch.serve.server, "
            "heat2d_tpu_torch.resil.retry, heat2d_tpu_torch.obs.metrics; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


def test_importing_the_sharded_modes_loads_no_jax():
    code = ("import sys; import heat2d_tpu_torch.parallel.mesh, "
            "heat2d_tpu_torch.parallel.halo, "
            "heat2d_tpu_torch.parallel.sharded, "
            "heat2d_tpu_torch.parallel.multihost, "
            "heat2d_tpu_torch.ops.cuda_shard; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


def test_importing_diff_and_the_bench_loads_no_jax():
    code = ("import sys; import heat2d_tpu_torch.diff, "
            "heat2d_tpu_torch.diff.cli, heat2d_tpu_torch.resil.snapshot, "
            "heat2d_tpu_torch.io.binary, bench_torch; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


def test_serving_imports_diff_only_for_inverse_traffic():
    code = ("import sys; import heat2d_tpu_torch.serve.server, "
            "heat2d_tpu_torch.serve.cli; "
            "print('heat2d_tpu_torch.diff' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False"]


def test_diff_entry_points_raise_without_a_card(no_card):
    from heat2d_tpu_torch.diff import InverseProblem, make_diff_solve
    from heat2d_tpu_torch.diff.inverse import loss_grad_runner
    mask = np.ones((8, 8), bool)
    calls = [
        lambda: make_diff_solve(8, 8, 4),
        lambda: InverseProblem(nx=8, ny=8, steps=4, target="init",
                               obs_mask=mask,
                               obs_values=np.zeros((8, 8))).solve(),
        lambda: loss_grad_runner(8, 8, 4, "init", "checkpoint", None,
                                 "auto", False),
    ]
    for call in calls:
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            call()
    # ... and run when asked for the CPU.
    f = make_diff_solve(8, 8, 4, device="cpu")
    assert f.spec.method == "jnp"
    assert tuple(f(np.zeros((8, 8), np.float32), 0.1, 0.1).shape) == (8, 8)


def test_sharded_entry_points_raise_without_a_card(no_card, capsys):
    from heat2d_tpu_torch.parallel import mesh
    cfgs = [HeatConfig(mode="hybrid", gridx=2, gridy=2),
            HeatConfig(mode="dist2d", gridx=2, gridy=2, halo="fused"),
            HeatConfig(mode="dist1d", numworkers=3)]
    for cfg in cfgs:
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            Heat2DSolver(cfg)
    with pytest.raises(DeviceUnavailableError, match="CUDA"):
        mesh.host_devices(4)
    for mode in ("hybrid", "dist2d"):
        assert cli.main(["--mode", mode, "--gridx", "2", "--gridy", "2",
                         "--host-device-count", "4"]) == 1
    assert capsys.readouterr().err.count("CUDA") == 2
    # ... and run when asked for the CPU.
    assert Heat2DSolver(cfgs[0], device="cpu",
                        devices=mesh.host_devices(4, "cpu")).run(
        timed=False).route == "sharded-kernel"


def test_importing_families_and_implicit_loads_no_jax():
    code = ("import sys; import heat2d_tpu_torch.problems.runners, "
            "heat2d_tpu_torch.ops.tridiag, heat2d_tpu_torch.ops.multigrid, "
            "heat2d_tpu_torch.ops.cuda_family, "
            "heat2d_tpu_torch.models.solution; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, capsys):
    cfg = HeatConfig(mode="pallas")
    with pytest.raises(DeviceUnavailableError, match="CUDA"):
        Heat2DSolver(cfg)
    with pytest.raises(DeviceUnavailableError, match="CUDA"):
        cs.make_single_chip_runner(cfg)
    with pytest.raises(DeviceUnavailableError, match="CUDA"):
        state_from_numpy(np.zeros((4, 4)))
    assert cli.main(["--mode", "pallas"]) == 1
    assert "CUDA" in capsys.readouterr().err
    # ... and run when asked for the CPU.
    assert Heat2DSolver(cfg, device="cpu").run(timed=False).steps_done == 100


def test_ensemble_and_serve_entry_points_raise_without_a_card(no_card,
                                                              capsys):
    from heat2d_tpu_torch.interop import batch_from_numpy
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.serve import cli as serve_cli
    from heat2d_tpu_torch.serve.server import SolveServer

    calls = [
        lambda: ensemble.run_ensemble(8, 8, 1, [0.1], [0.1]),
        lambda: ensemble.run_ensemble_convergence(8, 8, 4, 2, 0.1, [0.1],
                                                  [0.1]),
        lambda: ensemble.timed_ensemble(8, 8, 1, [0.1], [0.1]),
        lambda: ensemble.batch_runner(8, 8, 1, "auto"),
        lambda: batch_from_numpy(np.zeros((1, 4, 4)), [0.1], [0.1]),
        lambda: SolveServer(),
    ]
    for call in calls:
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            call()
    assert cli.main(["--ensemble-cx", "0.1", "--ensemble-cy", "0.1"]) == 1
    assert serve_cli.main(["--selftest"]) == 1
    assert capsys.readouterr().err.count("CUDA") == 2
    # ... and run when asked for the CPU.
    assert ensemble.run_ensemble(8, 8, 1, [0.1], [0.1],
                                 device="cpu").shape == (1, 8, 8)
    assert serve_cli.main(["--selftest", "--device", "cpu"]) == 0


def test_implicit_and_family_entry_points_raise_without_a_card(no_card,
                                                              capsys):
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.models.solution import bench_tts
    calls = [
        lambda: Heat2DSolver(HeatConfig(method="adi", mode="pallas")),
        lambda: Heat2DSolver(HeatConfig(method="mg")),
        lambda: Heat2DSolver(HeatConfig(problem="heat9")),
        lambda: ensemble.run_ensemble(8, 8, 1, [8.0], [8.0], method="adi"),
        lambda: ensemble.run_ensemble(8, 8, 1, [0.1], [0.1],
                                      problem="advdiff"),
        lambda: bench_tts(quick=True),
    ]
    for call in calls:
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            call()
    assert cli.main(["--method", "adi", "--cx", "8", "--cy", "8"]) == 1
    assert "CUDA" in capsys.readouterr().err
    # ... and run when asked for the CPU.
    assert Heat2DSolver(HeatConfig(method="adi", mode="pallas"),
                        device="cpu").run(timed=False).route == "adi-kernel"


@pytest.mark.parametrize("shape", [(4096, 4096), (640, 1024), (4099, 4097),
                                   (10, 10)])
@pytest.mark.parametrize("tsteps", [1, 3, 8])
def test_tile_plan_fits_shared_memory(shape, tsteps):
    plan = cs.plan_tiles(*shape, tsteps)
    # 227 KB: the H100's opt-in shared memory per block.
    assert plan.smem_bytes + cs._STATIC_SMEM <= 227 * 1024
    assert plan.grid[0] * plan.ty >= shape[0]
    assert plan.grid[1] * plan.tx >= shape[1]
    assert plan.ty % cs.BLOCK[1] == 0 and plan.tx % cs.BLOCK[0] == 0


def test_tile_plan_shrinks_under_a_small_limit():
    plan = cs.plan_tiles(4096, 4096, 8, smem=48 * 1024)
    assert plan.smem_bytes <= 48 * 1024
    with pytest.raises(ValueError):
        cs.plan_tiles(4096, 4096, 64, smem=48 * 1024)


def test_resident_gate_on_the_cpu():
    assert cs.fits_resident((640, 1024), "cpu")
    assert cs.fits_resident((10, 10), "cpu")
    assert not cs.fits_resident((4096, 4096), "cpu")


def test_build_is_keyed_by_content_and_needs_nvcc(monkeypatch):
    assert set(_build.SIGNATURES) == {"stencil", "ensemble", "family",
                                      "tridiag", "shard"}
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "stencil.cu", "ensemble.cu", "family.cu", "tridiag.cu", "shard.cu"}
    p = _build.library_path("stencil")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libstencil_")
    assert p == _build.library_path("stencil")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("stencil") != p
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    if not torch.cuda.is_available():
        assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_importing_mesh_scaling_and_tune_loads_no_jax():
    code = ("import sys; import heat2d_tpu_torch.mesh, "
            "heat2d_tpu_torch.mesh.bench, heat2d_tpu_torch.mesh.chaos_gate, "
            "heat2d_tpu_torch.ops.abft, heat2d_tpu_torch.parallel.scaling, "
            "heat2d_tpu_torch.tune.measure; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]
    mods = {os.path.relpath(p, PKG).split(os.sep)[0]
            for p in _port_sources()}
    assert {"mesh", "tune"} <= mods


def test_mesh_entry_points_raise_without_a_card(no_card, capsys):
    """The mesh engine, its scheduler and admission, the sharded and
    spatial ensembles and strong scaling span the visible cards by
    default and refuse to start without one; the mesh CLIs exit 1."""
    from heat2d_tpu_torch.mesh import (MeshAdmission, MeshEnsembleEngine,
                                       MeshScheduler, bench, chaos_gate)
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.parallel.scaling import measure_strong_scaling
    from heat2d_tpu_torch.serve import cli as scli
    calls = [
        MeshEnsembleEngine, MeshScheduler, MeshAdmission,
        lambda: ensemble.run_ensemble_sharded(8, 8, 2, [0.1], [0.1]),
        lambda: ensemble.run_ensemble_spatial(8, 8, 2, [0.1], [0.1], 1, 1),
        lambda: measure_strong_scaling(1, 8, 8, 2),
    ]
    for call in calls:
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            call()
    assert bench.main([]) == 1
    assert chaos_gate.main([]) == 1
    assert scli.main(["--selftest", "--mesh"]) == 1
    assert cli.main(["--mode", "dist2d", "--ensemble-cx", "0.1",
                     "--ensemble-cy", "0.1"]) == 1
    assert capsys.readouterr().err.count("CUDA") >= 3


def test_importing_dist_and_multihost_loads_no_jax():
    """The multi-process runtime (dist/) and the world bring-up import
    torch, never jax or the JAX package."""
    code = ("import sys; import heat2d_tpu_torch.dist, "
            "heat2d_tpu_torch.dist.cli, heat2d_tpu_torch.dist.harness, "
            "heat2d_tpu_torch.dist.mesh, heat2d_tpu_torch.parallel.multihost, "
            "heat2d_tpu_torch.mesh.scheduler; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]
    mods = {os.path.relpath(p, PKG).split(os.sep)[0]
            for p in _port_sources()}
    assert "dist" in mods


def test_dist_entry_points_raise_without_a_card(no_card, capsys):
    """The dist worker, its launcher legs and the slab route run on the card
    unless asked for the CPU; world slots refuse too."""
    from heat2d_tpu_torch.dist import cli as dcli
    from heat2d_tpu_torch.dist.exchange import run_process_slab
    from heat2d_tpu_torch.parallel.multihost import world_slots
    for call in (lambda: run_process_slab(8, 8, 2),
                 lambda: world_slots(2)):
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            call()
    for argv in ([], ["--selftest"], ["--soak", "--kill-host"]):
        assert dcli.main(argv) == 1
    assert capsys.readouterr().err.count("CUDA") == 3
    # ... and run when asked for the CPU.
    got, step = run_process_slab(8, 8, 2, device="cpu")
    assert step == 2 and got.shape == (8, 8)
    assert world_slots(2, "cpu")[1] == [0, 0]


def test_importing_resil_and_analysis_loads_no_jax():
    """The checkpoint manager and writer, the chaos points and every
    analysis module import torch and numpy only."""
    code = ("import sys; import heat2d_tpu_torch.resil, "
            "heat2d_tpu_torch.resil.manager, heat2d_tpu_torch.resil.writer, "
            "heat2d_tpu_torch.resil.chaos, heat2d_tpu_torch.analysis.lint, "
            "heat2d_tpu_torch.analysis.cli, heat2d_tpu_torch.analysis.locks, "
            "heat2d_tpu_torch.analysis.recompile, "
            "heat2d_tpu_torch.analysis.launch_pin, "
            "heat2d_tpu_torch.analysis.implicit_gate; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]
    mods = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {os.path.join("resil", "manager.py"),
            os.path.join("resil", "writer.py"),
            os.path.join("analysis", "lint.py"),
            os.path.join("analysis", "implicit_gate.py")} <= mods


def test_implicit_gate_raises_without_a_card(no_card, capsys):
    """The gate runs on the card unless asked for the CPU."""
    from heat2d_tpu_torch.analysis import implicit_gate
    assert implicit_gate.main([]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_importing_the_fleet_loads_no_jax():
    code = ("import sys; import heat2d_tpu_torch.fleet.cli, "
            "heat2d_tpu_torch.fleet.worker; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


def test_fleet_refuses_without_a_card(no_card, capsys):
    """The soak's oracle and its workers run on the card by default: no
    card, no soak (exit 1 naming CUDA), and a pool whose workers cannot
    reach the card stops at start instead of answering from the CPU."""
    from heat2d_tpu_torch.fleet import FleetServer
    from heat2d_tpu_torch.fleet import cli as fleet_cli
    from heat2d_tpu_torch.fleet.supervisor import WorkerStartError
    from heat2d_tpu_torch.obs import MetricsRegistry
    assert fleet_cli.main(["--soak", "1", "--workers", "1"]) == 1
    assert "CUDA" in capsys.readouterr().err
    if torch.cuda.device_count():
        return      # the worker subprocess would see the card
    fs = FleetServer(workers=1, registry=MetricsRegistry())
    with pytest.raises(WorkerStartError, match="before reporting ready"):
        fs.start()


def test_importing_load_loads_no_jax():
    code = ("import sys; import heat2d_tpu_torch.load, "
            "heat2d_tpu_torch.load.cli, heat2d_tpu_torch.load.runner, "
            "heat2d_tpu_torch.load.gate; "
            "print('jax' in sys.modules, 'heat2d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


def test_load_refuses_without_a_card(no_card, capsys):
    """``heat2d-tpu-torch-load`` serves on the card by default: without
    one every mode exits 1 naming CUDA before a target starts, and a
    serve target on ``cuda`` raises instead of serving from the CPU."""
    from heat2d_tpu_torch.load import cli as load_cli
    from heat2d_tpu_torch.load.runner import ServeTarget
    for argv in (["--selftest"],
                 ["--profile", "smoke", "--duration", "1"],
                 ["--profile", "smoke", "--target", "fleet",
                  "--workers", "1"]):
        assert load_cli.main(argv) == 1
        err = capsys.readouterr().err
        assert "CUDA" in err and "selftest: " not in err
    with pytest.raises(DeviceUnavailableError, match="CUDA"):
        ServeTarget()
