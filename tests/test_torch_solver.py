"""Heat2DSolver(device="cpu") in serial and pallas modes against the JAX
solver, on both kernel routes (resident, and streamed by a monkeypatched
``fits_resident``).

Tolerances: serial float32 and the FMA-form kernel route agree with JAX
within rtol=1e-6, atol=1e-4 over 20 steps (XLA contracts FMAs, torch
eager does not); ~10k-step convergence runs within rtol=1e-3, atol=1e-3,
as tests/test_pallas.py holds JAX's own pallas mode against serial.
``bitwise_parity`` runs are bitwise equal to the port's serial mode."""

import numpy as np
import pytest
import torch

from heat2d_tpu.config import HeatConfig as JConfig
from heat2d_tpu.models.solver import Heat2DSolver as JSolver
from heat2d_tpu_torch.config import ConfigError, HeatConfig
from heat2d_tpu_torch.models.solver import Heat2DSolver
from heat2d_tpu_torch.ops import cuda_stencil as cs

TOL = dict(rtol=1e-6, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["resident", "streamed"])
def route(request, monkeypatch):
    if request.param == "streamed":
        monkeypatch.setattr(cs, "fits_resident", lambda shape, dev: False)
    return request.param


def _both(**kw):
    got = Heat2DSolver(HeatConfig(**kw), device="cpu").run(timed=False)
    want = JSolver(JConfig(**kw)).run(timed=False)
    return got, want


@pytest.mark.parametrize("mode", ["serial", "pallas"])
def test_fixed_steps_vs_jax(mode, route):
    got, want = _both(nxprob=64, nyprob=128, steps=20, mode=mode)
    assert got.steps_done == want.steps_done == 20
    np.testing.assert_allclose(got.u, want.u, **TOL)
    if mode == "pallas":
        assert got.route == route


def test_serial_f64_accum_bitwise_vs_jax():
    got, want = _both(nxprob=16, nyprob=24, steps=57, accum_dtype="float64")
    np.testing.assert_array_equal(got.u, want.u)


@pytest.mark.parametrize("mode", ["serial", "pallas"])
def test_convergence_vs_jax(mode, route):
    kw = dict(nxprob=32, nyprob=128, steps=100000, mode=mode,
              convergence=True, interval=20, sensitivity=0.5)
    got, want = _both(**kw)
    assert got.steps_done == want.steps_done < 100000
    np.testing.assert_allclose(got.u, want.u, rtol=1e-3, atol=1e-3)
    assert got.residual_reads == got.steps_done // 20
    if mode == "pallas":
        assert got.route == ("resident" if route == "resident"
                             else "streamed-fused")


@pytest.mark.parametrize("convergence", [False, True])
def test_bitwise_parity_equals_serial(convergence, route):
    kw = dict(nxprob=40, nyprob=56, steps=57, convergence=convergence,
              interval=7, sensitivity=1e3)
    serial = Heat2DSolver(HeatConfig(**kw), device="cpu").run(timed=False)
    par = Heat2DSolver(HeatConfig(mode="pallas", bitwise_parity=True, **kw),
                       device="cpu").run(timed=False)
    assert par.steps_done == serial.steps_done
    np.testing.assert_array_equal(par.u, serial.u)
    assert par.route == route


def test_timed_run_and_record():
    r = Heat2DSolver(HeatConfig(mode="pallas"), device="cpu").run()
    assert r.elapsed > 0 and r.warmup_s is not None
    rec = r.to_record()
    want = JSolver(JConfig()).run().to_record()
    for key in ("config", "steps_done", "elapsed_s", "mcells_per_s",
                "warmup_s", "schema", "kind", "timestamp", "device",
                "world"):
        assert key in rec and key in want
    assert rec["config"] == want["config"] | {"mode": "pallas"}
    assert rec["device"]["platform"] == "cpu"


@pytest.mark.parametrize("kw,match", [
    (dict(mode="dist2d", gridx=2, gridy=2, method="adi", cx=8.0, cy=8.0),
     "single-device modes"),
    (dict(method="adi", problem="reactdiff"), "does not support method"),
    (dict(problem="heat9", mode="pallas"), "runs mode 'serial'"),
])
def test_unported_combinations_name_their_slice(kw, match):
    """What the solver refuses: the combinations the JAX package refuses
    too (the distributed modes run since slice 4; an implicit method on a
    mesh is still refused)."""
    with pytest.raises(ConfigError, match=match):
        Heat2DSolver(HeatConfig(**kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(method="adi", cx=8.0, cy=6.0),
    dict(method="adi", cx=8.0, cy=6.0, mode="pallas"),
    dict(method="mg", cx=8.0, cy=6.0),
    dict(problem="heat9"),
    dict(problem="reactdiff", convergence=True, interval=7,
         sensitivity=1e3),
])
def test_implicit_methods_and_families_vs_jax(kw):
    """The combinations this port once refused run like the JAX solver
    (within rtol 1e-5 at 24 steps: ADI's roundoff is ~c eps per step)."""
    got, want = _both(nxprob=24, nyprob=40, steps=24, **kw)
    assert got.steps_done == want.steps_done
    np.testing.assert_allclose(got.u, want.u, rtol=1e-5, atol=1e-4)
