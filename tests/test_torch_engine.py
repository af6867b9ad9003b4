"""The port's time-stepping loops against the JAX engine's: the same
plain step on the same grid must give the same steps_done, schedule
included (early exit only at checked chunks, the unchecked
``steps % interval`` remainder of the fused and chunked loops).

The step is the float64-accumulation golden step, bitwise equal across
the stacks (tests/test_torch_stencil.py), so both loops see the same
residuals and the comparison tests the schedules alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu.models import engine as jeng
from heat2d_tpu.ops import inidat as jinidat
from heat2d_tpu.ops.stencil import residual_sq as jres
from heat2d_tpu.ops.stencil import stencil_step as jstep
from heat2d_tpu_torch.models import engine as teng
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops.stencil import residual_sq as tres
from heat2d_tpu_torch.ops.stencil import stencil_step as tstep

NX = NY = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _js(u):
    return jstep(u, 0.1, 0.1, jnp.float64)


def _jmulti(u, n):
    return jax.lax.fori_loop(0, n, lambda _, v: _js(v), u)


def _jr(a, b):
    return jres(a, b, jnp.float64)


def _ts(u):
    return tstep(u, 0.1, 0.1, torch.float64)


def _tmulti(u, n):
    for _ in range(n):
        u = _ts(u)
    return u


def _tr(a, b):
    return tres(a, b, torch.float64)


def _mid_sensitivity():
    """A threshold the residual crosses at step 30 of the 10x10 run, far
    from any checked residual's rounding."""
    t = torch.from_numpy(np.array(jinidat(NX, NY)))
    res = []
    for _ in range(31):
        t2 = _ts(t)
        res.append(float(_tr(t2, t)))
        t = t2
    return float(np.sqrt(res[29] * res[30]))


SENS = {"never": 0.0, "mid": _mid_sensitivity()}


def _runs(steps, interval, sens):
    u = np.asarray(jinidat(NX, NY))
    uj, ut = jnp.asarray(u), torch.from_numpy(u.copy())
    out = {}
    _, k = jax.jit(lambda v: jeng.run_convergence(
        _js, _jr, v, steps, interval, sens))(uj)
    out["run_convergence"] = (int(k), teng.run_convergence(
        _ts, _tr, ut, steps, interval, sens)[1])
    _, k = jax.jit(lambda v: jeng.run_convergence_chunked(
        _jmulti, _js, _jr, v, steps, interval, sens))(uj)
    out["run_convergence_chunked"] = (int(k), teng.run_convergence_chunked(
        _tmulti, _ts, _tr, ut, steps, interval, sens)[1])

    def jchunk(v, n):
        p = _jmulti(v, n - 1)
        w = _js(p)
        return w, _jr(w, p)

    _, k = jax.jit(lambda v: jeng.run_convergence_fused(
        jchunk, _jmulti, v, steps, interval, sens))(uj)

    def tchunk(v, n):
        p = _tmulti(v, n - 1)
        w = _ts(p)
        return w, _tr(w, p)

    out["run_convergence_fused"] = (int(k), teng.run_convergence_fused(
        tchunk, _tmulti, ut, steps, interval, sens)[1])
    return out


@pytest.mark.parametrize("sens", list(SENS))
@pytest.mark.parametrize("interval", [1, 7, 20])
@pytest.mark.parametrize("steps", [0, 19, 20, 57])
def test_steps_done_matches_jax(steps, interval, sens):
    for loop, (want, got) in _runs(steps, interval, SENS[sens]).items():
        assert got == want, (loop, steps, interval, sens)


@pytest.mark.parametrize("steps", [0, 19, 57])
def test_run_fixed_matches_jax(steps):
    u = np.asarray(jinidat(NX, NY))
    uj, kj = jax.jit(lambda v: jeng.run_fixed(_js, v, steps))(jnp.asarray(u))
    ut, kt = teng.run_fixed(_ts, torch.from_numpy(u.copy()), steps)
    assert kt == int(kj) == steps
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))


@pytest.mark.parametrize("steps,interval", [(57, 7), (40, 20), (19, 20)])
def test_tiled_fused_schedule_matches_jax_chunked(steps, interval):
    """The kernel route's fused schedule (H2 sweeps, then an H3 sweep of
    depth ``n % T or T`` per chunk, plain versions here) stops where the
    JAX chunked loop stops, and the tap fires once per host read."""
    u = np.asarray(jinidat(24, 20))
    sens = 3.0e2
    _, want = jax.jit(lambda v: jeng.run_convergence_chunked(
        lambda w, n: ps_multi(w, n), lambda w: jstep(w, 0.1, 0.1),
        jres, v, steps, interval, sens))(jnp.asarray(u))

    def chunk_resid(v, n):
        d = n % 4 or 4
        v = cs.tiled_chunk(v, n - d, 0.1, 0.1, cs.FORM_LITERAL, 4)
        return cs.tile_multi_resid(v, d, 0.1, 0.1, cs.FORM_LITERAL, 4)

    reads = []
    _, got = teng.run_convergence_fused(
        chunk_resid,
        lambda v, n: cs.tiled_chunk(v, n, 0.1, 0.1, cs.FORM_LITERAL, 4),
        torch.from_numpy(u.copy()), steps, interval, sens,
        tap=lambda k, r: reads.append(k))
    assert got == int(want)
    every = min(interval, steps)
    assert reads == [every * (i + 1) for i in range(len(reads))]
    assert 0 < len(reads) <= steps // every


def ps_multi(u, n):
    return jax.lax.fori_loop(0, n, lambda _, v: jstep(v, 0.1, 0.1), u)
