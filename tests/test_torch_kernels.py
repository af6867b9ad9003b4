"""Each CUDA kernel's plain PyTorch version (what its wrapper runs on a
CPU tensor) against the JAX kernel it replaces, run as tests/test_pallas.py
runs it: Pallas in interpret mode on the CPU.

H4 resident <- multi_step_vmem (A); H1 step <- band_step (B);
H2 tile_multi <- band_multi_step / band_chunk (C, C2);
H3 tile_multi_resid <- stencil_step x nsub + residual_sq (C2R's result).

Tolerance, both step forms: rtol=1e-6, atol=1e-4 on the inidat grids
(values up to ~4e6): XLA's CPU backend may contract the step's
multiply-adds into FMAs, torch eager rounds each operation. Residuals:
rtol=2e-3, because each delta of the last step pair is the difference of
two nearly equal f32 values, so an ulp of the grid is ~1e-3 of a delta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu.ops import inidat as jinidat
from heat2d_tpu.ops import pallas_stencil as ps
from heat2d_tpu.ops.stencil import residual_sq, stencil_step
from heat2d_tpu_torch.ops import cuda_stencil as cs

FORMS = {"fma": (cs.FORM_FMA, ps._step_value),
         "literal": (cs.FORM_LITERAL, ps._step_value_literal)}
TOL = dict(rtol=1e-6, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(shape, rng=None):
    """The same grid for both stacks: inidat, plus seeded noise when an
    rng is given (so held boundary values are not all zero)."""
    u = np.asarray(jinidat(*shape))
    if rng is not None:
        u = u + rng.random(shape, dtype=np.float32) * 1000
    return jnp.asarray(u), torch.from_numpy(u.copy())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(16, 16), (32, 128)])
def test_resident_plain_vs_multi_step_vmem(shape, form, rng):
    tf, jf = FORMS[form]
    uj, ut = _pair(shape, rng)
    want = jax.jit(lambda u: ps.multi_step_vmem(u, 5, 0.1, 0.1,
                                                step=jf))(uj)
    got = cs.resident(ut, 5, 0.1, 0.1, tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cs.resident(ut, 0, 0.1, 0.1, tf) is ut


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape,bm", [((32, 128), 8), ((64, 256), None)])
def test_step_plain_vs_band_step(shape, bm, form, rng):
    tf, jf = FORMS[form]
    uj, ut = _pair(shape, rng)
    want = jax.jit(lambda u: ps.band_step(u, 0.1, 0.1, bm=bm, step=jf))(uj)
    got = cs.step(ut, 0.1, 0.1, tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tsteps", [1, 2, 3, 7])
def test_tile_multi_plain_vs_band_multi_step(tsteps, form):
    tf, jf = FORMS[form]
    uj, ut = _pair((64, 128))
    want = jax.jit(lambda u: ps.band_multi_step(u, tsteps, 0.1, 0.1, bm=16,
                                                step=jf))(uj)
    got = cs.tile_multi(ut, tsteps, 0.1, 0.1, tf, tsteps=tsteps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [1, 7, 8, 9, 20])
def test_tiled_chunk_vs_band_chunk(n, form):
    tf, jf = FORMS[form]
    uj, ut = _pair((64, 128))
    want = jax.jit(lambda u: ps.band_chunk(u, n, 0.1, 0.1, tsteps=4, bm=16,
                                           step=jf))(uj)
    got = cs.tiled_chunk(ut, n, 0.1, 0.1, tf, tsteps=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nsub", [1, 3, 8])
def test_tile_multi_resid_plain_vs_steps_and_residual(nsub, form):
    tf, _ = FORMS[form]
    uj, ut = _pair((48, 64))
    prev = uj
    for _ in range(nsub - 1):
        prev = stencil_step(prev, 0.1, 0.1)
    last = stencil_step(prev, 0.1, 0.1)
    got, r = cs.tile_multi_resid(ut, nsub, 0.1, 0.1, tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(last), **TOL)
    assert float(r) == pytest.approx(float(residual_sq(last, prev)),
                                     rel=2e-3)


def test_wrappers_reject_bad_depth_and_dtype():
    u = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        cs.tile_multi(u, 9, 0.1, 0.1)
    with pytest.raises(ValueError):
        cs.tile_multi_resid(u, 0, 0.1, 0.1)
    with pytest.raises(ValueError):
        cs.step(u.double(), 0.1, 0.1)


def test_plain_versions_count_no_launches():
    cs.reset_launch_counts()
    u = torch.zeros(12, 12)
    cs.step(u, 0.1, 0.1)
    cs.tiled_chunk(u, 9, 0.1, 0.1)
    cs.tile_multi_resid(u, 2, 0.1, 0.1)
    cs.resident(u, 3, 0.1, 0.1)
    assert set(cs.launch_counts().values()) == {0}
