"""The port's golden model (ops/init.py, ops/stencil.py) against the JAX
package's on the same numpy inputs, and against tests/c_oracle.c.

Tolerances: float32 results agree within rtol=1e-6, atol=1e-4 over up to
20 steps (XLA's CPU backend contracts multiply-adds into FMAs,
docs/DISTRIBUTED.md:87-89, and torch eager does not); the float64
accumulation path is bitwise, against JAX under x64 and against the C
oracle built with -ffp-contract=off."""

import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu.ops import init as jinit
from heat2d_tpu.ops import stencil as jst
from heat2d_tpu_torch.ops import init as tinit
from heat2d_tpu_torch.ops import stencil as tst

CC = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("nx,ny", [(10, 10), (640, 1024), (37, 53)])
def test_inidat_bitwise(nx, ny):
    got = tinit.inidat(nx, ny).numpy()
    want = np.asarray(jinit.inidat(nx, ny))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("off", [(0, 0), (3, 5), (16, 32)])
def test_inidat_block_bitwise(off):
    got = tinit.inidat_block((8, 12), 40, 60, *off).numpy()
    want = np.asarray(jinit.inidat_block((8, 12), 40, 60, *off))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [1, 7, 20])
@pytest.mark.parametrize("cx,cy", [(0.1, 0.1), (0.15, 0.05)])
def test_stencil_step_f32(steps, cx, cy):
    u0 = np.asarray(jinit.inidat(32, 48))
    uj, ut = jnp.asarray(u0), _t(u0)
    for _ in range(steps):
        uj = jst.stencil_step(uj, cx, cy)
        ut = tst.stencil_step(ut, cx, cy)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj),
                               rtol=1e-6, atol=1e-4)


def test_stencil_step_f64_accum_bitwise_vs_jax(rng):
    u = rng.random((24, 40), dtype=np.float32) * 100
    uj, ut = jnp.asarray(u), _t(u)
    for _ in range(15):
        uj = jst.stencil_step(uj, 0.1, 0.1, jnp.float64)
        ut = tst.stencil_step(ut, 0.1, 0.1, torch.float64)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))


def test_stencil_step_padded(rng):
    p = rng.random((10, 14), dtype=np.float32)
    got = tst.stencil_step_padded(_t(p), 0.1, 0.2, torch.float64).numpy()
    want = np.asarray(jst.stencil_step_padded(jnp.asarray(p), 0.1, 0.2,
                                              jnp.float64))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("accum", ["float32", "float64"])
def test_residual_sq(rng, accum):
    a = rng.random((30, 50), dtype=np.float32)
    b = a + rng.random((30, 50), dtype=np.float32) * 1e-2
    got = float(tst.residual_sq(_t(a), _t(b), getattr(torch, accum)))
    want = float(jst.residual_sq(jnp.asarray(a), jnp.asarray(b),
                                 getattr(jnp, accum)))
    # Sums taken in another order: a few ulp of the accumulation dtype.
    rtol = 1e-5 if accum == "float32" else 1e-12
    assert got == pytest.approx(want, rel=rtol)


@pytest.fixture(scope="module")
def c_oracle(tmp_path_factory):
    if CC is None:
        pytest.skip("no C compiler")
    d = tmp_path_factory.mktemp("c_oracle_torch")
    exe = d / "c_oracle"
    src = __file__.replace("test_torch_stencil.py", "c_oracle.c")
    subprocess.run([CC, "-O2", "-ffp-contract=off", "-o", str(exe), src],
                   check=True)

    def run(nx, ny, steps, cx=0.1, cy=0.1):
        out = d / f"out_{nx}x{ny}x{steps}_{cx}_{cy}.bin"
        subprocess.run([str(exe), str(nx), str(ny), str(steps), str(out),
                        repr(cx), repr(cy)], check=True)
        return np.fromfile(out, dtype="<f4").reshape(nx, ny)

    return run


@pytest.mark.parametrize("nx,ny,steps,cx,cy", [(10, 10, 100, 0.1, 0.1),
                                               (12, 18, 80, 0.15, 0.05)])
def test_f64_accum_bitwise_vs_c_oracle_and_jax(c_oracle, nx, ny, steps,
                                               cx, cy):
    ut = tinit.inidat(nx, ny)
    uj = jinit.inidat(nx, ny)
    for _ in range(steps):
        ut = tst.stencil_step(ut, cx, cy, torch.float64)
        uj = jst.stencil_step(uj, cx, cy, jnp.float64)
    np.testing.assert_array_equal(ut.numpy(), c_oracle(nx, ny, steps, cx, cy))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
