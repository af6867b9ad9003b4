"""The port's differentiable solve (``heat2d_tpu_torch/diff/adjoint.py``
and its prerequisites) against ``heat2d_tpu/diff`` on the CPU, on the same
inputs made with numpy from a seed.

Tolerances: the jnp-route primal within rtol 1e-5 / atol 1e-6 in float32
(XLA's CPU backend may contract multiply-adds, torch does not) and 1e-12
in float64; the band route (H6's plain version) against the JAX package's
band kernel in interpret mode within rtol 1e-5 / atol 1e-7, as the JAX
package holds its band primal; gradients against ``jax.grad`` of the JAX
package's solve within rtol 1e-10 in float64 and 1e-4 in float32. Within
the port: gradients against central finite differences within 1e-3
(float32) and 1e-6 (float64), and the checkpointed adjoint equal to the
full-storage one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu import vocab as jvocab
from heat2d_tpu.diff import adjoint as jadj
from heat2d_tpu.diff import vocab as jdvocab
from heat2d_tpu.models.engine import run_fixed_stacked as j_stacked
from heat2d_tpu.ops import stability as jstab
from heat2d_tpu.ops.init import inidat as j_inidat
from heat2d_tpu.ops.stencil import stencil_step as j_step
from heat2d_tpu_torch import vocab as tvocab
from heat2d_tpu_torch.diff import adjoint as tadj
from heat2d_tpu_torch.diff import vocab as tdvocab
from heat2d_tpu_torch.models import engine
from heat2d_tpu_torch.ops import _build
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops import stability as tstab
from heat2d_tpu_torch.ops.init import inidat
from heat2d_tpu_torch.ops.stencil import stencil_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u0(nx, ny, dtype=np.float32):
    u = np.asarray(j_inidat(nx, ny), dtype)
    return u / u.max()


def _rand(shape, seed, lo=None, hi=None, dtype=np.float32):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape) if lo is None else rs.uniform(lo, hi, shape)
    return np.asarray(x, dtype)


def _coefs(coeff, nx, ny, dtype):
    if coeff == "const":
        return np.asarray(0.1, dtype), np.asarray(0.12, dtype)
    return (_rand((nx, ny), 3, 0.05, 0.15, dtype),
            _rand((nx, ny), 4, 0.05, 0.15, dtype))


def _torch_grads(f, w, *args):
    """(output, (du, da, db)) of ``sum(w * f(u, a, b))`` by autograd."""
    ins = [torch.tensor(x, requires_grad=True) for x in args]
    out = f(*ins)
    grads = torch.autograd.grad(torch.sum(torch.as_tensor(w) * out), ins)
    return out.detach().numpy(), [g.numpy() for g in grads]


# --------------------------------------------------------------------- #
# vocabulary, schedule, spec
# --------------------------------------------------------------------- #

def test_vocabularies_equal_jax():
    assert tvocab.DIFF_METHODS == jvocab.DIFF_METHODS
    for name in ("COEFFS", "ADJOINTS", "METHODS", "TARGETS"):
        assert getattr(tdvocab, name) == getattr(jdvocab, name)
    assert (tstab.KAPPA_MIN, tstab.KAPPA_MAX) == (jstab.KAPPA_MIN,
                                                  jstab.KAPPA_MAX)


@pytest.mark.parametrize("steps,segment", [
    (16, None), (100, None), (12, 5), (5, 5), (3, 100), (0, None),
    (240, None), (13, 1)])
def test_segment_schedule_equals_jax(steps, segment):
    got = tadj.segment_schedule(steps, segment)
    assert got == jadj.segment_schedule(steps, segment)
    assert sum(got) == steps


@pytest.mark.parametrize("steps,segment", [(-1, None), (10, 0)])
def test_segment_schedule_rejects_as_jax(steps, segment):
    with pytest.raises(ValueError) as t:
        tadj.segment_schedule(steps, segment)
    with pytest.raises(ValueError) as j:
        jadj.segment_schedule(steps, segment)
    assert str(t.value) == str(j.value)


def test_spec_is_hashable_and_exposed():
    f = tadj.make_diff_solve(8, 9, 12, segment=5, device="cpu")
    assert isinstance(f.spec, tadj.DiffSpec)
    assert f.spec.schedule == (5, 5, 2)
    assert hash(f.spec) == hash(tadj.DiffSpec(**vars(f.spec)))
    assert f.spec == tadj.DiffSpec(**vars(jadj.make_diff_solve(
        8, 9, 12, segment=5).spec))


# --------------------------------------------------------------------- #
# primal and gradient against the JAX package
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("coeff", ["const", "var"])
def test_primal_and_grads_vs_jax(coeff, dtype):
    """One jax.vjp gives the JAX primal and its pullback of ``w``; the
    port's solve and its autograd gradient are held against both, for
    u0 and both coefficients (scalars or fields)."""
    nx, ny, steps = 10, 12, 14
    u0 = _u0(nx, ny, dtype)
    a, b = _coefs(coeff, nx, ny, dtype)
    w = _rand((nx, ny), 0, dtype=dtype)
    jf = jadj.make_diff_solve(nx, ny, steps, coeff=coeff)
    j_out, vjp = jax.vjp(jf, *map(jnp.asarray, (u0, a, b)))
    j_grads = vjp(jnp.asarray(w))
    out, grads = _torch_grads(tadj.make_diff_solve(
        nx, ny, steps, coeff=coeff, device="cpu"), w, u0, a, b)
    f32 = dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(j_out),
                               rtol=1e-5 if f32 else 1e-12,
                               atol=1e-6 if f32 else 1e-12)
    for g, jg in zip(grads, j_grads):
        assert g.dtype == dtype and g.shape == np.shape(jg)
        np.testing.assert_allclose(g, np.asarray(jg),
                                   rtol=1e-4 if f32 else 1e-10)


def test_band_primal_vs_jax_interpret():
    """The band route on the CPU (H6's plain version at B = 1) against the
    JAX package's band kernel in interpret mode."""
    nx, ny, steps = 24, 32, 10
    u0 = _u0(nx, ny)
    j = jadj.make_diff_solve(nx, ny, steps, method="band")
    assert j.spec.method == "band"
    want = np.asarray(j(jnp.asarray(u0), 0.1, 0.1))
    f = tadj.make_diff_solve(nx, ny, steps, method="band", device="cpu")
    assert f.spec.method == "band"
    got = f(torch.tensor(u0), 0.1, 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_band_grads_close_to_jnp_grads():
    """The band primal's checkpoints feed the per-step pullback: its
    gradient agrees with the jnp route's within f32 tolerance (the FMA
    step form differs by ulps), and the CPU runs H6's plain version."""
    nx, ny, steps = 24, 32, 12
    u0, w = _u0(nx, ny), _rand((nx, ny), 0)
    a, b = _coefs("const", nx, ny, np.float32)
    _, gb = _torch_grads(tadj.make_diff_solve(
        nx, ny, steps, method="band", segment=5, device="cpu"), w, u0, a, b)
    _, gj = _torch_grads(tadj.make_diff_solve(
        nx, ny, steps, method="jnp", segment=5, device="cpu"), w, u0, a, b)
    for x, y in zip(gb, gj):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)


def test_adi_grads_vs_jax():
    """``method="adi"``: the ADI step's autograd through the Thomas
    solves' implicit backward, against the JAX package's custom_vjp, in
    float64."""
    nx, ny, steps = 9, 11, 6
    u0 = _u0(nx, ny, np.float64)
    w = _rand((nx, ny), 0, dtype=np.float64)
    a, b = np.asarray(2.5), np.asarray(1.5)
    jf = jadj.make_diff_solve(nx, ny, steps, method="adi", segment=4)
    j_out, vjp = jax.vjp(jf, *map(jnp.asarray, (u0, a, b)))
    out, grads = _torch_grads(tadj.make_diff_solve(
        nx, ny, steps, method="adi", segment=4, device="cpu"), w, u0, a, b)
    np.testing.assert_allclose(out, np.asarray(j_out), rtol=1e-12,
                               atol=1e-12)
    for g, jg in zip(grads, vjp(jnp.asarray(w))):
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-10)


def test_f64_band_is_refused():
    f = tadj.make_diff_solve(24, 32, 4, method="band", device="cpu")
    with pytest.raises(ValueError, match="float32"):
        f(torch.tensor(_u0(24, 32, np.float64)), 0.1, 0.1)


# --------------------------------------------------------------------- #
# within the port: finite differences, checkpoint == full
# --------------------------------------------------------------------- #

def _fd(L, args, argnum, d, h):
    p, m = list(args), list(args)
    p[argnum] = args[argnum] + h * d
    m[argnum] = args[argnum] - h * d
    return (L(*p) - L(*m)) / (2 * h)


#: The JAX package's finite-difference cases (tests/test_diff.py): the
#: coefficient form, dtype, (a, b) as scalars or constant fields, and per
#: argument checked the direction's seed (None: the scalar 1) and step h.
FD_CASES = {
    "const-f32": ("const", np.float32, (0.1, 0.1),
                  {0: (1, 1e-2), 1: (None, 1e-3), 2: (None, 1e-3)}),
    "var-f32": ("var", np.float32, (0.08, 0.11), {1: (3, 1e-3),
                                                  2: (4, 1e-3)}),
    "const-f64": ("const", np.float64, (0.1, 0.1),
                  {i: (10 + i, 1e-6) for i in range(3)}),
    "var-f64": ("var", np.float64, (0.09, 0.12),
                {i: (10 + i, 1e-6) for i in range(3)}),
}


@pytest.mark.parametrize("case", list(FD_CASES))
def test_grad_parity_finite_differences(case):
    """Autograd against central differences along a unit direction, on
    the JAX package's inputs: rtol 1e-3 in float32, 1e-6 in float64."""
    coeff, dtype, (a, b), checks = FD_CASES[case]
    nx, ny, steps = (8, 9, 12) if case == "const-f32" else (
        (8, 9, 10) if case == "var-f32" else (8, 8, 10))
    f64 = dtype == np.float64
    f = tadj.make_diff_solve(nx, ny, steps, coeff=coeff, device="cpu")
    w = torch.tensor(_rand((nx, ny), 0, dtype=dtype))
    shape = () if coeff == "const" else (nx, ny)
    args = [torch.tensor(_u0(nx, ny, dtype)),
            torch.full(shape, a, dtype=w.dtype),
            torch.full(shape, b, dtype=w.dtype)]

    def L(u, a, b):
        return torch.sum(w * f(u, a, b))

    ins = [x.clone().requires_grad_() for x in args]
    grads = torch.autograd.grad(L(*ins), ins)
    for argnum, (seed, h) in checks.items():
        if seed is None:
            d = torch.ones((), dtype=w.dtype)
        else:
            d = torch.tensor(_rand(tuple(args[argnum].shape), seed,
                                   dtype=dtype))
            d = d / torch.sqrt(torch.sum(d * d))
        fd = float(_fd(L, args, argnum, d, h))
        np.testing.assert_allclose(float(torch.sum(grads[argnum] * d)), fd,
                                   rtol=1e-6 if f64 else 1e-3,
                                   atol=1e-12 if f64 else 0)


@pytest.mark.parametrize("segment", [None, 1, 5, 13])
@pytest.mark.parametrize("coeff", ["const", "var"])
def test_checkpoint_matches_full_bitwise(coeff, segment):
    nx, ny, steps = 10, 11, 13
    u0, w = _u0(nx, ny), _rand((nx, ny), 0)
    a, b = _coefs(coeff, nx, ny, np.float32)
    grads = {}
    for adjoint in ("checkpoint", "full"):
        f = tadj.make_diff_solve(nx, ny, steps, coeff=coeff,
                                 adjoint=adjoint, segment=segment,
                                 device="cpu")
        grads[adjoint] = _torch_grads(f, w, u0, a, b)
    (o_ck, g_ck), (o_full, g_full) = grads["checkpoint"], grads["full"]
    assert o_ck.tobytes() == o_full.tobytes()
    for x, y in zip(g_ck, g_full):
        assert x.tobytes() == y.tobytes()


def test_primal_bitwise_vs_step_loop():
    nx, ny, steps = 10, 12, 14
    u0 = torch.tensor(_u0(nx, ny))
    ref = u0
    for _ in range(steps):
        ref = stencil_step(ref, 0.1, 0.1, accum_dtype=None)
    for adjoint in ("checkpoint", "full"):
        f = tadj.make_diff_solve(nx, ny, steps, adjoint=adjoint,
                                 device="cpu")
        assert torch.equal(f(u0, 0.1, 0.1), ref)
    fv = tadj.make_diff_solve(nx, ny, steps, coeff="var", device="cpu")
    k = torch.full((nx, ny), 0.1)
    assert torch.equal(fv(u0, k, k), ref)


def test_zero_steps_identity_and_grad():
    nx, ny = 8, 8
    u0, w = _u0(nx, ny), _rand((nx, ny), 0)
    f = tadj.make_diff_solve(nx, ny, 0, device="cpu")
    out, (du, da, db) = _torch_grads(f, w, u0, np.float32(0.1),
                                     np.float32(0.1))
    assert out.tobytes() == u0.tobytes()
    assert du.tobytes() == w.tobytes()
    assert float(da) == 0.0 and float(db) == 0.0


def test_run_fixed_stacked_states_vs_jax():
    u0 = _u0(6, 7)
    tu, tstates = engine.run_fixed_stacked(
        lambda v: stencil_step(v, 0.1, 0.1), torch.tensor(u0), 5)
    ju, jstates = j_stacked(lambda v: j_step(v, 0.1, 0.1),
                            jnp.asarray(u0), 5)
    assert tuple(tstates.shape) == (5, 6, 7)
    assert tstates[0].numpy().tobytes() == u0.tobytes()
    ref, _ = engine.run_fixed(lambda v: stencil_step(v, 0.1, 0.1),
                              torch.tensor(u0), 5)
    assert torch.equal(tu, ref)
    np.testing.assert_allclose(tstates.numpy(), np.asarray(jstates),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-7)
    _, empty = engine.run_fixed_stacked(lambda v: v, torch.tensor(u0), 0)
    assert tuple(empty.shape) == (0, 6, 7)


def test_project_stable_equals_jax():
    k = _rand((9, 11), 5, -0.1, 0.4)
    got = tstab.project_stable(torch.tensor(k)).numpy()
    assert got.tobytes() == np.asarray(jstab.project_stable(
        jnp.asarray(k))).tobytes()


# --------------------------------------------------------------------- #
# validation and the auto route
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("args,kw", [
    ((2, 8, 4), {}),
    ((8, 8, 4), {"coeff": "nope"}),
    ((8, 8, 4), {"adjoint": "nope"}),
    ((8, 8, 4), {"method": "pallas"}),
    ((8, 8, 4), {"coeff": "var", "method": "band"}),
    ((8, 8, 4), {"coeff": "var", "method": "adi"}),
    ((24, 32, 8), {"adjoint": "full", "method": "band"}),
])
def test_make_diff_solve_refuses_as_jax(args, kw):
    with pytest.raises(ValueError) as t:
        tadj.make_diff_solve(*args, device="cpu", **kw)
    with pytest.raises(ValueError) as j:
        jadj.make_diff_solve(*args, **kw)
    assert str(t.value) == str(j.value)


def test_solve_validates_its_inputs():
    f = tadj.make_diff_solve(8, 8, 4, device="cpu")
    with pytest.raises(ValueError, match=r"u0 must be \(8, 8\)"):
        f(torch.zeros((4, 4)), 0.1, 0.1)
    fv = tadj.make_diff_solve(8, 8, 4, coeff="var", device="cpu")
    with pytest.raises(ValueError, match="coefficient shape"):
        fv(torch.zeros((8, 8)), 0.1, 0.1)
    assert tadj.make_diff_solve(24, 32, 8, adjoint="full",
                                device="cpu").spec.method == "jnp"


@pytest.mark.parametrize("shape,want", [((4096, 4096), "band"),
                                        ((2048, 2048), "band"),
                                        ((640, 1024), "jnp")])
def test_auto_takes_band_on_a_card_past_the_resident_gate(monkeypatch,
                                                         shape, want):
    """``auto`` resolves as the JAX package's does on a TPU: band on an
    accelerator for a grid the resident route refuses (here the H100's
    gate, evaluated as the CPU evaluates it), jnp elsewhere; on the CPU
    always jnp."""
    cuda = torch.device("cuda")
    gate = cs.fits_resident
    monkeypatch.setattr(cs, "fits_resident",
                        lambda s, device: gate(s, "cpu"))
    assert tadj._resolve_method("auto", *shape, "const", "checkpoint",
                                cuda) == want
    assert tadj._resolve_method("auto", *shape, "const", "checkpoint",
                                torch.device("cpu")) == "jnp"
    assert tadj._resolve_method("auto", *shape, "const", "full",
                                cuda) == "jnp"


# --------------------------------------------------------------------- #
# zero cost when unused
# --------------------------------------------------------------------- #

def test_solver_and_batch_runner_unchanged_by_diff():
    """The counterpart of the JAX package's jaxpr pins: the forward
    solver's and the ensemble batch runner's results and launch counts
    are the same before and after a differentiable solve is built and
    differentiated (on the CPU the plain versions count no launch)."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.ensemble import batch_runner
    from heat2d_tpu_torch.models.solver import Heat2DSolver

    def forward():
        _build.reset_launch_counts()
        u = Heat2DSolver(HeatConfig(nxprob=12, nyprob=12, steps=8,
                                    mode="pallas"),
                         device="cpu").run(timed=False).u
        run = batch_runner(16, 16, 6, "band", device="cpu")
        batch = torch.tensor(np.stack([_u0(16, 16)] * 2))
        ens = run(batch, torch.tensor([0.1, 0.2]), torch.tensor([0.1, 0.05]))
        return (np.asarray(u).tobytes(), ens.numpy().tobytes(),
                _build.launch_counts("stencil"),
                _build.launch_counts("ensemble"))

    before = forward()
    f = tadj.make_diff_solve(12, 12, 8, method="band", device="cpu")
    u = torch.tensor(_u0(12, 12), requires_grad=True)
    torch.sum(f(u, 0.1, 0.1)).backward()
    assert forward() == before


def test_bench_torch_quick_on_the_cpu():
    """``BENCH_QUICK=1 python bench_torch.py --device cpu`` prints
    bench.py's record keys and exits 0."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, BENCH_QUICK="1")
    r = subprocess.run([sys.executable, "bench_torch.py", "--device",
                        "cpu"], cwd=repo, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "method",
                "end_to_end_s", "time_to_solution"):
        assert key in rec
    assert rec["unit"] == "Mcells/s" and rec["kind"] == "bench"
    assert rec["metric"].startswith("Mcells/s/chip 1024x1024")
    assert rec["device"]["platform"] == "cpu"
    assert rec["time_to_solution"]["summary"]["adi_matched_accuracy"]
    assert "pct_of_calibrated_bound" not in rec


# --------------------------------------------------------------------- #
# spans and their counts (utils/profiling.phase)
# --------------------------------------------------------------------- #

DIFF_SPANS = ("diff.forward", "diff.recompute", "diff.pullback")


def _diff_counts():
    from heat2d_tpu_torch.obs import get_registry
    spans = {dict(k).get("span"): v for k, v in get_registry()
             .find_counters("trace_spans_total").items()}
    return {n: spans.get(n, 0.0) for n in DIFF_SPANS}


def _grads_counted(f, armed: bool):
    """(grads, counts added) of one gradient of ``sum(u_T)``, under a
    CPU profiler (the hook armed) or not."""
    from torch.profiler import ProfilerActivity, profile
    before = _diff_counts()
    ins = [torch.tensor(_u0(12, 10), requires_grad=True),
           torch.tensor(0.1, requires_grad=True),
           torch.tensor(0.12, requires_grad=True)]

    def run():
        return torch.autograd.grad(torch.sum(f(*ins)), ins)
    if armed:
        with profile(activities=[ProfilerActivity.CPU]):
            grads = run()
    else:
        grads = run()
    after = _diff_counts()
    return grads, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("method,adjoint,segment", [
    ("jnp", "checkpoint", None), ("band", "checkpoint", 4),
    ("jnp", "full", 5)])
def test_spans_and_counters_count_segments_and_steps_when_armed(
        method, adjoint, segment):
    f = tadj.make_diff_solve(12, 10, 23, adjoint=adjoint, segment=segment,
                             method=method, device="cpu")
    sched = f.spec.schedule
    _, off = _grads_counted(f, armed=False)
    assert all(v == 0 for v in off.values()), off
    _, on = _grads_counted(f, armed=True)
    ck = adjoint == "checkpoint"
    # one pullback entry a segment, and the segments cover the steps
    assert sum(sched) == 23
    assert on == {"diff.forward": len(sched) if ck else 1,
                  "diff.recompute": len(sched) if ck else 0,
                  "diff.pullback": len(sched)}


@pytest.mark.parametrize("method", ["jnp", "band"])
def test_gradient_bitwise_the_same_armed_and_not(method):
    f = tadj.make_diff_solve(12, 10, 23, method=method, device="cpu")
    off, _ = _grads_counted(f, armed=False)
    on, _ = _grads_counted(f, armed=True)
    assert all(torch.equal(a, b) for a, b in zip(off, on))

