"""The port's inverse problems (``heat2d_tpu_torch/diff/inverse.py``,
``serving.py``, ``cli.py``), the server's inverse lane and the satellite
modules (``io.binary`` field files, ``resil.snapshot``, the record kind)
against ``heat2d_tpu`` on the CPU, on the same inputs made with numpy from
a seed.

Tolerances: the fixtures, the projection, the request hashes and the
field files are equal bit for bit (byte for byte for files); the loss and
its gradient against the JAX package's ``value_and_grad`` within rtol
1e-5 and 1e-4 (float32; XLA's CPU backend may contract multiply-adds and
sums in another order).
"""

import itertools
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu.diff import inverse as jinv
from heat2d_tpu.diff import serving as jserving
from heat2d_tpu.io import binary as jbin
from heat2d_tpu_torch.diff.adjoint import make_diff_solve
from heat2d_tpu_torch.diff.inverse import (InverseProblem, adam_minimize,
                                           loss_grad_runner,
                                           observation_mask,
                                           synthetic_diffusivity,
                                           unit_reference_init)
from heat2d_tpu_torch.diff.serving import InverseEngine, InverseRequest
from heat2d_tpu_torch.io import binary as tbin
from heat2d_tpu_torch.io.binary import CheckpointCorruptError
from heat2d_tpu_torch.obs import MetricsRegistry
from heat2d_tpu_torch.resil import chaos
from heat2d_tpu_torch.resil.retry import RetryPolicy
from heat2d_tpu_torch.resil.snapshot import snapshot_shards, snapshot_state
from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest
from heat2d_tpu_torch.serve.server import SolveServer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _observed(nx=12, ny=12, steps=16, every=1):
    """(true_k, u0, mask, values): a known diffusivity field and the
    final-state observations of its forward solve."""
    true_k = synthetic_diffusivity(nx, ny)
    u0 = unit_reference_init(nx, ny)
    k = torch.tensor(true_k)
    u = make_diff_solve(nx, ny, steps, coeff="var", device="cpu")(
        torch.tensor(u0), k, k)
    return true_k, u0, observation_mask(nx, ny, every=every), u.numpy()


def _server(**kw):
    return SolveServer(max_delay=0.01, device="cpu", **kw)


# --------------------------------------------------------------------- #
# fixtures and requests against the JAX package
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("nx,ny", [(12, 12), (9, 17)])
def test_fixtures_equal_jax(nx, ny):
    assert synthetic_diffusivity(nx, ny).tobytes() == \
        jinv.synthetic_diffusivity(nx, ny).tobytes()
    assert unit_reference_init(nx, ny).tobytes() == \
        jinv.unit_reference_init(nx, ny).tobytes()
    for every in (1, 3):
        assert np.array_equal(observation_mask(nx, ny, every),
                              jinv.observation_mask(nx, ny, every))


#: request fields beyond the observations: the defaults, target init with
#: its coefficients, a tolerance, a segment and a regularization weight
REQUEST_CASES = [
    {},
    {"target": "init", "cx": 0.05, "cy": 0.2, "iterations": 7},
    {"tol": 1e-6, "segment": 4, "reg": 0.01, "lr": 0.03},
    {"adjoint": "full", "iterations": 3},
]


@pytest.mark.parametrize("kw", REQUEST_CASES)
def test_request_hash_and_signature_equal_jax(kw):
    _, _, mask, values = _observed(every=2)
    t = InverseRequest.from_fields(12, 12, 16, mask, values, **kw)
    j = jserving.InverseRequest.from_fields(12, 12, 16, mask, values, **kw)
    assert t.spec() == j.spec()
    assert t.content_hash() == j.content_hash()
    assert t.signature() == j.signature()
    d = {k: v for k, v in j.spec().items() if k != "kind"}
    assert InverseRequest.from_dict(d).content_hash() == j.content_hash()


def test_request_roundtrip_signature_and_sensitivity():
    _, _, mask, values = _observed()
    req = InverseRequest.from_fields(12, 12, 16, mask, values,
                                     iterations=50, lr=0.02)
    np.testing.assert_array_equal(req.mask(), mask)
    np.testing.assert_array_equal(req.values()[mask], values[mask])
    h = req.content_hash()
    bumped = np.array(values)
    i, j = np.argwhere(mask)[0]
    bumped[i, j] += 1e-3
    assert InverseRequest.from_fields(12, 12, 16, mask, bumped,
                                      iterations=50,
                                      lr=0.02).content_hash() != h
    assert InverseRequest.from_fields(12, 12, 16, mask, values,
                                      iterations=50,
                                      lr=0.03).content_hash() != h
    sol = SolveRequest(nx=12, ny=12, steps=16)
    assert req.signature() != sol.signature()
    assert req.signature()[0] == "inverse"
    assert req.request_kind == "inverse"


@pytest.mark.parametrize("bad", [
    {"target": "nope"}, {"iterations": 0}, {"lr": 0.0}, {"tol": -1.0},
    {"adjoint": "nope"}, {"segment": 0}, {"dtype": "float64"},
    {"obs_indices": (), "obs_values": ()},
    {"obs_indices": (10_000,), "obs_values": (1.0,)},
    {"obs_indices": (5, 5), "obs_values": (1.0, 2.0)},
    {"nx": 2},
])
def test_request_validation_rejects_as_jax(bad):
    base = {"nx": 12, "ny": 12, "steps": 16, "obs_indices": (5, 7),
            "obs_values": (1.0, 2.0)}
    with pytest.raises(Rejected) as t:
        InverseRequest(**{**base, **bad}).validate()
    with pytest.raises(Exception) as j:
        jserving.InverseRequest(**{**base, **bad}).validate()
    assert (t.value.code, t.value.message) == (j.value.code,
                                               j.value.message)
    with pytest.raises(Rejected):
        InverseRequest.from_dict({**base, "bogus": 1})


# --------------------------------------------------------------------- #
# the loss, the optimizer, the problem
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("target", ["init", "diffusivity"])
def test_loss_and_grad_vs_jax(target):
    """The memoized runner's (loss, grad) against the JAX package's
    jitted ``value_and_grad`` on the same problem and parameters."""
    nx, ny, steps = 10, 12, 9
    true_k, u0, mask, values = _observed(nx, ny, steps, every=2)
    kw = dict(nx=nx, ny=ny, steps=steps, target=target, obs_mask=mask,
              obs_values=values, cx=0.1, cy=0.12, reg=0.01,
              u0=u0 if target == "diffusivity" else None)
    params = (np.full((nx, ny), 0.09, np.float32) if target == "diffusivity"
              else np.asarray(0.9 * u0, np.float32))
    jl, jg = jinv.InverseProblem(**kw).value_and_grad()(jnp.asarray(params))
    tl, tg = InverseProblem(**kw, device="cpu").value_and_grad()(
        torch.tensor(params))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4)


def test_same_signature_problems_share_one_runner():
    _, u0, mask, values = _observed()
    kw = dict(nx=12, ny=12, steps=16, target="diffusivity", obs_mask=mask,
              u0=u0, device="cpu")
    va = InverseProblem(obs_values=values, **kw).value_and_grad()
    vb = InverseProblem(obs_values=np.array(values) + 0.01,
                        **kw).value_and_grad()
    assert va.func is vb.func
    assert loss_grad_runner(12, 12, 16, "diffusivity", "checkpoint", None,
                            "auto", False, "cpu") is va.func
    p = torch.full((12, 12), 0.1)
    assert float(va(p)[0]) != float(vb(p)[0])


def test_recover_diffusivity_below_threshold():
    true_k, u0, mask, values = _observed()
    prob = InverseProblem(nx=12, ny=12, steps=16, target="diffusivity",
                          obs_mask=mask, obs_values=values, u0=u0,
                          device="cpu")
    reg = MetricsRegistry()
    sol = prob.solve(iterations=250, lr=0.02, tol=1e-8, registry=reg)
    assert sol.converged and sol.final_loss <= 1e-8
    err0 = np.abs(0.1 - true_k)[1:-1, 1:-1].mean()
    err = np.abs(sol.params - true_k)[1:-1, 1:-1].mean()
    assert err < 0.1 * err0
    assert sol.params.min() >= 1e-4 and sol.params.max() <= 0.24
    snap = reg.snapshot()
    series = [k for k in snap["series"] if k.startswith("inverse_loss")]
    assert series and len(snap["series"][series[0]]) == sol.iterations
    assert snap["counters"]["inverse_iterations_total"] == sol.iterations


def test_recover_initial_condition():
    nx, ny, steps = 12, 12, 10
    u0 = unit_reference_init(nx, ny)
    u_true = make_diff_solve(nx, ny, steps, device="cpu")(
        torch.tensor(u0), 0.1, 0.1).numpy()
    prob = InverseProblem(nx=nx, ny=ny, steps=steps, target="init",
                          obs_mask=observation_mask(nx, ny, every=1),
                          obs_values=u_true, device="cpu")
    sol = prob.solve(iterations=300, lr=0.05, tol=1e-7)
    assert sol.converged and sol.final_loss <= 1e-7


def _quadratic(x):
    with torch.enable_grad():
        p = x.detach().requires_grad_()
        loss = torch.sum((p - 3.0) ** 2)
        (g,) = torch.autograd.grad(loss, p)
    return loss.detach(), g


def test_adam_best_iterate_early_stop_and_f64():
    sol = adam_minimize(_quadratic, torch.zeros(()), iterations=5000,
                        lr=0.05, tol=1e-6)
    assert sol.converged and sol.iterations < 5000
    assert abs(float(sol.params) - 3.0) < 1e-2
    assert sol.final_loss == min(sol.loss_history)
    with pytest.raises(ValueError):
        adam_minimize(_quadratic, torch.zeros(()), iterations=0)
    sol = adam_minimize(_quadratic, torch.zeros((), dtype=torch.float64),
                        iterations=50, lr=0.1)
    assert sol.params.dtype == np.float64


def test_adam_pause_and_resume_bitwise():
    """A run paused after 7 iterations and resumed from its
    ``AdamState`` ends bit for bit where an uninterrupted run does."""
    x0 = torch.tensor(np.random.RandomState(0).randn(5, 4)
                      .astype(np.float32))
    whole = adam_minimize(_quadratic, x0, iterations=20, lr=0.1)
    half = adam_minimize(_quadratic, x0, iterations=20, lr=0.1,
                         pause=lambda it: it == 7)
    assert half.paused and half.state.iteration == 7
    rest = adam_minimize(_quadratic, x0, iterations=20, lr=0.1,
                         state=half.state)
    assert rest.params.tobytes() == whole.params.tobytes()
    assert rest.loss_history == whole.loss_history


def test_inverse_problem_validation():
    _, _, mask, values = _observed()
    for kw in ({"target": "nope"}, {"nx": 10, "ny": 10},
               {"obs_mask": np.zeros((12, 12), bool)}):
        args = {**dict(nx=12, ny=12, steps=4, target="init",
                       obs_mask=mask, obs_values=values), **kw}
        with pytest.raises(ValueError):
            InverseProblem(**args)
        with pytest.raises(ValueError):
            jinv.InverseProblem(**args)


# --------------------------------------------------------------------- #
# the server's inverse lane
# --------------------------------------------------------------------- #

def test_inverse_request_through_the_server_then_a_cache_hit():
    true_k, _, mask, values = _observed()
    req = InverseRequest.from_fields(12, 12, 16, mask, values,
                                     iterations=250, lr=0.02, tol=1e-8)
    reg = MetricsRegistry()
    with _server(registry=reg) as srv:
        res = srv.solve(req, timeout=300)
        again = srv.solve(req, timeout=60)
        f_solve = srv.submit(SolveRequest(nx=16, ny=16, steps=5,
                                          method="jnp"))
        assert f_solve.result(60).steps_done == 5
    assert res.converged and res.final_loss <= 1e-8 and not res.cache_hit
    err0 = np.abs(0.1 - true_k)[1:-1, 1:-1].mean()
    assert np.abs(res.params - true_k)[1:-1, 1:-1].mean() < 0.1 * err0
    assert again.cache_hit and again.final_loss == res.final_loss
    assert again.params.tobytes() == res.params.tobytes()
    snap = reg.snapshot()
    assert snap["counters"]["serve_requests_total{outcome=cache_hit}"] == 1
    assert snap["counters"]["inverse_solves_total{outcome=converged}"] == 1
    assert "inverse_solve_s" in snap["histograms"]


def test_inverse_duplicates_coalesce_in_flight():
    _, _, mask, values = _observed()
    req = InverseRequest.from_fields(12, 12, 16, mask, values,
                                     iterations=20, lr=0.02)
    with SolveServer(max_delay=0.05, device="cpu") as srv:
        fa, fb = srv.submit(req), srv.submit(req)
        ra, rb = fa.result(300), fb.result(300)
    assert {ra.coalesced, rb.coalesced} == {False, True}
    assert ra.params.tobytes() == rb.params.tobytes()


def test_invalid_request_rejected_and_chaos_retried():
    """An invalid request is refused at the door; the injected launch
    fault hits the inverse lane as it hits solves, and the retry policy
    absorbs it."""
    with _server() as srv:
        with pytest.raises(Rejected):
            srv.submit(InverseRequest(nx=12, ny=12, steps=16,
                                      obs_indices=(),
                                      obs_values=())).result(10)
    _, _, mask, values = _observed()
    req = InverseRequest.from_fields(12, 12, 16, mask, values,
                                     iterations=5, lr=0.02)
    chaos.install(chaos.ChaosConfig(fail_launches=1))
    try:
        with _server(retry_policy=RetryPolicy(max_attempts=3,
                                              base_delay=0.01)) as srv:
            assert srv.solve(req, timeout=300).iterations == 5
        assert chaos.controller().launches_failed == 1
    finally:
        chaos.install(None)


def _wait_for_iterations(reg, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if reg.snapshot()["counters"].get("inverse_iterations_total", 0):
            return
        time.sleep(0.02)
    raise AssertionError("the inverse loop never started")


class _StepClock:
    """A monotonic clock that stands still until the test advances it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t = 0.0

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> None:
        with self._lock:
            self._t += dt


def test_nondrain_stop_aborts_a_running_loop():
    _, _, mask, values = _observed()
    req = InverseRequest.from_fields(12, 12, 16, mask, values,
                                     iterations=100_000, lr=0.02)
    reg = MetricsRegistry()
    srv = _server(registry=reg).start()
    fut = srv.submit(req)
    _wait_for_iterations(reg)
    t0 = time.monotonic()
    srv.stop()
    assert time.monotonic() - t0 < 30
    with pytest.raises(Rejected) as e:
        fut.result(5)
    assert e.value.code == "shutdown"


def test_drain_stop_runs_the_loop_to_its_end():
    _, _, mask, values = _observed()
    req = InverseRequest.from_fields(12, 12, 16, mask, values,
                                     iterations=12, lr=0.02)
    srv = _server().start()
    fut = srv.submit(req)
    srv.stop(drain=True)
    assert fut.done() and fut.result().iterations == 12


def test_deadline_on_the_deadline_clock_aborts_and_frees_the_lane():
    """``launch_deadline`` read on a clock the test controls: only the
    advance past it fires the watchdog and the engine's abort, whatever
    the host's speed; the server then still serves."""
    _, _, mask, values = _observed()
    req = InverseRequest.from_fields(12, 12, 16, mask, values,
                                     iterations=100_000, lr=0.02)
    clock = _StepClock()
    reg = MetricsRegistry()
    with _server(registry=reg, launch_deadline=0.5,
                 deadline_clock=clock) as srv:
        fut = srv.submit(req)
        _wait_for_iterations(reg)
        clock.advance(1.0)
        with pytest.raises(Rejected) as e:
            fut.result(120)
        assert e.value.code == "watchdog_timeout"
        r = srv.solve(SolveRequest(nx=16, ny=16, steps=3, method="jnp"),
                      timeout=60)
        assert r.steps_done == 3


def test_engine_aborts_on_its_own_deadline_and_stop_event():
    _, _, mask, values = _observed()
    req = InverseRequest.from_fields(12, 12, 16, mask, values,
                                     iterations=1000, lr=0.02)
    ticks = itertools.count(0.0, 0.3)     # each read 0.3 s later
    eng = InverseEngine(deadline=0.5, clock=lambda: next(ticks),
                        device="cpu")
    with pytest.raises(Rejected) as e:
        eng.solve_batch([req])
    assert e.value.code == "watchdog_timeout"
    stop = threading.Event()
    stop.set()
    with pytest.raises(Rejected) as e:
        InverseEngine(stop_event=stop, device="cpu").solve_batch([req])
    assert e.value.code == "shutdown"


# --------------------------------------------------------------------- #
# satellites: snapshots, field files, records
# --------------------------------------------------------------------- #

def test_snapshot_state_owns_crops_and_keeps_dtype():
    src = np.arange(12, dtype=np.float32).reshape(3, 4)
    snap = snapshot_state(src)
    src[0, 0] = 99.0
    assert snap[0, 0] == 0.0 and snap.dtype == np.float32
    assert snapshot_state(np.ones((6, 8)), shape=(5, 7)).shape == (5, 7)
    t = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    snap = snapshot_state(t, dtype=None)
    t[0, 0] = 7.0
    assert snap.dtype == np.float64 and snap[0, 0] == 0.0
    assert snapshot_state(t).dtype == np.float32


def test_snapshot_shards_cover_the_grid():
    from heat2d_tpu_torch.parallel.sharded import ShardedGrid
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    grid = ShardedGrid([[full[:2, :3], full[:2, 3:]],
                        [full[2:, :3], full[2:, 3:]]], 4, 6)
    out = np.zeros((4, 6), np.float32)
    for r0, c0, blk in snapshot_shards(grid):
        out[r0:r0 + blk.shape[0], c0:c0 + blk.shape[1]] = blk
    assert out.tobytes() == full.numpy().tobytes()


FIELDS = {
    "kappa_f32": lambda: synthetic_diffusivity(9, 11),
    "mask_bool": lambda: observation_mask(10, 12, every=3),
    "f64": lambda: np.random.RandomState(1).rand(5, 6),
    "i32": lambda: np.arange(20, dtype=np.int32).reshape(4, 5),
}


@pytest.mark.parametrize("name", list(FIELDS))
def test_field_files_byte_identical_and_exchanged_with_jax(tmp_path, name):
    """``save_field`` writes the JAX package's bytes (binary and
    sidecar), and each package loads the other's file."""
    a = FIELDS[name]()
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tbin.save_field(a, tp, name=name, extra={"note": "x", "it": 3})
    jbin.save_field(a, jp, name=name, extra={"note": "x", "it": 3})
    for suffix in ("", ".meta.json"):
        assert open(tp + suffix, "rb").read() == \
            open(jp + suffix, "rb").read()
    for back, meta in (tbin.load_field(jp), jbin.load_field(tp)):
        assert back.dtype == a.dtype and back.tobytes() == a.tobytes()
        assert meta["name"] == name and meta["format"] == \
            "heat2d-tpu-field-v1"
    back, _ = tbin.load_field(tp)
    assert back.dtype == a.dtype and np.array_equal(back, a)


def test_load_field_rejects_corruption_truncation_and_bad_sidecar(
        tmp_path):
    p = str(tmp_path / "f.bin")
    tbin.save_field(torch.tensor(synthetic_diffusivity(6, 6)), p)
    raw = bytearray(open(p, "rb").read())
    raw[3] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        tbin.load_field(p)
    assert tbin.load_field(p, verify=False)[0].shape == (6, 6)
    open(p, "wb").write(b"\x00" * 8)
    with pytest.raises(CheckpointCorruptError):
        tbin.load_field(p, verify=False)
    open(p + ".meta.json", "w").write("{not json")
    with pytest.raises(CheckpointCorruptError):
        tbin.load_field(p)
    with pytest.raises(ValueError):
        tbin.save_field(np.zeros((3, 3), np.complex64),
                        str(tmp_path / "c.bin"))


def test_record_kinds_and_the_jsonl_export(tmp_path):
    from heat2d_tpu_torch.obs.record import (RECORD_KINDS, build_record,
                                             write_run_jsonl)
    assert "inverse" in RECORD_KINDS
    with pytest.raises(ValueError):
        build_record("nope", device="cpu")
    reg = MetricsRegistry()
    reg.series("inverse_loss", 1, 0.5, hash="ab")
    path = str(tmp_path / "m.jsonl")
    write_run_jsonl(reg, path, "inverse", {"iterations": 1}, device="cpu")
    lines = [json.loads(x) for x in open(path)]
    assert lines[0]["series"] == {"inverse_loss{hash=ab}": [[1, 0.5]]}
    assert lines[1]["kind"] == "inverse" and lines[1]["iterations"] == 1


# --------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------- #

def test_cli_selftest_passes(tmp_path):
    from heat2d_tpu_torch.diff.cli import main

    metrics = str(tmp_path / "inv.jsonl")
    record = str(tmp_path / "rec.json")
    assert main(["--selftest", "--device", "cpu", "--metrics-out", metrics,
                 "--run-record", record, "--log-level", "warning"]) == 0
    rec = json.load(open(record))
    assert rec["kind"] == "inverse" and rec["converged"] is True
    assert rec["final_loss"] <= rec["tol"] and rec["iterations"] >= 1
    assert rec["cache_hit_repeat"] is True
    # without a tuning db nothing was tuned: no key, as in the JAX
    # package's record
    assert rec["selftest_failures"] == [] and "tuned_config" not in rec
    lines = [json.loads(x) for x in open(metrics)]
    snap = [x for x in lines if x.get("event") == "snapshot"][0]
    assert snap["counters"]["inverse_iterations_total"] >= 1
    assert any(k.startswith("inverse_loss") for k in snap["series"])


def test_cli_direct_mode_with_jax_written_field_files(tmp_path, capsys):
    """Observations written by the JAX package's ``save_field`` drive the
    port's direct mode; its recovered field loads in the JAX package."""
    from heat2d_tpu_torch.diff.cli import main

    nx, ny, steps = 12, 12, 12
    _, _, mask, values = _observed(nx, ny, steps)
    obs_p, mask_p = str(tmp_path / "obs.bin"), str(tmp_path / "mask.bin")
    jbin.save_field(values, obs_p, name="observations")
    jbin.save_field(mask, mask_p, name="obs_mask")
    out_p, record = str(tmp_path / "rec.bin"), str(tmp_path / "rec.json")
    assert main(["--device", "cpu", "--nxprob", str(nx), "--nyprob",
                 str(ny), "--steps", str(steps), "--iterations", "20",
                 "--observations", obs_p, "--obs-mask", mask_p,
                 "--save-recovered", out_p, "--run-record", record]) == 0
    rec = json.load(open(record))
    assert rec["kind"] == "inverse" and rec["iterations"] == 20
    back, meta = jbin.load_field(out_p)
    assert back.shape == (nx, ny) and meta["iterations"] == 20
    assert meta["name"] == "recovered_diffusivity"
    assert main(["--device", "cpu", "--observations", obs_p]) == 1
    assert "go together" in capsys.readouterr().err


def test_cli_refuses_without_a_card(monkeypatch, capsys):
    from heat2d_tpu_torch.diff.cli import main
    from heat2d_tpu_torch.serve import cli as serve_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--selftest"]) == 1
    assert serve_cli.main(["--selftest", "--log-level", "info"]) == 1
    assert capsys.readouterr().err.count("CUDA") == 2
