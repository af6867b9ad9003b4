"""``heat2d_tpu_torch/autoscale`` against ``heat2d_tpu/autoscale`` on the
CPU, case for case after ``tests/test_autoscale.py``.

- **parole and resize** (``mesh/health.py``, ``mesh/engine.py``, over
  CPU slots on the port's side): N consecutive verified probe passes
  re-admit under a seq-fenced event, one failure denies; the serving
  invariant stays provable through a re-conviction after parole; resize
  validates its bounds and truncates the next launch's slot set. The
  book-keeping cases run through both stacks and are asserted alike.
- **live migration** (``autoscale/migrate.py``): the Adam state and the
  problem spec round-trip bitwise through the JSON ticket; a solve
  paused mid-flight and resumed elsewhere is BITWISE the one that never
  paused (params and every loss). Across stacks: a ticket either package
  encodes decodes in the other with the arrays bit for bit, and a job
  the port resumes from a JAX ticket evaluates its first resumed loss
  within ``tests/test_torch_inverse.py``'s rtol 1e-5 of the JAX
  oracle's (float32; XLA's CPU backend may contract in another order)
  and ends converged to the same ``tol`` as that file's init recovery.
- **actuator decisions** (``autoscale/actuator.py``): cooldowns, the
  scale-down hold, the clamp, step limits, victims, the chip-seconds
  ledger, on a fake fleet with an injected clock; the JAX actuator and
  the port's take the same actions on the same advice and clock.
- **the elastic soak end to end**: ``heat2d-tpu-torch-fleet --autoscale``
  on the CPU (one pool of real worker subprocesses): capacity follows the
  envelope both ways, nothing lost, below static chip-seconds, a
  live-migrated inverse job bitwise its oracle, the mesh leg over CPU
  slots bitwise. (The drain-to-retire cases of the JAX file run on the
  router's fake supervisor in ``tests/test_torch_fleet.py`` and on the
  shared pool of ``tests/test_torch_control.py``.)
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat2d_tpu.autoscale import Actuator as JActuator
from heat2d_tpu.autoscale import AutoscalePolicy as JPolicy
from heat2d_tpu.autoscale import migrate as jmigrate
from heat2d_tpu.diff.adjoint import make_diff_solve as jmake_diff_solve
from heat2d_tpu.diff import inverse as jinv
from heat2d_tpu.mesh import degrade as jdegrade
from heat2d_tpu.mesh import health as jhealth
from heat2d_tpu.obs.metrics import MetricsRegistry as JRegistry
from heat2d_tpu_torch.autoscale import Actuator, AutoscalePolicy
from heat2d_tpu_torch.autoscale import migrate
from heat2d_tpu_torch.diff.adjoint import make_diff_solve
from heat2d_tpu_torch.diff.inverse import (AdamState, InverseProblem,
                                           observation_mask,
                                           unit_reference_init)
from heat2d_tpu_torch.mesh import degrade
from heat2d_tpu_torch.mesh import health as health_mod
from heat2d_tpu_torch.mesh.degrade import FaultPolicy
from heat2d_tpu_torch.mesh.engine import MeshEnsembleEngine
from heat2d_tpu_torch.mesh.health import PAROLE_PASSES, HealthMonitor
from heat2d_tpu_torch.obs import MetricsRegistry
from heat2d_tpu_torch.parallel.mesh import host_devices
from heat2d_tpu_torch.resil.retry import wait_for

STACKS = {
    "port": types.SimpleNamespace(
        Registry=MetricsRegistry, Actuator=Actuator,
        Policy=AutoscalePolicy, degrade=degrade, health=health_mod,
        migrate=migrate),
    "jax": types.SimpleNamespace(
        Registry=JRegistry, Actuator=JActuator, Policy=JPolicy,
        degrade=jdegrade, health=jhealth, migrate=jmigrate),
}
BOTH = pytest.mark.parametrize("stack", ["port", "jax"])


def counters(reg):
    return reg.snapshot()["counters"]


def _health(stack, n, registry=None):
    """A health book over ``n`` devices: the JAX package's virtual CPU
    devices, the port's slots of the CPU."""
    if stack == "jax":
        return jhealth.HealthMonitor(n_devices=n, registry=registry)
    return HealthMonitor(devices=host_devices(n, "cpu"), registry=registry)


# --------------------------------------------------------------------- #
# parole: quarantine gains a way back
# --------------------------------------------------------------------- #

@BOTH
def test_parole_readmits_with_seq_fenced_event(stack):
    reg = STACKS[stack].Registry()
    m = _health(stack, 4, reg)
    m.quarantine(2, "probe_failure")
    assert m.capacity_fraction() == 0.75
    fence_before = m.seq()
    calls = []
    assert m.parole(2, passes=2, probe=lambda i: calls.append(i) or True)
    assert calls == [2, 2]
    assert not m.is_quarantined(2) and m.capacity_fraction() == 1.0
    ev = m.snapshot()["events"][-1]
    assert ev["kind"] == "readmit" and ev["device"] == 2
    assert ev["passes"] == 2 and ev["seq"] == fence_before + 1
    assert counters(reg)["mesh_parole_total{outcome=paroled}"] == 1


@BOTH
def test_parole_denied_on_any_failure_stays_quarantined(stack):
    reg = STACKS[stack].Registry()
    m = _health(stack, 2, reg)
    m.quarantine(1, "device_fail")
    calls = []

    def flaky(i):
        calls.append(i)
        return len(calls) < 2

    assert not m.parole(1, passes=3, probe=flaky)
    assert calls == [1, 1] and m.is_quarantined(1)
    assert all(e.get("kind") != "readmit"
               for e in m.snapshot()["events"])
    assert counters(reg)["mesh_parole_total{outcome=denied}"] == 1


@BOTH
def test_parole_validation(stack):
    m = _health(stack, 2)
    assert not m.parole(0)
    for kw in ({"index": 0, "passes": 0}, {"index": 9}):
        with pytest.raises(ValueError):
            m.parole(**kw)
    assert PAROLE_PASSES == jhealth.PAROLE_PASSES >= 2


@BOTH
def test_serving_invariant_through_parole_lifecycle(stack):
    m = _health(stack, 4)
    log = []

    def launch(devs):
        log.append({"signature": f"L{len(log)}",
                    "mesh": {"devices": list(devs),
                             "health_seq": m.seq()}})

    launch((0, 1, 2, 3))
    m.quarantine(3, "probe_failure")
    launch((0, 1, 2))
    launch((0, 1, 3))                           # L2: VIOLATION
    assert m.parole(3, passes=2, probe=lambda i: True)
    launch((0, 1, 2, 3))
    m.quarantine(3, "mesh_stall")
    launch((0, 1, 2, 3))                        # L4: VIOLATION
    rep = STACKS[stack].degrade.serving_invariant(m, log)
    assert not rep["ok"] and rep["checked"] == 5
    assert sorted(v["launch"] for v in rep["violations"]) == ["L2", "L4"]
    assert rep["violations"][1]["event"]["reason"] == "mesh_stall"


# --------------------------------------------------------------------- #
# voluntary resize (mesh/engine.py) over 4 CPU slots
# --------------------------------------------------------------------- #

def _engine(reg=None, n=4):
    return MeshEnsembleEngine(registry=reg or MetricsRegistry(),
                              fault=FaultPolicy(),
                              devices=host_devices(n, "cpu"))


def test_resize_validates_bounds_and_truncates_launch_set():
    reg = MetricsRegistry()
    eng = _engine(reg)
    nd = eng.n_devices
    for bad in (0, nd + 1):
        with pytest.raises(ValueError):
            eng.resize(bad)
    row = eng.resize(1)
    assert row["from"] == nd and row["to"] == 1
    assert row["health_seq"] == eng.health.seq()
    assert eng.active_devices() == (0,)
    back = eng.resize(nd)
    assert back["from"] == 1 and back["to"] == nd
    assert eng.active_devices() == tuple(range(nd))
    assert eng.resize_log == [row, back]
    c = counters(reg)
    assert c["mesh_resize_total{direction=down}"] == 1
    assert c["mesh_resize_total{direction=up}"] == 1
    assert reg.snapshot()["gauges"]["mesh_target_devices"] == nd


def test_resize_target_composes_with_quarantine():
    eng = _engine()
    nd = eng.n_devices
    eng.resize(nd - 1)
    eng.health.quarantine(0, "device_fail")
    assert eng.active_devices() == tuple(range(1, nd))[:nd - 1]
    assert 0 not in eng.active_devices()


# --------------------------------------------------------------------- #
# live migration: the wire ticket and the bitwise resume contract
# --------------------------------------------------------------------- #

NXI = NYI = 8
ISTEPS, ITERS, PAUSE_AT, LR = 5, 24, 7, 0.05


@pytest.fixture(scope="module")
def tiny_problem():
    u0 = unit_reference_init(NXI, NYI)
    u_true = make_diff_solve(NXI, NYI, ISTEPS, device="cpu")(
        torch.tensor(u0), 0.1, 0.1).detach().numpy()
    return InverseProblem(nx=NXI, ny=NYI, steps=ISTEPS, target="init",
                          obs_mask=observation_mask(NXI, NYI, every=1),
                          obs_values=u_true, cx=0.1, cy=0.1, device="cpu")


@pytest.fixture(scope="module")
def tiny_oracle(tiny_problem):
    """The unmigrated run every migrated trajectory must match."""
    return migrate.run_unmigrated(tiny_problem, iterations=ITERS, lr=LR)


@pytest.fixture(scope="module")
def tiny_ticket(tiny_problem):
    """A checkpoint taken DETERMINISTICALLY at iteration PAUSE_AT."""
    sol = tiny_problem.solve(iterations=ITERS, lr=LR,
                             pause=lambda it: it >= PAUSE_AT)
    assert sol.paused and sol.state.iteration == PAUSE_AT
    assert len(sol.loss_history) == PAUSE_AT
    return migrate.encode_ticket(tiny_problem, sol.state,
                                 iterations=ITERS, lr=LR)


def _state(make):
    rng = np.random.default_rng(7)
    return AdamState(iteration=17, params=make(rng), m=make(rng),
                     v=make(rng), best=make(rng), best_loss=0.123456789,
                     loss_history=[1.0, 0.5],
                     grad_norm_history=[2.0, 1.25])


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_adam_state_wire_roundtrip_bitwise(form):
    """Host arrays and tensors (the codec copies a tensor to the host
    first) round-trip bit for bit, dtype kept."""
    st = _state(lambda rng: rng.standard_normal((NXI, NYI)))
    if form == "tensor":
        st = AdamState(**{**st.__dict__, **{
            f: torch.tensor(getattr(st, f), dtype=torch.float32)
            for f in ("params", "m", "v", "best")}})
    back = migrate.decode_state(
        json.loads(json.dumps(migrate.encode_state(st))))
    for f in ("params", "m", "v", "best"):
        want = getattr(st, f)
        want = want.numpy() if form == "tensor" else want
        assert getattr(back, f).dtype == want.dtype
        assert getattr(back, f).tobytes() == want.tobytes()
    assert back.iteration == 17 and back.best_loss == st.best_loss
    assert back.loss_history == st.loss_history


def test_ticket_schema_is_validated(tiny_ticket):
    assert migrate.decode_ticket(json.dumps(tiny_ticket)) == \
        migrate.decode_ticket(tiny_ticket)
    for mod in (migrate, jmigrate):
        with pytest.raises(ValueError) as e:
            mod.decode_ticket({"schema": "heat2d-tpu/other/v9"})
        assert "schema='heat2d-tpu/other/v9'" in str(e.value)
    assert migrate.MIGRATION_SCHEMA == jmigrate.MIGRATION_SCHEMA
    assert "device" not in json.dumps(tiny_ticket["problem"])


def test_problem_spec_roundtrip(tiny_problem, tiny_ticket):
    prob = migrate.problem_from_spec(tiny_ticket["problem"], device="cpu")
    assert (prob.nx, prob.ny, prob.steps) == (NXI, NYI, ISTEPS)
    assert prob.target == "init" and prob.method == tiny_problem.method
    assert prob.device == "cpu"
    assert np.asarray(prob.obs_values).tobytes() == \
        np.asarray(tiny_problem.obs_values).tobytes()
    assert np.array_equal(prob.obs_mask, tiny_problem.obs_mask)


def test_pause_resume_is_bitwise_vs_unmigrated(tiny_ticket, tiny_oracle):
    job = migrate.resume_job(json.dumps(tiny_ticket), device="cpu")
    job.join(timeout=300)
    sol = job.solution
    assert not sol.paused and sol.iterations == ITERS
    assert sol.params.tobytes() == tiny_oracle.params.tobytes()
    assert sol.loss_history == list(tiny_oracle.loss_history)
    assert sol.grad_norm_history == list(tiny_oracle.grad_norm_history)


def test_inverse_job_threaded_checkpoint_resume(tiny_problem):
    """The actuator's path: a RUNNING job paused at whatever boundary the
    drain catches, the resumed run bitwise the never-paused oracle. (A
    budget of 400 at ~4 ms an iteration on the CPU: the pause lands near
    iteration 5, far from either end.)"""
    budget = 400
    reg = MetricsRegistry()
    job = migrate.InverseJob(tiny_problem, iterations=budget, lr=LR,
                             registry=reg).start()
    assert wait_for(
        lambda: counters(reg).get("inverse_iterations_total", 0) >= 5,
        120.0)
    ticket = job.checkpoint()
    assert ticket is not None
    it0 = ticket["state"]["iteration"]
    assert 0 < it0 < budget
    resumed = migrate.resume_job(json.dumps(ticket), device="cpu")
    resumed.join(timeout=300)
    oracle = migrate.run_unmigrated(ticket, device="cpu")
    assert resumed.solution.params.tobytes() == oracle.params.tobytes()
    assert resumed.solution.loss_history == list(oracle.loss_history)


def test_finished_job_checkpoints_to_none(tiny_problem):
    job = migrate.InverseJob(tiny_problem, iterations=3, lr=LR).start()
    job.join(timeout=120)
    assert job.done() and job.completed_iterations() == 3
    assert job.checkpoint() is None


# --------------------------------------------------------------------- #
# tickets across the two packages
# --------------------------------------------------------------------- #

JSTEPS, JITERS, JTOL = 10, 300, 1e-7


@pytest.fixture(scope="module")
def jax_init_problem():
    """``tests/test_torch_inverse.py``'s init recovery (12^2 x 10 steps,
    every cell observed), posed in the JAX package."""
    u0 = jinv.unit_reference_init(12, 12)
    u_true = np.asarray(jmake_diff_solve(12, 12, JSTEPS)(
        jnp.asarray(u0), 0.1, 0.1))
    return jinv.InverseProblem(
        nx=12, ny=12, steps=JSTEPS, target="init",
        obs_mask=jinv.observation_mask(12, 12, every=1), obs_values=u_true,
        cx=0.1, cy=0.1)


def _arrays(doc):
    st, pb = doc["state"], doc["problem"]
    return {k: v for k, v in [*st.items(), *pb.items()]
            if isinstance(v, dict) and "b64" in v}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tickets_cross_stacks_bitwise(writer, jax_init_problem,
                                      tiny_ticket):
    """A ticket either package encodes decodes in the other: the state's
    and the problem's arrays bit for bit, dtypes and budget kept."""
    if writer == "jax":
        sol = jax_init_problem.solve(iterations=JITERS, lr=LR, tol=JTOL,
                                     pause=lambda it: it >= PAUSE_AT)
        doc = json.loads(json.dumps(jmigrate.encode_ticket(
            jax_init_problem, sol.state, iterations=JITERS, lr=LR,
            tol=JTOL, source_slot=3)))
        reader = migrate
    else:
        doc = json.loads(json.dumps(tiny_ticket))
        reader = jmigrate
    assert _arrays(doc)
    back = reader.decode_ticket(doc)
    st = reader.decode_state(back["state"])
    kw = {"device": "cpu"} if reader is migrate else {}
    prob = reader.problem_from_spec(back["problem"], **kw)
    for f in ("params", "m", "v", "best"):
        a = getattr(st, f)
        assert a.tobytes() == np.frombuffer(
            __import__("base64").b64decode(doc["state"][f]["b64"]),
            dtype=a.dtype).tobytes()
        assert str(a.dtype) == doc["state"][f]["dtype"]
    other = jmigrate if reader is migrate else migrate
    ost = other.decode_state(doc["state"])
    for f in ("params", "m", "v", "best"):
        assert getattr(ost, f).tobytes() == getattr(st, f).tobytes()
    assert st.loss_history == ost.loss_history
    assert np.asarray(prob.obs_values).tobytes() == \
        np.asarray(other.problem_from_spec(doc["problem"],
                                           **({} if kw else
                                              {"device": "cpu"}))
                   .obs_values).tobytes()
    assert back["solve"] == doc["solve"]
    if writer == "jax":
        assert back["solve"]["tol"] == JTOL and doc["source_slot"] == 3


def test_port_resumes_a_jax_ticket_within_tolerance(jax_init_problem):
    """The JAX package pauses its init recovery at iteration 7 and ships
    the ticket; the port resumes it on the CPU. Its first resumed loss
    (the same iterate, bit for bit) is within rtol 1e-5 of the JAX
    oracle's at that iteration, and it ends converged to the tolerance
    ``tests/test_torch_inverse.py``'s init recovery holds (1e-7)."""
    sol = jax_init_problem.solve(iterations=JITERS, lr=LR, tol=JTOL,
                                 pause=lambda it: it >= PAUSE_AT)
    ticket = json.dumps(jmigrate.encode_ticket(
        jax_init_problem, sol.state, iterations=JITERS, lr=LR, tol=JTOL))
    oracle = jmigrate.run_unmigrated(ticket)
    job = migrate.resume_job(ticket, device="cpu")
    job.join(timeout=300)
    got = job.solution
    assert got.loss_history[:PAUSE_AT] == list(oracle.loss_history[
        :PAUSE_AT])
    np.testing.assert_allclose(got.loss_history[PAUSE_AT],
                               oracle.loss_history[PAUSE_AT], rtol=1e-5)
    assert got.converged and got.final_loss <= JTOL
    assert oracle.converged and oracle.final_loss <= JTOL


# --------------------------------------------------------------------- #
# actuator decisions: fake fleet, injected clock
# --------------------------------------------------------------------- #

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeFleet:
    """The FleetServer surface the actuator drives, minus processes."""

    def __init__(self, n=1):
        self.sup = self
        self._slots = list(range(n))
        self._next = n
        self.retired = []

    def pool_size(self):
        return len(self._slots)

    def provisioned_slots(self):
        return list(self._slots)

    def add_worker(self):
        slot = self._next
        self._next += 1
        self._slots.append(slot)
        return slot

    def retire_worker(self, slot, timeout=30.0):
        self._slots.remove(slot)
        self.retired.append(slot)
        return True


POL = dict(min_workers=1, max_workers=4, up_cooldown_s=10.0,
           down_cooldown_s=10.0, down_hold_ticks=3, max_step_up=2,
           max_step_down=1)


@pytest.mark.parametrize("kw", [
    dict(min_workers=0), dict(min_workers=3, max_workers=2),
    dict(down_hold_ticks=0), dict(drain_timeout_s=0.0),
    dict(max_step_up=0), dict(up_cooldown_s=-1.0), dict(parole_passes=0)])
def test_policy_validation_texts_equal_jax(kw):
    with pytest.raises(ValueError) as t:
        AutoscalePolicy(**kw)
    with pytest.raises(ValueError) as j:
        JPolicy(**kw)
    assert str(t.value) == str(j.value)
    assert AutoscalePolicy().parole_passes == PAROLE_PASSES


def test_actuator_scale_up_steps_cooldown_and_clamp():
    fl, clk, reg = FakeFleet(1), FakeClock(), MetricsRegistry()
    act = Actuator(fl, AutoscalePolicy(**POL), registry=reg, clock=clk,
                   device="cpu")
    rows = act.observe({"needed_units": 10})
    assert [r["action"] for r in rows] == ["scale_up"]
    assert rows[0]["slots"] == [1, 2]
    assert fl.pool_size() == 3 and rows[0]["target"] == 4
    clk.t = 5.0
    assert act.observe({"needed_units": 10}) == []
    clk.t = 12.0
    act.observe({"needed_units": 10})
    assert fl.pool_size() == 4
    clk.t = 24.0
    assert act.observe({"needed_units": 9}) == []
    assert counters(reg)["autoscale_actions_total{action=scale_up}"] == 2
    assert reg.snapshot()["gauges"]["autoscale_workers"] == 4.0


def test_actuator_scale_down_hold_cooldown_and_victims():
    fl, clk = FakeFleet(3), FakeClock()
    act = Actuator(fl, AutoscalePolicy(**POL), clock=clk, device="cpu")
    for t in (1.0, 2.0):
        clk.t = t
        assert act.observe({"needed_units": 1}) == []
    clk.t = 3.0
    rows = act.observe({"needed_units": 1})
    assert [r["action"] for r in rows] == ["scale_down"]
    assert rows[0]["slot"] == 2 and fl.retired == [2]
    for t in (4.0, 5.0, 6.0):
        clk.t = t
        assert act.observe({"needed_units": 1}) == []
    clk.t = 14.0
    act.observe({"needed_units": 1})
    assert fl.pool_size() == 1 and fl.retired == [2, 1]
    clk.t = 30.0
    assert act.observe({"needed_units": 0}) == []
    assert fl.pool_size() == 1


def test_actuator_equal_advice_resets_the_hold():
    fl, clk = FakeFleet(2), FakeClock()
    act = Actuator(fl, AutoscalePolicy(**POL), clock=clk, device="cpu")
    for t, need in ((1.0, 1), (2.0, 2), (3.0, 1), (4.0, 1)):
        clk.t = t
        act.observe({"needed_units": need})
    assert fl.pool_size() == 2
    clk.t = 5.0
    assert act.observe({"needed_units": 1}) and fl.pool_size() == 1


def test_actuator_chip_seconds_ledger():
    fl, clk = FakeFleet(2), FakeClock()
    act = Actuator(fl, AutoscalePolicy(**POL), clock=clk, device="cpu")
    for t in (0.0, 1.0, 3.0):
        clk.t = t
        act.observe(None)
    s = act.summary()
    assert s["chip_seconds"] == pytest.approx(6.0)
    assert s["static_chip_seconds"] == pytest.approx(3.0 * 4)
    assert s["savings_fraction"] == pytest.approx(0.5)
    assert s["workers_min"] == s["workers_max"] == 2
    assert s["trace"] == [(0.0, 2), (1.0, 2), (3.0, 2)]


#: advice per tick (None: a quiet tick that still integrates the ledger)
ADVICE = [None, 3, 3, 4, 4, 4, None, 1, 1, 1, 1, 2, 1, 1, 1, 1, 0, 0]


@pytest.mark.parametrize("extra", [{}, dict(down_hold_ticks=1,
                                            max_step_down=2,
                                            up_cooldown_s=0.0)])
def test_actuator_sequences_equal_jax(extra):
    """The same advice on the same clock: the JAX actuator and the
    port's take the same actions (rows, fields, order), trace the same
    pool sizes and bill the same chip-seconds."""
    out = {}
    for stack, ns in STACKS.items():
        fl, clk = FakeFleet(1), FakeClock()
        kw = {"device": "cpu"} if stack == "port" else {}
        act = ns.Actuator(fl, ns.Policy(**{**POL, **extra}),
                          registry=ns.Registry(), clock=clk, **kw)
        for i, need in enumerate(ADVICE):
            clk.t = 2.0 * i
            act.observe(None if need is None else {"needed_units": need})
        s = act.summary()
        out[stack] = (s["actions"], s["trace"], s["chip_seconds"],
                      s["scale_ups"], s["scale_downs"], fl.retired,
                      counters(act.registry))
    assert out["port"] == out["jax"]
    assert out["port"][3] >= 1 and out["port"][4] >= 1


def test_actuator_live_migrates_jobs_on_retire(tiny_ticket, tiny_oracle):
    """Scale-down with an attached long-running job: checkpoint, JSON
    wire trip, resume on the lowest surviving slot (on the actuator's
    device); the moved job finishes bitwise on the oracle."""

    class StubJob:
        def checkpoint(self, timeout=120.0):
            return tiny_ticket

        def completed_iterations(self):
            return PAUSE_AT

    fl, reg = FakeFleet(2), MetricsRegistry()
    act = Actuator(fl, AutoscalePolicy(), registry=reg, clock=FakeClock(),
                   device="cpu")
    act.attach_job(1, StubJob())
    row = act.retire(1)
    assert row["clean"] is True and fl.retired == [1]
    (mig,) = row["migrated"]
    assert mig["resumed"] is True and (mig["from"], mig["to"]) == (1, 0)
    assert mig["iteration"] == PAUSE_AT and mig["bytes"] > 0
    moved = act.jobs_on(0)[-1]
    moved.join(timeout=300)
    sol = moved.solution
    assert moved.problem.device == "cpu"
    assert not sol.paused and sol.iterations == ITERS
    assert sol.params.tobytes() == tiny_oracle.params.tobytes()
    assert sol.loss_history == list(tiny_oracle.loss_history)
    assert counters(reg)["autoscale_migrations_total"] == 1


def test_actuator_finished_job_is_not_migrated():
    class DoneJob:
        def checkpoint(self, timeout=120.0):
            return None

        def completed_iterations(self):
            return 42

    fl = FakeFleet(2)
    act = Actuator(fl, AutoscalePolicy(), clock=FakeClock(), device="cpu")
    act.attach_job(1, DoneJob())
    row = act.retire(1)
    assert row["migrated"] == [{"from": 1, "to": None,
                                "iteration": 42, "resumed": False}]
    assert act.migrations == [] and act.jobs_on(0) == []


def test_actuator_parole_all_and_resize(monkeypatch):
    reg = MetricsRegistry()
    m = HealthMonitor(devices=host_devices(4, "cpu"), registry=reg)
    m.quarantine(1, "probe_failure")
    m.quarantine(3, "device_fail")
    monkeypatch.setattr(health_mod, "probe_device",
                        lambda i, devices=None: i == 1)
    act = Actuator(FakeFleet(1), AutoscalePolicy(parole_passes=2),
                   registry=reg, health=m, clock=FakeClock(),
                   device="cpu")
    rows = act.parole_all()
    assert [(r["device"], r["outcome"]) for r in rows] == \
        [(1, "paroled"), (3, "denied")]
    assert m.quarantined() == (3,)
    assert counters(reg)["autoscale_actions_total{action=parole}"] == 2
    eng = _engine(reg)
    act.mesh_engine = eng
    row = act.resize_mesh(1)
    assert row["action"] == "mesh_resize" and row["to"] == 1
    assert eng.active_devices() == (0,)
    act.resize_mesh(eng.n_devices)
    assert counters(reg)[
        "autoscale_actions_total{action=mesh_resize}"] == 2


def test_mesh_leg_bitwise_over_cpu_slots():
    """The elastic soak's mesh leg (``fleet.cli._autoscale_mesh_leg``) on
    4 CPU slots: resize down and up, a quarantine and a parole, each
    bitwise the full mesh, the paroled slot serving again."""
    from heat2d_tpu_torch.fleet import cli as fleet_cli
    from heat2d_tpu_torch.load.synth import PROFILES

    failures = []
    act = Actuator(FakeFleet(1), AutoscalePolicy(), clock=FakeClock(),
                   device="cpu")
    args = types.SimpleNamespace(host_device_count=4, device="cpu")
    out = fleet_cli._autoscale_mesh_leg(args, act, PROFILES["diurnal"],
                                        MetricsRegistry(), failures)
    assert failures == []
    assert out["paroled"] == 1 and out["resizes"] == 2
    assert out["invariant_ok"] and out["paroled_device_served"]
    args.host_device_count = 1
    assert "skipped" in fleet_cli._autoscale_mesh_leg(
        args, act, PROFILES["diurnal"], MetricsRegistry(), failures)


# --------------------------------------------------------------------- #
# the elastic soak end to end (one pool of real workers)
# --------------------------------------------------------------------- #

def test_fleet_cli_autoscale_soak(tmp_path):
    """``heat2d-tpu-torch-fleet --autoscale`` on the CPU: the diurnal day
    scales the pool both ways below static chip-seconds, nothing is lost,
    the migrated job ends bitwise its oracle, the mesh leg passes; the
    kind='autoscale' and kind='control' records."""
    from heat2d_tpu_torch.fleet.cli import main

    out = tmp_path / "auto.jsonl"
    rc = main(["--workers", "2", "--autoscale", "--soak", "20",
               "--device", "cpu", "--host-device-count", "2",
               "--metrics-out", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    runs = {r["kind"]: r for r in recs if r.get("event") == "run_record"}
    auto, ctl = runs["autoscale"], runs["control"]
    assert auto["failures"] == [] and auto["device"] == "cpu"
    assert auto["completed"] == auto["submitted"] > 0
    # a unit is the lesser of one worker and the pool's rate per worker,
    # derated to the CLI's utilization 0.6
    unit = min(auto["calibrated_rps_per_worker"],
               auto["calibrated_rps_pool"] / 2)
    assert auto["per_unit_rps"] == pytest.approx(0.6 * unit, rel=1e-3)
    assert auto["scale_ups"] >= 1 and auto["scale_downs"] >= 1
    assert auto["chip_seconds"] < auto["static_chip_seconds"]
    assert auto["migration"]["bitwise_vs_oracle"] is True
    assert auto["migrations"] and auto["mesh"]["invariant_ok"] is True
    acts = {d["action"] for d in ctl["decisions"]}
    assert {"autoscale_scale_up", "autoscale_scale_down"} <= acts
    assert ctl["autoscale"]["scale_ups"] == auto["scale_ups"]
