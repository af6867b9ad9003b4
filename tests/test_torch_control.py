"""``heat2d_tpu_torch/control`` against ``heat2d_tpu/control`` on the CPU,
case for case after ``tests/test_control.py``.

Three tiers, as there:

- units, run through both stacks with the same inputs and asserted alike:
  the windowed burn API (``obs/slo.BurnWindow``, zero traffic),
  ``CounterDeltas``, the chaos storm's parsing and single firing, the
  retuner's signature mapping and hot ranking, capacity advice;
- the router's probe and pre-emptive shed against a fake supervisor,
  and the control plane's decisions on a fake fleet: the JAX plane and
  the port's plane, fed the same traffic, rates, quarantines and
  actuator clock, log the same actions with the same fields in the same
  order (the rows' wall-clock ``t`` aside);
- real worker subprocesses on ``device="cpu"``: ONE shared pool of two
  workers carries every rollout the JAX suite starts a pool for
  (healthy promote, bad candidate auto-revert bitwise, the mid-flight
  re-stage guard, a kill storm in the observation window), then the
  drain-timeout retirement on an injected clock; and one CLI soak with a
  storm landing mid-rollout. Every probe answer is bitwise the port's
  one-process ``SolveServer``'s.

Tolerances: none is needed. Decisions, verdicts, decision logs and error
texts are equal; answers are bitwise.
"""

import json
import time
import types

import numpy as np
import pytest

import tests.test_torch_fleet as tff
from heat2d_tpu import control as jcontrol
from heat2d_tpu.autoscale import Actuator as JActuator
from heat2d_tpu.autoscale import AutoscalePolicy as JPolicy
from heat2d_tpu.fleet import cli as jfleet_cli
from heat2d_tpu.load import capacity as jcapacity
from heat2d_tpu.mesh.health import HealthMonitor as JHealth
from heat2d_tpu.obs import slo as jslo
from heat2d_tpu.obs.metrics import CounterDeltas as JDeltas
from heat2d_tpu.obs.metrics import MetricsRegistry as JRegistry
from heat2d_tpu.resil import chaos as jchaos
from heat2d_tpu.serve import schema as jschema
from heat2d_tpu_torch import control
from heat2d_tpu_torch.autoscale import Actuator, AutoscalePolicy
from heat2d_tpu_torch.control import (ControlPlane, Retuner, Rollout,
                                      RolloutConfig, problem_from_signature)
from heat2d_tpu_torch.fleet import cli as fleet_cli
from heat2d_tpu_torch.load import capacity
from heat2d_tpu_torch.mesh.health import HealthMonitor
from heat2d_tpu_torch.obs import slo
from heat2d_tpu_torch.obs.metrics import CounterDeltas, MetricsRegistry
from heat2d_tpu_torch.resil import chaos
from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest
from heat2d_tpu_torch.serve.server import SolveServer
from heat2d_tpu_torch.tune.db import TuningDB

LIMIT = tff.LIMIT

STACKS = {
    "port": types.SimpleNamespace(
        slo=slo, Registry=MetricsRegistry, CounterDeltas=CounterDeltas,
        chaos=chaos, control=control, capacity=capacity,
        Health=HealthMonitor, Actuator=Actuator, Policy=AutoscalePolicy,
        SolveRequest=SolveRequest, fleet_cli=fleet_cli),
    "jax": types.SimpleNamespace(
        slo=jslo, Registry=JRegistry, CounterDeltas=JDeltas,
        chaos=jchaos, control=jcontrol, capacity=jcapacity,
        Health=JHealth, Actuator=JActuator, Policy=JPolicy,
        SolveRequest=jschema.SolveRequest, fleet_cli=jfleet_cli),
}
BOTH = pytest.mark.parametrize("stack", ["port", "jax"])


def _policy(ns=STACKS["port"], budget=0.01):
    return ns.slo.SLOPolicy(latency_p99_s=1.0, error_budget=budget)


def _traffic(reg, n_ok=0, n_fail=0, sig="sigA"):
    if n_ok:
        reg.counter("fleet_signature_requests_total", value=n_ok,
                    signature=sig, outcome="completed")
    if n_fail:
        reg.counter("fleet_signature_requests_total", value=n_fail,
                    signature=sig, outcome="rejected_timeout")


# --------------------------------------------------------------------- #
# obs/slo.py: zero traffic and the windowed burn API, both stacks
# --------------------------------------------------------------------- #

@BOTH
def test_slo_evaluate_zero_traffic_emits_no_burn_gauge_or_verdict(stack):
    ns = STACKS[stack]
    reg = ns.Registry()
    reg.observe("fleet_signature_latency_s", 0.1, signature="dead")
    (row,) = ns.slo.evaluate(reg, prefix="fleet", default=_policy(ns))
    assert row["requests"] == 0
    assert "ok" not in row and "burn_rate" not in row
    assert row["latency_target_p99_s"] == 1.0
    assert reg.snapshot()["gauges"] == {}


@BOTH
def test_burn_window_sustained_detection_and_reset(stack):
    ns = STACKS[stack]
    reg = ns.Registry()
    bw = ns.slo.BurnWindow(_policy(ns), threshold=1.0, sustain=2)
    _traffic(reg, n_ok=100)
    res = bw.tick(reg)
    assert res["sigA"]["burn_rate"] == 0.0 and not bw.sustained(res)
    _traffic(reg, n_fail=10)
    res = bw.tick(reg)
    assert res["sigA"]["burn_rate"] == pytest.approx(100.0)
    assert res["sigA"]["windows"] == 1 and not res["sigA"]["sustained"]
    _traffic(reg, n_fail=10)
    res = bw.tick(reg)
    assert res["sigA"]["sustained"] and bw.sustained(res) == ["sigA"]
    assert reg.snapshot()["gauges"][
        "slo_windowed_burn_rate{signature=sigA}"] == pytest.approx(100.0)
    _traffic(reg, n_ok=100)
    res = bw.tick(reg)
    assert res["sigA"]["windows"] == 0 and not res["sigA"]["sustained"]


@BOTH
def test_burn_window_zero_traffic_holds_streak_without_gauge(stack):
    ns = STACKS[stack]
    reg = ns.Registry()
    bw = ns.slo.BurnWindow(_policy(ns), threshold=1.0, sustain=1)
    _traffic(reg, n_fail=5)
    assert bw.tick(reg)["sigA"]["sustained"]
    res = bw.tick(reg)
    assert res["sigA"]["burn_rate"] is None and res["sigA"]["sustained"]
    assert bw.tick(None) == {}
    for kw in ({"sustain": 0}, {"threshold": 0}):
        with pytest.raises(ValueError):
            ns.slo.BurnWindow(_policy(ns), **kw)


@BOTH
def test_counter_deltas_windows_and_registry_swap(stack):
    ns = STACKS[stack]
    reg = ns.Registry()
    cd = ns.CounterDeltas()
    reg.counter("fleet_requests_total", value=5, outcome="completed")
    assert list(cd.tick(reg, "fleet_requests_total").values()) == [5.0]
    assert list(cd.tick(reg, "fleet_requests_total").values()) == [0.0]
    reg.counter("fleet_requests_total", value=3, outcome="completed")
    assert list(cd.tick(reg, "fleet_requests_total").values()) == [3.0]
    reg2 = ns.Registry()
    reg2.counter("fleet_requests_total", value=2, outcome="completed")
    assert list(cd.tick(reg2, "fleet_requests_total").values()) == [2.0]


# --------------------------------------------------------------------- #
# the router's probe and pre-emptive shed (fake supervisor)
# --------------------------------------------------------------------- #

PORT = tff.STACKS["port"]


def test_probe_targets_slot_and_bypasses_cache():
    fs = tff.make_router(PORT)
    r = tff.req(cx=0.33)
    f = fs.submit(r)
    slot, msg = fs.sup.sent[-1]
    tff.answer(PORT, fs, slot, msg)
    f.result(timeout=5)
    assert fs.submit(r).result(timeout=5).cache_hit
    n = len(fs.sup.sent)
    other = 1 - slot
    pf = fs.probe(other, r)
    assert len(fs.sup.sent) == n + 1       # a real dispatch, no cache
    pslot, pmsg = fs.sup.sent[-1]
    assert pslot == other and "event" not in pmsg
    tff.answer(PORT, fs, pslot, pmsg)
    res = pf.result(timeout=5)
    assert not res.cache_hit and not res.coalesced
    assert str(r.signature()) in fs._hot
    probe_only = tff.req(cx=0.9, steps=tff.STEPS + 7)
    fs.probe(other, probe_only)
    assert str(probe_only.signature()) not in fs._hot


def test_probe_fails_fast_without_replay_and_deadline_expires():
    fs = tff.make_router(PORT)
    f = fs.probe(0, tff.req(cx=0.41))
    n = len(fs.sup.sent)
    fs.sup.alive = [1]
    fs._on_worker_lost(0)
    with pytest.raises(Rejected) as e:
        f.result(timeout=5)
    assert e.value.code == "worker_lost"
    assert len(fs.sup.sent) == n           # never replayed elsewhere
    with pytest.raises(Rejected) as e:
        fs.probe(0, tff.req(cx=0.42)).result(timeout=5)
    assert e.value.code == "worker_lost"
    fs = tff.make_router(PORT, default_timeout=0.01)
    f = fs.probe(0, tff.req(cx=0.43))
    time.sleep(0.05)
    fs._expire_overdue()
    with pytest.raises(Rejected) as e:
        f.result(timeout=5)
    assert e.value.code == "timeout"


def test_preemptive_shed_low_priority_only_cache_still_answers():
    fs = tff.make_router(
        PORT, max_inflight=10,
        quotas={"batch": PORT.TenantPolicy(max_inflight=10, priority=1)})
    warm = tff.req(cx=0.77)
    f = fs.submit(warm, tenant="batch")
    slot, msg = fs.sup.sent[-1]
    tff.answer(PORT, fs, slot, msg)
    f.result(timeout=5)
    fs.set_preemptive_shed(0.3)            # watermark 10 -> 3
    futs = [fs.submit(tff.req(cx=0.5 + 0.001 * i), tenant="batch")
            for i in range(4)]
    with pytest.raises(Rejected) as e:
        futs[-1].result(timeout=5)
    assert e.value.code == "overloaded"
    assert e.value.fields["preemptive_shed"] is True
    assert not fs.submit(tff.req(cx=0.81)).done()   # priority 0 admitted
    assert fs.submit(warm, tenant="batch").result(timeout=5).cache_hit
    assert fs.registry.snapshot()["gauges"]["fleet_shed_watermark"] == 0.3
    fs.set_preemptive_shed(None)
    assert fs.registry.snapshot()["gauges"]["fleet_shed_watermark"] == 0.8
    with pytest.raises(ValueError):
        fs.set_preemptive_shed(1.5)


# --------------------------------------------------------------------- #
# control plane decisions (fake fleet)
# --------------------------------------------------------------------- #

class FakeSup:
    def __init__(self, alive=(0, 1)):
        self.alive = list(alive)

    def alive_slots(self):
        return list(self.alive)

    def generations_snapshot(self):
        return []


class FakePlaneFleet:
    """The FleetServer surface the plane uses, minus everything."""

    def __init__(self, ns=STACKS["port"]):
        self.registry = ns.Registry()
        self.shed_calls = []
        self._total_inflight = 0
        self.sup = FakeSup()

    def set_preemptive_shed(self, wm):
        self.shed_calls.append(wm)


FIT = {"model": "m", "per_unit_rps": 50.0, "saturated": True}


def _health(stack, n):
    """A health book over ``n`` devices: the JAX package's virtual CPU
    devices, the port's slots of the CPU."""
    if stack == "jax":
        return JHealth(n_devices=n)
    from heat2d_tpu_torch.parallel.mesh import host_devices
    return HealthMonitor(devices=host_devices(n, "cpu"))


def test_plane_sheds_on_sustained_burn_and_lifts_on_recovery():
    fleet = FakePlaneFleet()
    plane = ControlPlane(fleet, policy=_policy(), sustain=2,
                         shed_watermark=0.4, capacity_fit=FIT)
    _traffic(fleet.registry, n_ok=100)
    plane.tick()
    assert fleet.shed_calls == []
    for _ in range(2):
        _traffic(fleet.registry, n_fail=10)
        plane.tick()
    assert fleet.shed_calls == [0.4]
    acts = [d["action"] for d in plane.decisions]
    assert {"shed", "retune_wanted", "capacity_advice"} <= set(acts)
    advice = [d for d in plane.decisions
              if d["action"] == "capacity_advice"][0]
    assert advice["current_units"] == 2
    for _ in range(3):
        _traffic(fleet.registry, n_fail=10)
        plane.tick()
    assert len([d for d in plane.decisions
                if d["action"] == "capacity_advice"]) == 1
    snap = fleet.registry.snapshot()
    assert snap["gauges"]["control_shed_active"] == 1.0
    assert snap["gauges"]["control_burning_signatures"] == 1.0
    assert snap["counters"]["control_actions_total{action=shed}"] == 1
    _traffic(fleet.registry, n_ok=500)
    plane.tick()
    plane.tick()
    assert fleet.shed_calls == [0.4, None]
    assert fleet.registry.snapshot()["gauges"]["control_shed_active"] == 0.0


def test_capacity_advice_reemits_when_quarantine_shrinks_capacity():
    fleet = FakePlaneFleet()
    monitor = _health("port", 8)
    plane = ControlPlane(fleet, policy=_policy(), sustain=2,
                         shed_watermark=0.4, capacity_fit=FIT,
                         mesh_health=monitor)
    plane._observed_rps = lambda: 120.0    # 3 units needed, 2 deployed
    _traffic(fleet.registry, n_ok=100)
    plane.tick()
    for _ in range(2):
        _traffic(fleet.registry, n_fail=10)
        plane.tick()
    rows = [d for d in plane.decisions if d["action"] == "capacity_advice"]
    assert len(rows) == 1
    assert rows[0]["needed_units"] == 3 and rows[0]["add_units"] == 1
    monitor.quarantine(3, "device_fail")
    _traffic(fleet.registry, n_fail=10)
    plane.tick()
    rows = [d for d in plane.decisions if d["action"] == "capacity_advice"]
    assert len(rows) == 2 and rows[1]["needed_units"] == 3
    assert rows[1]["capacity_fraction"] == 0.875
    assert rows[1]["add_units"] == 2
    _traffic(fleet.registry, n_fail=10)
    plane.tick()
    assert len([d for d in plane.decisions
                if d["action"] == "capacity_advice"]) == 2


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeElasticFleet(FakePlaneFleet):
    """A plane fleet whose pool the actuator resizes."""

    def __init__(self, ns, n=2):
        super().__init__(ns)
        self.sup = self
        self._slots = list(range(n))
        self._next = n

    def alive_slots(self):
        return list(self._slots)

    def generations_snapshot(self):
        return []

    def pool_size(self):
        return len(self._slots)

    def provisioned_slots(self):
        return list(self._slots)

    def add_worker(self):
        self._slots.append(self._next)
        self._next += 1
        return self._slots[-1]

    def retire_worker(self, slot, timeout=30.0):
        self._slots.remove(slot)
        return True


#: (ok, failed, observed rps) per tick: a burn episode with rising
#: demand, a quarantine mid-burn, recovery and a trough
SCRIPT = ([(100, 0, 40.0)] + [(0, 10, 120.0)] * 3 + [(0, 10, 160.0)] * 2
          + [(500, 0, 20.0)] * 8)


def _plane_log(stack):
    ns = STACKS[stack]
    fleet = FakeElasticFleet(ns)
    monitor = _health(stack, 8)
    clk = FakeClock()
    act = ns.Actuator(fleet, ns.Policy(min_workers=1, max_workers=4,
                                       up_cooldown_s=1.0,
                                       down_cooldown_s=2.0,
                                       down_hold_ticks=2),
                      registry=fleet.registry, clock=clk)
    plane = ns.control.ControlPlane(
        fleet, policy=_policy(ns), sustain=2, shed_watermark=0.4,
        capacity_fit=FIT, mesh_health=monitor, actuator=act)
    for i, (ok, bad, rps) in enumerate(SCRIPT):
        clk.t = float(i)
        plane._observed_rps = lambda rps=rps: rps
        if i == 4:
            monitor.quarantine(5, "device_fail")
        _traffic(fleet.registry, n_ok=ok, n_fail=bad)
        plane.tick()
    rows = [{k: v for k, v in d.items() if k != "t"}
            for d in plane.decisions]
    snap = fleet.registry.snapshot()
    control_keys = sorted(k for k in snap["counters"]
                          if k.startswith(("control_", "autoscale_")))
    return (rows, fleet.shed_calls, fleet.pool_size(),
            {k: snap["counters"][k] for k in control_keys},
            act.summary()["chip_seconds"])


def test_plane_and_actuator_decide_like_jax():
    """The JAX plane and the port's, each with its actuator on a fake
    elastic fleet, fed the same traffic, rates, quarantine and clock:
    the same actions, fields and order, the same shed calls, pool size,
    counters and chip-seconds."""
    port, jax_ = _plane_log("port"), _plane_log("jax")
    actions = [r["action"] for r in port[0]]
    for a in ("shed", "retune_wanted", "capacity_advice",
              "device_quarantine", "autoscale_scale_up", "unshed",
              "autoscale_scale_down"):
        assert a in actions, actions
    assert port == jax_


def test_plane_stages_retune_off_peak(tmp_path):
    fleet = FakePlaneFleet()
    ret = Retuner(fleet, candidate_path=str(tmp_path / "candidate.json"),
                  validated_path=str(tmp_path / "validated.json"))
    plane = ControlPlane(fleet, policy=_policy(), sustain=1, retuner=ret)
    sig = str(SolveRequest(nx=64, ny=64, steps=4).signature())
    _traffic(fleet.registry, n_fail=5, sig=sig)
    fleet._total_inflight = 99             # peak: nothing stages
    plane.tick()
    assert plane.staged == [] and plane.retune_wanted
    fleet._total_inflight = 0              # off-peak: stage
    _traffic(fleet.registry, n_fail=5, sig=sig)
    plane.tick()
    assert len(plane.staged) == 1
    for _ in range(3):
        _traffic(fleet.registry, n_fail=5, sig=sig)
        plane.tick()
    assert len(plane.staged) == 1
    assert len([d for d in plane.decisions
                if d["action"] == "retune_wanted"]) == 1
    assert plane.staged[0]["epoch"] == 1
    cdb = TuningDB(str(tmp_path / "candidate.json"))
    assert cdb.epoch == 1 and cdb.validated is False
    # the simulated card's kind: never a real card's entries
    e = cdb.entry("sim-h100", "64x64:float32")
    assert e is not None and e["validated"] is False and e.get("best")
    s = plane.summary()
    assert s["staged"] and s["no_unvalidated_serving"] is True
    assert fleet.registry.snapshot()["counters"][
        "control_retunes_total"] == 1


@BOTH
def test_retuner_signature_mapping_and_hot_ranking(stack):
    ns = STACKS[stack]
    fleet = FakePlaneFleet(ns)
    ret = ns.control.Retuner(fleet, candidate_path="c.json",
                             validated_path="v.json")
    sig_a = str(ns.SolveRequest(nx=32, ny=32, steps=4).signature())
    sig_b = str(ns.SolveRequest(nx=48, ny=32, steps=4).signature())
    _traffic(fleet.registry, n_ok=10, sig=sig_a)
    _traffic(fleet.registry, n_ok=30, sig=sig_b)
    assert [s for s, _ in ret.hot_signatures()] == [sig_b, sig_a]
    assert ret.hot_signatures() == []
    p = ns.control.problem_from_signature(sig_a)
    assert (p.nx, p.ny, p.dtype) == (32, 32, "float32")
    assert ns.control.problem_from_signature("('inverse', 1)") is None
    assert ns.control.problem_from_signature("garbage((") is None


def test_signature_strings_map_alike_across_stacks():
    """Every serve signature string maps to the same tune problem key in
    both stacks (the port's strings carry the port's method names)."""
    for nx, ny, method in ((16, 16, "jnp"), (640, 1024, "pallas"),
                           (4099, 4097, "auto")):
        for ns in STACKS.values():
            sig = str(ns.SolveRequest(nx=nx, ny=ny, steps=7,
                                      method=method).signature())
            assert problem_from_signature(sig).key() == \
                jcontrol.problem_from_signature(sig).key() == \
                f"{nx}x{ny}:float32"


@BOTH
def test_capacity_advise_units(stack):
    cap = STACKS[stack].capacity
    fit = {"model": "m", "per_unit_rps": 25.0, "saturated": True}
    adv = cap.advise(fit, observed_rps=90.0, current_units=2)
    assert adv["needed_units"] == 4 and adv["add_units"] == 2
    none = cap.advise({"per_unit_rps": 0.0}, 10.0, 2)
    assert none["needed_units"] is None and none["add_units"] is None
    assert adv == capacity.advise(fit, observed_rps=90.0, current_units=2)


@BOTH
def test_chaos_rollout_env_parse_and_single_fire(stack):
    ch = STACKS[stack].chaos
    cfg = ch.ChaosConfig.from_env(
        {"HEAT2D_CHAOS_ROLLOUT_KILL_PHASE": "observe"})
    assert cfg is not None and cfg.rollout_kills == 0
    with pytest.raises(ValueError) as e:
        ch.ChaosConfig(rollout_kill_phase="nonsense")
    assert str(e.value) == ("rollout_kill_phase must be one of ('canary', "
                            "'parity', 'observe', 'promote'), got "
                            "'nonsense'")
    with pytest.raises(ValueError):
        ch.ChaosConfig.from_env({"HEAT2D_CHAOS_ROLLOUT_KILLS": "lots"})
    assert ch.ChaosConfig.from_env(
        {"HEAT2D_CHAOS_ROLLOUT_KILL_PHASE": ""}) is None
    fired = []
    ctl = ch._Controller(ch.ChaosConfig(rollout_kill_phase="parity",
                                        rollout_kills=2))
    ctl.rollout_point("canary", fired.append)
    assert fired == []
    ctl.rollout_point("parity", fired.append)
    ctl.rollout_point("parity", fired.append)
    assert fired == [2]
    assert ch.ROLLOUT_PHASES == jchaos.ROLLOUT_PHASES


def test_installed_storm_fires_once_through_the_module_hook():
    fired = []
    reg = MetricsRegistry()
    chaos.install(chaos.ChaosConfig(rollout_kill_phase="observe",
                                    rollout_kills=1), registry=reg)
    try:
        for phase in ("canary", "parity", "observe", "observe",
                      "promote"):
            chaos.rollout_point(phase, fired.append)
        chaos.rollout_point("observe")     # no callback: nothing to fire
    finally:
        chaos.uninstall()
    assert fired == [1]
    assert reg.snapshot()["counters"][
        "resil_chaos_injected_total{point=rollout_kill}"] == 1
    chaos.rollout_point("observe", fired.append)   # disarmed
    assert fired == [1]


@pytest.mark.parametrize("argv", [
    ["--soak", "1", "--control-storm-phase", "observe"],
    ["--soak", "1", "--control-bad-candidate"],
    ["--control-storm-phase", "canary", "--control-bad-candidate"],
])
def test_cli_storm_and_bad_candidate_require_rollout(argv, capsys):
    """The chaos flags act on a live rollout: without one the CLI refuses
    the combination, with the JAX CLI's exit code and text."""
    assert fleet_cli.main(argv) == 2
    port_err = capsys.readouterr().err
    assert jfleet_cli.main(argv) == 2
    assert port_err == capsys.readouterr().err
    assert "require --control-rollout" in port_err


def test_heartbeat_tally_reads_each_launch_row_once():
    """A worker's heartbeat carries its launches' tuned plans
    (``worker.TunedTally``): the groups equal a count over the whole
    launch log, and a beat reads only the rows appended since the last
    one, so its cost does not grow with the worker's uptime."""
    from collections import Counter

    from heat2d_tpu_torch.fleet.worker import TunedTally

    k4 = {"route": "resident", "bm": 0, "tsteps": 4}
    k7 = {"route": "resident", "bm": 0, "tsteps": 7}
    sig = (640, 1024, 2000, "float32", "pallas", False, 0, 0.0)
    plans = (k4, None, k7)
    log = [{"signature": sig, "capacity": 1 + (i % 2) * 7,
            "tuned_config": plans[i % 3]} for i in range(100_000)]
    tally = TunedTally()
    rows = tally.rows(log)
    want = Counter((str(r["signature"]), r["capacity"],
                    json.dumps(r["tuned_config"], sort_keys=True))
                   for r in log)
    assert sum(r[3] for r in rows) == len(log) and len(rows) == 6
    assert {(r[0], r[1], json.dumps(r[2], sort_keys=True)): r[3]
            for r in rows} == want
    # the rows already read are never read again: poisoned, they would
    # raise; one new launch moves exactly one group by one
    log[:] = [None] * len(log)
    log.append({"signature": sig, "capacity": 1, "tuned_config": k7})
    again = tally.rows(log)
    assert tally.rows(log) == again
    moved = [(a, b) for a, b in zip(rows, again) if a != b]
    assert moved == [(moved[0][0], moved[0][0][:3] + [moved[0][0][3] + 1])]
    assert moved[0][0][:3] == [str(sig), 1, k7]


def test_threaded_control_modules_take_audited_locks(tmp_path):
    """The port's linter (R006) covers the new packages: a bare lock in
    control/ or autoscale/ is a finding, as in serve/ or fleet/."""
    import textwrap

    from heat2d_tpu_torch.analysis import lint
    for pkg in ("control", "autoscale"):
        p = tmp_path / "pkg" / pkg / "mod.py"
        p.parent.mkdir(parents=True)
        p.write_text(textwrap.dedent("""
            import threading

            LOCK = threading.Lock()
            """))
    fs = lint.lint_tree(str(tmp_path), rules=["R006"])
    assert sorted(f.path for f in fs) == ["pkg/autoscale/mod.py",
                                          "pkg/control/mod.py"]


# --------------------------------------------------------------------- #
# end to end: one shared pool of real worker subprocesses
# --------------------------------------------------------------------- #

PROBE = {"nx": tff.NX, "ny": tff.NY, "steps": tff.STEPS,
         "cx": 0.123, "cy": 0.1, "method": "jnp"}


@pytest.fixture(scope="module")
def control_pool(tmp_path_factory):
    """Two workers under the validated db's path (absent at first: no
    db), caches off, the JAX suite's replay budget."""
    d = tmp_path_factory.mktemp("control")
    vp, cp = str(d / "validated.json"), str(d / "candidate.json")
    fs = tff.fleet(workers=2, max_replays=5, env={"HEAT2D_TUNE_DB": vp},
                   cache_size=0, worker_cache_size=0).start()
    with SolveServer(registry=MetricsRegistry(), device="cpu") as one:
        want = np.asarray(one.solve(SolveRequest.from_dict(dict(PROBE)),
                                    timeout=LIMIT).u).tobytes()
    yield types.SimpleNamespace(fs=fs, vp=vp, cp=cp, want=want)
    fs.stop()


def _stage(pool):
    fs = pool.fs
    tff.wait_until(lambda: len(fs.sup.alive_slots()) == 2
                   and not fs._cold)
    ret = Retuner(fs, candidate_path=pool.cp, validated_path=pool.vp)
    ret.hot_signatures()                   # drop earlier tests' demand
    for i in range(3):
        fs.solve(tff.req(cx=0.05 + 0.01 * i), timeout=LIMIT)
    staged = ret.stage_candidate(ret.hot_signatures()[0][0])
    assert staged is not None
    assert staged["epoch"] == TuningDB(pool.vp).epoch + 1
    return staged


def _rollout(pool, **kw):
    cfg = dict(candidate_path=pool.cp, validated_path=pool.vp,
               probe_spec=PROBE, probe_timeout=LIMIT)
    cfg.update(kw)
    return Rollout(pool.fs, RolloutConfig(**cfg),
                   policy=_policy(budget=0.5),
                   registry=pool.fs.registry).run()


def _unvalidated(gens):
    return [g for g in gens
            if not (g["via"] == "rollout" and g.get("overlay"))
            and g.get("tune") is not None
            and not g["tune"].get("validated", True)]


def test_rollout_healthy_candidate_promotes(control_pool):
    """Canary -> bitwise parity -> observe -> promote: the validated db
    advances an epoch and every worker ends up serving it."""
    fs, reg = control_pool.fs, control_pool.fs.registry
    staged = _stage(control_pool)
    out = _rollout(control_pool, observe_s=0.8, observe_probes=2)
    assert out["outcome"] == "promoted", out
    assert [p["phase"] for p in out["phases"]] == [
        "baseline", "canary", "parity", "observe", "promote", "roll"]
    vdb = TuningDB(control_pool.vp)
    assert vdb.epoch == staged["epoch"] and vdb.validated is True
    for s in fs.sup.alive_slots():
        t = (fs.sup.worker_info(s) or {}).get("tune") or {}
        assert t.get("path") == control_pool.vp
        assert t.get("validated") is True
        assert t.get("epoch") == staged["epoch"]
    snap = reg.snapshot()
    assert snap["counters"]["control_rollouts_total{outcome=promoted}"] \
        == 1
    assert snap["counters"]["control_probe_parity_total{result=match}"] \
        >= 1
    assert snap["gauges"]["control_epoch"] == staged["epoch"]
    # the canary generation ran under the candidate, one generation only
    gens = fs.sup.generations_snapshot()
    canary = [g for g in gens if g["via"] == "rollout" and g["overlay"]]
    assert canary[-1]["overlay"] == {"HEAT2D_TUNE_DB": control_pool.cp}
    assert canary[-1]["tune"]["validated"] is False
    assert _unvalidated(gens) == []
    r = SolveRequest.from_dict(dict(PROBE))
    assert np.asarray(fs.solve(r, timeout=LIMIT).u).tobytes() == \
        control_pool.want


def test_rollout_bad_candidate_auto_reverts_bitwise(control_pool):
    """A seeded regression (chaos-slow on the canary's overlay) is
    MEASURED as a latency regression and auto-reverted; post-revert
    answers are bitwise the pre-rollout baseline; nothing non-validated
    survives."""
    fs = control_pool.fs
    epoch0 = TuningDB(control_pool.vp).epoch
    _stage(control_pool)
    out = _rollout(control_pool, observe_s=1.2, observe_probes=3,
                   extra_canary_env={"HEAT2D_CHAOS_SLOW_WORKER_S": "0.6"})
    assert out["outcome"] == "reverted:latency_regression", out
    assert out["post_revert_parity"] is True
    vdb = TuningDB(control_pool.vp)
    assert vdb.epoch == epoch0 and vdb.validated is True
    assert _unvalidated(fs.sup.generations_snapshot()) == []
    assert fs.registry.snapshot()["counters"][
        "control_rollouts_total{outcome=reverted}"] >= 1


def test_rollout_promote_guards_against_midflight_restage(control_pool,
                                                          monkeypatch):
    """If the candidate file changes between observation and promote (a
    concurrent re-stage), the never-canaried content is NOT validated:
    the rollout reverts instead."""
    from heat2d_tpu_torch.control import rollout as rmod

    epoch0 = TuningDB(control_pool.vp).epoch
    real_point = chaos.rollout_point

    def restage_at_promote(phase, kill_cb=None):
        if phase == "promote":
            db = TuningDB(control_pool.cp)
            db.stamp_rollout(epoch=epoch0 + 7, validated=False)
            db.save()
        return real_point(phase, kill_cb)

    monkeypatch.setattr(rmod.chaos, "rollout_point", restage_at_promote)
    _stage(control_pool)
    out = _rollout(control_pool, observe_s=0.5, observe_probes=1)
    assert out["outcome"] == "reverted:candidate_changed_mid_rollout", out
    assert out["post_revert_parity"] is True
    assert TuningDB(control_pool.vp).epoch == epoch0


def test_rollout_kill_storm_never_serves_unvalidated(control_pool):
    """A kill storm in the observation window takes every worker down;
    the rollout auto-reverts with bitwise post-revert parity, and NO
    non-rollout generation ever reported a non-validated config."""
    fs = control_pool.fs
    epoch0 = TuningDB(control_pool.vp).epoch
    restarts0 = sum(1 for g in fs.sup.generations_snapshot()
                    if g["via"] == "restart")
    deaths0 = fs.sup.deaths
    _stage(control_pool)
    chaos.install(chaos.ChaosConfig(rollout_kill_phase="observe",
                                    rollout_kills=0))
    try:
        out = _rollout(control_pool, observe_s=3.0, observe_probes=4)
    finally:
        chaos.uninstall()
    assert out["outcome"].startswith("reverted:"), out
    assert out["post_revert_parity"] is True
    assert fs.sup.deaths >= deaths0 + 2        # the storm landed
    tff.wait_until(lambda: len(fs.sup.alive_slots()) == 2)
    post = np.asarray(fs.solve(SolveRequest.from_dict(dict(PROBE)),
                               timeout=LIMIT).u).tobytes()
    assert post == control_pool.want
    gens = fs.sup.generations_snapshot()
    assert sum(1 for g in gens if g["via"] == "restart") > restarts0
    assert _unvalidated(gens) == []
    assert TuningDB(control_pool.vp).epoch == epoch0


def test_retire_drain_timeout_kills_and_replays_injected_clock(
        control_pool):
    """(``tests/test_autoscale.py``'s case, on the shared pool.) The
    drain deadline on the supervisor's injectable clock: a worker that
    cannot drain in time is killed, and its in-flight request replays
    to the scale-up spawn; nothing is lost."""
    fs = control_pool.fs
    tff.wait_until(lambda: len(fs.sup.alive_slots()) == 2
                   and not fs._cold)
    victim = fs.sup.provisioned_slots()[0]
    on_victim = tff.steps_routed_to(victim, fs.sup.alive_slots())[0]
    fut = fs.submit(tff.req(cx=0.21, steps=on_victim))
    new = fs.add_worker()
    assert new == max(fs.sup.provisioned_slots())
    time.sleep(0.2)                 # the dispatch is in the pipe
    t = [0.0]

    def clk():
        t[0] += 1000.0
        return t[0]

    fs.sup.clock = clk              # every wait expires immediately
    try:
        clean = fs.retire_worker(victim, timeout=5.0)
    finally:
        fs.sup.clock = None
    assert clean is False           # drain timed out -> killed
    res = fut.result(timeout=LIMIT)
    assert res.steps_done == on_victim
    assert fs.registry.snapshot()["counters"][
        "fleet_worker_retirements_total{outcome=unclean}"] == 1
    assert victim not in fs.sup.provisioned_slots()


def test_retire_of_a_starting_worker_stops_its_start(control_pool):
    """A scale-down that lands on a worker still starting (never ready,
    so never routed to) stops the start at once: a clean retirement, no
    generation, and the caller is not held for the rest of the start."""
    fs = control_pool.fs
    before = fs.registry.snapshot()["counters"].get(
        "fleet_worker_retirements_total{outcome=clean}", 0)
    slot = fs.add_worker()
    assert fs.retire_worker(slot, timeout=30.0) is True
    assert slot not in fs.sup.provisioned_slots()
    assert all(g["slot"] != slot for g in fs.sup.generations_snapshot())
    assert fs.registry.snapshot()["counters"][
        "fleet_worker_retirements_total{outcome=clean}"] == before + 1
    r = tff.req(cx=0.37)
    tff.check_answers([r], [fs.solve(r, timeout=LIMIT)])


# --------------------------------------------------------------------- #
# the CLI's control legs
# --------------------------------------------------------------------- #

def test_fleet_cli_storm_mid_rollout(tmp_path):
    """``heat2d-tpu-torch-fleet --control-rollout --control-storm-phase
    observe`` on the CPU: the storm lands, the rollout reverts, no worker
    generation serves unvalidated, every answer bitwise the oracle; the
    kind='fleet' and kind='control' records beside each other."""
    out = tmp_path / "fleet.jsonl"
    rc = fleet_cli.main(["--workers", "2", "--soak", "4",
                         "--control-rollout", "--control-storm-phase",
                         "observe", "--control-observe", "1.5",
                         "--concurrency", "4", "--device", "cpu",
                         "--control-db", str(tmp_path / "db"),
                         "--metrics-out", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    runs = {r["kind"]: r for r in recs if r.get("event") == "run_record"}
    fleet_rec, ctl = runs["fleet"], runs["control"]
    assert fleet_rec["completed"] == fleet_rec["submitted"] > 0
    assert fleet_rec["failures"] == []
    assert fleet_rec["control"]["no_unvalidated_serving"] is True
    assert fleet_rec["control"]["rollout_outcome"].startswith("reverted:")
    assert ctl["no_unvalidated_serving"] is True
    assert ctl["rollouts"][0]["post_revert_parity"] is True
    assert [d["action"] for d in ctl["decisions"]][:1] == ["rollout"]
    assert ctl["validated_path"].endswith("validated.json")
    assert any(g["via"] == "restart" for g in ctl["generation_log"])
    snap = [r for r in recs if r.get("event") == "snapshot"][0]
    assert snap["counters"][
        "resil_chaos_injected_total{point=rollout_kill}"] == 1
