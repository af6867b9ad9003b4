"""``heat2d_tpu_torch/load`` against ``heat2d_tpu/load`` on the CPU.

The cases of ``tests/test_load.py`` (schedules, seeded synthesis and its
analytic shapes, trace replay, the open-loop runner against a fake
target, the capacity model, the gate, the CLI end to end) run on the
port; where both stacks take the same inputs (a profile and seed, a
schedule file, a signature, a spans directory, surface rows, a baseline
document, a fake target's script) the outputs must be equal: the same
fingerprints, spec dicts, fits, advice, failure lists and texts,
outcome counts and row keys. End to end on ``--device cpu``: the
selftest, the serve-target gate round trip, replay fidelity against a
live server, and one pool of two real workers through the CLI.

Each wait is bounded by ``LIMIT`` seconds.
"""

from __future__ import annotations

import json
import random
import statistics
import threading
import time
import types
from concurrent.futures import Future

import pytest

from heat2d_tpu.load import capacity as jcap
from heat2d_tpu.load import gate as jgate
from heat2d_tpu.load import replay as jreplay
from heat2d_tpu.load import runner as jrunner
from heat2d_tpu.load import schedule as jschedule
from heat2d_tpu.load import synth as jsynth
from heat2d_tpu.obs import MetricsRegistry as JRegistry
from heat2d_tpu.obs import tracing as jtracing
from heat2d_tpu.serve import schema as jschema
from heat2d_tpu_torch.load import capacity as cap_mod
from heat2d_tpu_torch.load import gate as gate_mod
from heat2d_tpu_torch.load import replay as replay_mod
from heat2d_tpu_torch.load import runner as runner_mod
from heat2d_tpu_torch.load import schedule as schedule_mod
from heat2d_tpu_torch.load import synth
from heat2d_tpu_torch.load.runner import measure_point, run_schedule
from heat2d_tpu_torch.load.schedule import Arrival, Schedule
from heat2d_tpu_torch.obs import MetricsRegistry, tracing
from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest

LIMIT = 60.0
SMOKE = synth.PROFILES["smoke"]

STACKS = {
    "port": types.SimpleNamespace(
        schedule=schedule_mod, synth=synth, replay=replay_mod,
        runner=runner_mod, cap=cap_mod, gate=gate_mod,
        Registry=MetricsRegistry, Rejected=Rejected,
        SolveRequest=SolveRequest),
    "jax": types.SimpleNamespace(
        schedule=jschedule, synth=jsynth, replay=jreplay,
        runner=jrunner, cap=jcap, gate=jgate, Registry=JRegistry,
        Rejected=jschema.Rejected, SolveRequest=jschema.SolveRequest),
}
BOTH_WAYS = [("port", "jax"), ("jax", "port")]


@pytest.fixture(autouse=True)
def _no_tracer(monkeypatch):
    """No campaign from the environment, and no tracer of either package
    left behind."""
    for k in ("HEAT2D_TRACE_DIR", "HEAT2D_FLIGHT_DIR"):
        monkeypatch.delenv(k, raising=False)
    yield
    for mod in (tracing, jtracing):
        mod.uninstall()


def _solve_arrival(t, steps=3, tenant="default", ns=None):
    cls = (ns or STACKS["port"]).schedule.Arrival
    return cls(t=t, kind="solve",
               spec={"nx": 12, "ny": 12, "steps": steps,
                     "cx": 0.1, "cy": 0.1, "method": "jnp"},
               tenant=tenant)


def _error_text(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


# --------------------------------------------------------------------- #
# schedules
# --------------------------------------------------------------------- #

def test_schedule_sorts_scales_and_roundtrips(tmp_path):
    sched = Schedule([_solve_arrival(2.0), _solve_arrival(0.0),
                      _solve_arrival(1.0)], meta={"source": "test"})
    assert [a.t for a in sched] == [0.0, 1.0, 2.0]
    assert sched.duration() == 2.0
    assert sched.inter_arrivals() == [1.0, 1.0]
    fast = sched.scaled(2.0)
    assert [a.t for a in fast] == [0.0, 0.5, 1.0]
    assert fast.offered_rps() == pytest.approx(2 * sched.offered_rps())
    path = tmp_path / "sched.jsonl"
    sched.to_jsonl(str(path))
    back = Schedule.from_jsonl(str(path))
    assert back.fingerprint() == sched.fingerprint()
    assert back.meta == {"source": "test"}
    assert _error_text(lambda: sched.scaled(0.0)) \
        == "speedup must be > 0, got 0.0"


def test_schedule_signatures_and_summary():
    sched = Schedule([_solve_arrival(0.0, steps=3),
                      _solve_arrival(0.5, steps=3),
                      _solve_arrival(1.0, steps=4, tenant="batch")])
    sigs = sched.signatures()
    assert len(sigs) == 2 and sum(sigs.values()) == 3
    s = sched.summary()
    assert s["arrivals"] == 3
    assert s["tenants"] == {"default": 2, "batch": 1}
    assert s["kinds"] == {"solve": 3}
    jsched = jschedule.Schedule([_solve_arrival(a.t, a.spec["steps"],
                                                a.tenant, STACKS["jax"])
                                 for a in sched])
    assert jsched.summary() == s
    assert {k: v for k, v in jsched.signatures().items()} == sigs
    assert schedule_mod.SCHEDULE_SCHEMA == jschedule.SCHEDULE_SCHEMA
    assert schedule_mod.ARRIVAL_KINDS == jschedule.ARRIVAL_KINDS


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_schedule_file_crosses_stacks(tmp_path, writer, reader):
    w, r = STACKS[writer], STACKS[reader]
    sched = w.synth.synthesize(w.synth.PROFILES["production"], 30.0, 2.0,
                               seed=3)
    assert any(a.kind == "inverse" for a in sched)
    path = tmp_path / "sched.jsonl"
    sched.to_jsonl(str(path))
    back = r.schedule.Schedule.from_jsonl(str(path))
    assert back.fingerprint() == sched.fingerprint()
    assert back.meta == sched.meta
    assert back.summary() == sched.summary()


# --------------------------------------------------------------------- #
# seeded synthesis: determinism, the JAX package's draws, analytic shapes
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(jsynth.PROFILES))
def test_synthesize_fingerprints_equal_jax(name, seed):
    ours = synth.synthesize(synth.PROFILES[name], 20.0, 3.0, seed=seed)
    theirs = jsynth.synthesize(jsynth.PROFILES[name], 20.0, 3.0,
                               seed=seed)
    assert len(ours) > 0
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.meta == theirs.meta
    assert dataclasses_equal(synth.PROFILES[name], jsynth.PROFILES[name])


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_same_seed_is_bit_identical_and_seeds_differ():
    a = synth.synthesize(SMOKE, 25.0, 3.0, seed=11)
    b = synth.synthesize(SMOKE, 25.0, 3.0, seed=11)
    c = synth.synthesize(SMOKE, 25.0, 3.0, seed=12)
    assert a.fingerprint() == b.fingerprint()
    assert [(x.t, x.kind, x.tenant, x.spec) for x in a] \
        == [(x.t, x.kind, x.tenant, x.spec) for x in b]
    assert a.fingerprint() != c.fingerprint()


def test_zipf_weights_analytic():
    w = synth.zipf_weights(4, 1.0)
    h = 1 + 0.5 + 1 / 3 + 0.25
    assert w == pytest.approx([1 / h, 0.5 / h, (1 / 3) / h, 0.25 / h])
    assert w == jsynth.zipf_weights(4, 1.0)
    assert synth.zipf_weights(5, 0.0) == pytest.approx([0.2] * 5)
    assert _error_text(lambda: synth.zipf_weights(0, 1.0)) \
        == _error_text(lambda: jsynth.zipf_weights(0, 1.0))


def test_zipf_skew_matches_analytic_weights():
    prof = synth.MixProfile(name="z", signatures=6, zipf_s=1.2)
    sched = synth.synthesize(prof, 300.0, 10.0, seed=3)
    counts = [0] * prof.signatures
    for a in sched:
        counts[a.spec["steps"] - prof.steps] += 1
    n = sum(counts)
    assert n > 1500
    weights = synth.zipf_weights(prof.signatures, prof.zipf_s)
    assert counts[0] / n == pytest.approx(weights[0], abs=0.05)
    assert counts[0] > counts[2] > counts[5]


def test_burst_modulation_shapes_the_process():
    """MMPP bursts: the realized rate exceeds the base rate by about the
    duty-cycle-weighted factor, inter-arrivals are burstier than Poisson
    (CV > 1), and a plain Poisson process sits near CV = 1."""
    prof = synth.MixProfile(name="b", burst_factor=4.0, burst_on_s=1.5,
                            burst_off_s=4.5)
    rate, duration = 60.0, 60.0
    sched = synth.synthesize(prof, rate, duration, seed=5)
    mult = len(sched) / (rate * duration)
    assert 1.25 < mult < 2.4, mult
    gaps = sched.inter_arrivals()
    assert statistics.pstdev(gaps) / statistics.fmean(gaps) > 1.15
    plain = synth.synthesize(synth.PROFILES["uniform"], rate, duration,
                             seed=5)
    gaps_p = plain.inter_arrivals()
    cv_p = statistics.pstdev(gaps_p) / statistics.fmean(gaps_p)
    assert 0.8 < cv_p < 1.2, cv_p


def test_diurnal_modulation_shapes_the_process():
    """With period == duration the sinusoid boosts the first half and
    suppresses the second: analytic ratio (1 + 2a/pi)/(1 - 2a/pi) ~= 3.1
    at a = 0.8."""
    prof = synth.MixProfile(name="d", diurnal_amplitude=0.8,
                            diurnal_period_s=40.0)
    sched = synth.synthesize(prof, 80.0, 40.0, seed=9)
    first = sum(1 for a in sched if a.t < 20.0)
    second = len(sched) - first
    assert second > 0 and first / second > 2.0, (first, second)


def test_tenant_mix_and_quotas():
    from heat2d_tpu_torch.fleet import TenantPolicy
    prof = synth.PROFILES["multitenant"]
    sched = synth.synthesize(prof, 150.0, 8.0, seed=2)
    counts: dict = {}
    for a in sched:
        counts[a.tenant] = counts.get(a.tenant, 0) + 1
    n = sum(counts.values())
    assert counts["interactive"] / n == pytest.approx(0.7, abs=0.08)
    quotas = prof.quotas(100)
    assert all(isinstance(q, TenantPolicy) for q in quotas.values())
    assert quotas["interactive"].priority == 0
    assert quotas["batch"].priority == 1
    assert quotas["interactive"].max_inflight == 70
    assert quotas["batch"].max_inflight == 30
    theirs = jsynth.PROFILES["multitenant"].quotas(100)
    assert {k: (v.max_inflight, v.priority) for k, v in quotas.items()} \
        == {k: (v.max_inflight, v.priority) for k, v in theirs.items()}


def test_inverse_heavy_tail():
    prof = synth.PROFILES["inverse_heavy"]
    sched = synth.synthesize(prof, 150.0, 8.0, seed=4)
    inv = [a for a in sched if a.kind == "inverse"]
    assert 0.08 < len(inv) / len(sched) < 0.35
    iters = [a.spec["iterations"] for a in inv]
    assert all(prof.inverse_iters_min <= i <= prof.inverse_iters_cap
               for i in iters)
    assert len(set(iters)) > 1
    req = inv[0].build_request()
    assert type(req).__module__ == "heat2d_tpu_torch.diff.serving"
    assert req.request_kind == "inverse"
    assert req.signature()[0] == "inverse"


PROFILE_ERRORS = [
    lambda s: s.MixProfile(name="x", signatures=0),
    lambda s: s.MixProfile(name="x", burst_factor=0.5),
    lambda s: s.MixProfile(name="x", diurnal_amplitude=1.0),
    lambda s: s.MixProfile(name="x", inverse_fraction=1.5),
    lambda s: s.MixProfile(name="x", tenants=()),
    lambda s: s.synthesize(s.PROFILES["smoke"], -1.0, 5.0),
    lambda s: s.synthesize(s.PROFILES["smoke"], 5.0, 0.0),
]


@pytest.mark.parametrize("case", range(len(PROFILE_ERRORS)))
def test_profile_and_synthesize_errors_equal_jax(case):
    make = PROFILE_ERRORS[case]
    assert _error_text(lambda: make(synth)) \
        == _error_text(lambda: make(jsynth))


# --------------------------------------------------------------------- #
# trace replay
# --------------------------------------------------------------------- #

def _signatures(ns):
    return [
        ns.SolveRequest(nx=24, ny=16, steps=7, method="pallas"),
        ns.SolveRequest(nx=12, ny=12, steps=9, convergence=True,
                        interval=5, sensitivity=0.2),
        ns.SolveRequest(nx=20, ny=20, steps=5, problem="heat9"),
        ns.SolveRequest(nx=20, ny=24, steps=3, problem="advdiff",
                        convergence=True, interval=2, sensitivity=0.5),
    ]


def _inverse(ns):
    if ns is STACKS["port"]:
        from heat2d_tpu_torch.diff.serving import InverseRequest
    else:
        from heat2d_tpu.diff.serving import InverseRequest
    return [InverseRequest(nx=8, ny=8, steps=4, obs_indices=(9, 12),
                           obs_values=(1.0, 2.0), iterations=16),
            InverseRequest(nx=10, ny=8, steps=6, obs_indices=(11,),
                           obs_values=(0.5,), iterations=3, segment=2)]


@pytest.mark.parametrize("i", range(6))
def test_spec_from_signature_equal_jax(i):
    reqs = _signatures(STACKS["port"]) + _inverse(STACKS["port"])
    jreqs = _signatures(STACKS["jax"]) + _inverse(STACKS["jax"])
    sig = reqs[i].signature()
    assert sig == jreqs[i].signature()
    assert len(sig) in (8, 9)
    kind, spec = replay_mod.spec_from_signature(sig, random.Random(i))
    jkind, jspec = jreplay.spec_from_signature(sig, random.Random(i))
    assert (kind, spec) == (jkind, jspec)
    assert kind == ("inverse" if sig[0] == "inverse" else "solve")
    built = Arrival(t=0.0, kind=kind, spec=spec).build_request()
    assert built.signature() == sig


def test_spec_from_signature_pre_registry_tuple_is_heat5():
    sig = SolveRequest(nx=12, ny=12, steps=3).signature()
    assert len(sig) == 8
    kind, spec = replay_mod.spec_from_signature(sig, random.Random(0))
    assert "problem" not in spec
    assert SolveRequest.from_dict(spec).problem == "heat5"


@pytest.mark.parametrize("sig", [("bogus",), (), ["not", "a", "tuple"],
                                 ("inverse", 1, 2),
                                 (12, 12, 3, "float32", "jnp"),
                                 tuple(range(10))])
def test_malformed_signatures_raise_the_jax_texts(sig):
    assert _error_text(lambda: replay_mod.spec_from_signature(
        sig, random.Random(0))) == _error_text(
            lambda: jreplay.spec_from_signature(sig, random.Random(0)))


def _write_spans(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _spans_dir(tmp_path):
    """The spans directory of ``tests/test_load.py``: three fleet roots,
    a worker-side serve.request nested under one of them, and a cli.run
    root without a signature."""
    sig = str(SolveRequest(nx=12, ny=12, steps=3,
                           method="jnp").signature())

    def root(tid, t0, tenant="default", name="fleet.request"):
        return {"event": "span", "service": "router", "pid": 1,
                "trace_id": tid, "span_id": "s" + tid,
                "parent_id": None, "name": name, "kind": "request",
                "t0": t0, "t1": t0 + 0.1,
                "attrs": {"signature": sig, "tenant": tenant}}

    recs = [root("a", 100.0), root("b", 100.5, tenant="batch"),
            root("c", 101.75),
            {"event": "span", "service": "worker0", "pid": 2,
             "trace_id": "a", "span_id": "w1", "parent_id": "sa",
             "name": "serve.request", "kind": "request",
             "t0": 100.01, "t1": 100.09, "attrs": {"signature": sig}},
            {"event": "span", "service": "cli", "pid": 3,
             "trace_id": "d", "span_id": "s4", "parent_id": None,
             "name": "cli.run", "kind": "request",
             "t0": 99.0, "t1": 102.0, "attrs": {}}]
    _write_spans(tmp_path / "spans-router-1.jsonl", recs)
    return sig


def test_schedule_from_trace_dir(tmp_path):
    sig = _spans_dir(tmp_path)
    sched = replay_mod.schedule_from_trace_dir(str(tmp_path), seed=0)
    assert len(sched) == 3
    assert [a.t for a in sched] == pytest.approx([0.0, 0.5, 1.75])
    assert [a.tenant for a in sched] == ["default", "batch", "default"]
    assert str(sched.arrivals[0].build_request().signature()) == sig
    assert sched.meta["source"] == "replay"
    again = replay_mod.schedule_from_trace_dir(str(tmp_path), seed=0)
    assert again.fingerprint() == sched.fingerprint()
    theirs = jreplay.schedule_from_trace_dir(str(tmp_path), seed=0)
    assert theirs.fingerprint() == sched.fingerprint()
    assert theirs.meta == sched.meta
    limited = replay_mod.schedule_from_trace_dir(str(tmp_path), limit=2)
    assert limited.fingerprint() == jreplay.schedule_from_trace_dir(
        str(tmp_path), limit=2).fingerprint()
    assert replay_mod.ROOT_SPAN_NAMES == jreplay.ROOT_SPAN_NAMES


def test_schedule_from_trace_dir_errors_equal_jax(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    _write_spans(empty / "spans-x-1.jsonl", [])
    text = _error_text(lambda: replay_mod.schedule_from_trace_dir(
        str(empty)))
    assert "no request root spans" in text
    assert text == _error_text(lambda: jreplay.schedule_from_trace_dir(
        str(empty)))
    bad = tmp_path / "bad"
    bad.mkdir()
    _write_spans(bad / "spans-x-1.jsonl", [{
        "event": "span", "trace_id": "t", "span_id": "s",
        "parent_id": None, "name": "serve.request", "t0": 1.0,
        "t1": 2.0, "attrs": {"signature": "(12, 12"}}])
    text = _error_text(lambda: replay_mod.schedule_from_trace_dir(
        str(bad)))
    assert text.startswith("unparseable signature in trace")
    assert text == _error_text(lambda: jreplay.schedule_from_trace_dir(
        str(bad)))


# --------------------------------------------------------------------- #
# open-loop runner (fake targets: no server, no sleeping)
# --------------------------------------------------------------------- #

class _FakeTarget:
    """``tests/test_load.py``'s fake: answers every submit per
    ``script(i)`` -> None (complete) or an exception; optional service
    delay on a background thread."""

    units = 2

    def __init__(self, script=None, delay=0.0):
        self.script = script or (lambda i: None)
        self.delay = delay
        self.submitted = []

    def submit(self, req, tenant, timeout):
        i = len(self.submitted)
        self.submitted.append((req, tenant))
        fut: Future = Future()
        exc = self.script(i)

        def finish():
            if exc is None:
                fut.set_result(None)
            else:
                fut.set_exception(exc)

        if self.delay:
            threading.Timer(self.delay, finish).start()
        else:
            finish()
        return fut

    def close(self):
        pass


def _fast_schedule(ns, n=40, gap=0.01):
    return ns.schedule.Schedule([_solve_arrival(i * gap, ns=ns)
                                 for i in range(n)])


def _shed_script(ns):
    def script(i):
        if i % 4 == 1:
            return ns.Rejected("queue_full", "full")
        if i % 4 == 2:
            return ns.Rejected("timeout", "late")
        if i % 4 == 3:
            return RuntimeError("boom")
        return None
    return script


def test_run_schedule_measures_and_keeps_fidelity():
    reg = MetricsRegistry()
    row = run_schedule(_fast_schedule(STACKS["port"]), _FakeTarget(), reg,
                       warmup=False)
    assert row["arrivals"] == row["answered"] == 40
    assert row["completed"] == 40 and row["shed"] == 0
    assert row["achieved_rps"] > 0
    assert row["fidelity"]["p99_skew_s"] < 0.25
    snap = reg.snapshot()
    assert snap["counters"]["load_requests_total{outcome=completed}"] == 40
    assert snap["histograms"]["load_submit_skew_s"]["count"] == 40
    assert snap["histograms"]["load_e2e_latency_s"]["count"] == 40


def test_run_schedule_outcomes_and_keys_equal_jax():
    """The same fake script through both runners: shed (queue_full),
    timeout and error classes counted alike, and the same row keys."""
    rows = {}
    for name, ns in STACKS.items():
        rows[name] = ns.runner.run_schedule(
            _fast_schedule(ns), _FakeTarget(_shed_script(ns)),
            ns.Registry(), warmup=False)
    port, jax_ = rows["port"], rows["jax"]
    assert port["completed"] == 10
    assert port["outcomes"]["rejected_queue_full"] == 10
    assert port["outcomes"]["rejected_timeout"] == 10
    assert port["outcomes"]["error"] == 10
    assert port["shed"] == 10
    assert port["shed_rate"] == pytest.approx(0.25)
    assert port["outcomes"] == jax_["outcomes"]
    for k in ("arrivals", "answered", "unanswered", "offered_rps",
              "completed", "shed", "shed_rate", "speedup"):
        assert port[k] == jax_[k], k
    assert set(port) == set(jax_)
    assert set(port["fidelity"]) == set(jax_["fidelity"])
    assert set(port["latency"]) == set(jax_["latency"])
    assert runner_mod.SHED_CODES == jrunner.SHED_CODES


def test_run_schedule_warmup_covers_each_signature():
    sched = Schedule([_solve_arrival(0.0, steps=3),
                      _solve_arrival(0.01, steps=4),
                      _solve_arrival(0.02, steps=3)])
    target = _FakeTarget()
    target.max_batch = 4
    run_schedule(sched, target, None, warmup=True)
    # 2 distinct signatures x the capacity ladder (1+2+4 bursts)
    # + 3 measured arrivals
    assert len(target.submitted) == 2 * 7 + 3
    warm = [r for r, _t in target.submitted[:14]]
    assert len({r.content_hash() for r in warm}) == 14
    jtarget = _FakeTarget()
    jtarget.max_batch = 4
    jsched = jschedule.Schedule([_solve_arrival(a.t, a.spec["steps"],
                                                ns=STACKS["jax"])
                                 for a in sched])
    again = _FakeTarget()
    again.max_batch = 4
    assert jrunner.warm_target(jtarget, jsched) \
        == runner_mod.warm_target(again, sched) == 14
    assert [r.content_hash() for r, _t in jtarget.submitted] \
        == [r.content_hash() for r, _t in again.submitted] \
        == [r.content_hash() for r in warm]


def test_measure_point_evaluates_slo():
    from heat2d_tpu_torch.obs.slo import SLOPolicy
    row = measure_point(_fast_schedule(STACKS["port"], 20), _FakeTarget(),
                        warmup=False,
                        slo_policy=SLOPolicy(latency_p99_s=5.0))
    assert row["slo_ok"] is True
    assert row["slo"] and all(r["ok"] for r in row["slo"])
    assert isinstance(row.pop("_registry"), MetricsRegistry)
    slow = measure_point(
        _fast_schedule(STACKS["port"], 20), _FakeTarget(delay=0.06),
        warmup=False, slo_policy=SLOPolicy(latency_p99_s=0.005))
    assert slow["slo_ok"] is False
    assert any(not r["latency_ok"] for r in slow["slo"])


# --------------------------------------------------------------------- #
# capacity model
# --------------------------------------------------------------------- #

def _row(offered, achieved, shed=0.0, slo_ok=True, p99=0.01):
    return {"offered_rps": offered, "achieved_rps": achieved,
            "shed_rate": shed, "slo_ok": slo_ok,
            "latency": {"p99": p99, "p50": p99 / 2}}


def test_fit_capacity_finds_the_knee():
    rows = [_row(4, 4), _row(8, 8), _row(16, 12, slo_ok=False),
            _row(32, 12, shed=0.3)]
    fit = cap_mod.fit_capacity(rows, units=2)
    assert fit["max_sustainable_rps"] == 8
    assert fit["per_unit_rps"] == 4
    assert fit["saturated"] is True
    assert fit["qualifying_points"] == 2
    assert cap_mod.units_for(fit, 10) == 3
    assert cap_mod.sustainable_at(fit, 4) == 16
    unsat = cap_mod.fit_capacity([_row(4, 4), _row(8, 7.5)], units=1)
    assert unsat["max_sustainable_rps"] == 7.5
    assert unsat["saturated"] is False
    none = cap_mod.fit_capacity([_row(8, 2), _row(16, 2)], units=2)
    assert none["max_sustainable_rps"] == 0.0
    assert cap_mod.units_for(none, 10) is None
    assert cap_mod.chips_for(none, 10) is None


def _seeded_rows(seed):
    rng = random.Random(seed)
    rows = []
    for i in range(rng.randint(1, 6)):
        off = round(rng.uniform(0.5, 200.0), 4)
        rows.append(_row(off, round(off * rng.uniform(0.3, 1.05), 4),
                         shed=rng.choice([0.0, 0.0, 0.005, 0.2]),
                         slo_ok=rng.random() > 0.2,
                         p99=rng.uniform(0.001, 2.0)))
    return rows, rng


@pytest.mark.parametrize("seed", range(8))
def test_capacity_model_equal_jax(seed):
    rows, rng = _seeded_rows(seed)
    units, cpu = rng.randint(1, 4), rng.randint(1, 4)
    kw = {"chips_per_unit": cpu, "keepup_margin": rng.choice([0.1, 0.2]),
          "max_shed_rate": rng.choice([0.0, 0.01])}
    fit = cap_mod.fit_capacity(rows, units, **kw)
    assert fit == jcap.fit_capacity(rows, units, **kw)
    assert cap_mod.CAPACITY_MODEL == jcap.CAPACITY_MODEL
    for target in (0.5, 7.0, 350.0):
        assert cap_mod.units_for(fit, target) == jcap.units_for(fit,
                                                                target)
        assert cap_mod.chips_for(fit, target) == jcap.chips_for(fit,
                                                                target)
    for n in (1, 3):
        assert cap_mod.sustainable_at(fit, n) == jcap.sustainable_at(fit,
                                                                     n)
    for observed, current in ((5.0, 1), (120.0, 2), (0.0, 3)):
        assert cap_mod.advise(fit, observed, current) \
            == jcap.advise(fit, observed, current)


@pytest.mark.parametrize("args", [([], 0), ([], 1, 0)])
def test_fit_capacity_errors_equal_jax(args):
    rows, units, *cpu = args
    kw = {"chips_per_unit": cpu[0]} if cpu else {}
    assert _error_text(lambda: cap_mod.fit_capacity(rows, units, **kw)) \
        == _error_text(lambda: jcap.fit_capacity(rows, units, **kw))


# --------------------------------------------------------------------- #
# the gate
# --------------------------------------------------------------------- #

GATE_CASES = {
    "healthy": ([_row(4, 4, p99=0.02), _row(8, 8, p99=0.04)], []),
    "regressed": ([_row(4, 1.8, p99=0.6, shed=0.3),
                   _row(8, 3.5, p99=0.9, shed=0.4, slo_ok=False)],
                  ["throughput regression", "latency regression",
                   "shed-rate regression", "capacity regression"]),
    "shrunk": ([_row(4, 4, p99=0.02)], ["never measured"]),
    "unpartnered": ([_row(40, 40)], ["no baseline partner",
                                     "compared nothing"]),
}


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_failures_equal_jax(case, writer, reader):
    """A baseline built by either stack gates in the other, and both
    stacks' compare give the same failure list, verbatim."""
    w, r = STACKS[writer], STACKS[reader]
    base_rows = GATE_CASES["healthy"][0]
    base = w.gate.build_baseline(base_rows,
                                 w.cap.fit_capacity(base_rows, units=2),
                                 meta={"profile": "t"})
    doc = json.loads(json.dumps(base))
    assert doc["schema"] == gate_mod.BASELINE_SCHEMA \
        == jgate.BASELINE_SCHEMA
    rows, expect = GATE_CASES[case]
    fit = r.cap.fit_capacity(rows, units=2)
    fails = r.gate.compare(rows, fit, doc)
    assert fails == w.gate.compare(rows, fit, doc)
    text = "\n".join(fails)
    assert bool(fails) == bool(expect)
    for phrase in expect:
        assert phrase in text, (phrase, fails)
    margins = r.gate.GateMargins(throughput_margin=0.1, p99_factor=1.5,
                                 p99_slack_s=0.0, shed_slack=0.0,
                                 capacity_margin=0.1)
    wm = w.gate.GateMargins(**vars(margins))
    assert r.gate.compare(rows, fit, doc, margins) \
        == w.gate.compare(rows, fit, doc, wm)


def test_gate_refuses_unknown_schema_and_empty_baselines():
    rows = [_row(4, 4)]
    fit = cap_mod.fit_capacity(rows, units=1)
    for doc in ({"schema": "nope"}, {"schema": gate_mod.BASELINE_SCHEMA}):
        assert gate_mod.compare(rows, fit, doc) \
            == jgate.compare(rows, fit, doc) != []
    assert gate_mod.MATCH_TOLERANCE == jgate.MATCH_TOLERANCE
    assert vars(gate_mod.GateMargins()) == vars(jgate.GateMargins())


# --------------------------------------------------------------------- #
# the CLI end to end on the CPU, and the kind="load" record
# --------------------------------------------------------------------- #

def _read_record(path):
    recs = [json.loads(line) for line in open(path)]
    return [r for r in recs if r.get("event") == "run_record"][0]


def _jax_payload_keys(monkeypatch) -> set:
    """The payload keys of the JAX CLI's kind="load" record, from its
    ``_write_metrics`` with the writer captured."""
    from heat2d_tpu.load import cli as jcli
    from heat2d_tpu.obs import record as jrecord
    got = {}
    monkeypatch.setattr(jrecord, "write_run_jsonl",
                        lambda reg, path, kind, extra: got.update(
                            kind=kind, extra=extra))
    args = jcli.build_parser().parse_args(["--selftest"])
    rows = [_row(4, 4)]
    jcli._write_metrics(args, JRegistry(), rows,
                        jcap.fit_capacity(rows, 1), None, [])
    assert got["kind"] == "load"
    return set(got["extra"])


def test_cli_selftest_writes_load_record(tmp_path, monkeypatch):
    from heat2d_tpu_torch.load import cli
    from heat2d_tpu_torch.obs.record import RECORD_KINDS

    assert "load" in RECORD_KINDS
    out = tmp_path / "load.jsonl"
    assert cli.main(["--selftest", "--device", "cpu",
                     "--metrics-out", str(out)]) == 0
    rec = _read_record(out)
    assert rec["kind"] == "load"
    assert rec["device"]["platform"] == "cpu"
    assert rec["capacity"]["model"] == cap_mod.CAPACITY_MODEL
    assert rec["surface"] and rec["surface"][0]["completed"] >= 1
    assert rec["failures"] == []
    payload = _jax_payload_keys(monkeypatch)
    assert payload <= set(rec)
    envelope = set(rec) - payload
    assert envelope <= {"kind", "schema", "timestamp", "torch_version",
                        "device", "world", "event"}


def test_cli_gate_roundtrip_catches_seeded_regression(tmp_path):
    """Measure a healthy baseline on the serve target, gate a healthy
    re-run (pass), then a chaos-slowed run (fail); the in-process chaos
    campaign is gone after the run."""
    from heat2d_tpu_torch.load import cli
    from heat2d_tpu_torch.resil import chaos

    base = tmp_path / "base.json"
    args = ["--profile", "smoke", "--rate", "12", "--duration", "2",
            "--seed", "5", "--target", "serve", "--slo-p99", "5",
            "--device", "cpu"]
    assert cli.main(args + ["--write-baseline", str(base)]) == 0
    doc = json.loads(base.read_text())
    assert doc["schema"] == gate_mod.BASELINE_SCHEMA
    assert doc["meta"]["profile"] == "smoke"

    out = tmp_path / "healthy.jsonl"
    assert cli.main(args + ["--gate", "--baseline", str(base),
                            "--metrics-out", str(out)]) == 0
    assert _read_record(out)["gate"]["passed"] is True

    out2 = tmp_path / "slow.jsonl"
    assert cli.main(args + ["--gate", "--baseline", str(base),
                            "--chaos-slow", "1.0",
                            "--metrics-out", str(out2)]) == 1
    rec2 = _read_record(out2)
    assert rec2["gate"]["passed"] is False
    assert rec2["gate"]["failures"]
    assert rec2["chaos_slow_s"] == 1.0
    assert chaos.controller() is None


def test_cli_replay_fidelity_against_live_server(tmp_path):
    """Record a traced serve run on the port, replay it through the CLI
    against a fresh server, and hold the fidelity bound; the JAX replay
    reads the same directory into the same schedule."""
    from heat2d_tpu_torch.load import cli
    from heat2d_tpu_torch.serve.server import SolveServer

    trace_dir = tmp_path / "tr"
    tracing.install(tracing.Tracer(str(trace_dir), service="serve"))
    try:
        with SolveServer(max_delay=0.01, registry=MetricsRegistry(),
                         device="cpu") as srv:
            futs = []
            for i in range(6):
                time.sleep(0.03)
                futs.append(srv.submit(SolveRequest(
                    nx=12, ny=12, steps=3, cx=0.05 + 0.01 * i,
                    method="jnp")))
            for f in futs:
                f.result(LIMIT)
    finally:
        tracing.uninstall()

    assert replay_mod.schedule_from_trace_dir(str(trace_dir)).fingerprint() \
        == jreplay.schedule_from_trace_dir(str(trace_dir)).fingerprint()
    out = tmp_path / "replay.jsonl"
    assert cli.main(["--replay", str(trace_dir), "--target", "serve",
                     "--max-skew", "0.5", "--device", "cpu",
                     "--metrics-out", str(out)]) == 0
    rec = _read_record(out)
    assert rec["source"] == "replay"
    row = rec["surface"][0]
    assert row["arrivals"] == row["completed"] == 6
    assert row["fidelity"]["p99_skew_s"] <= 0.5
    assert 10 < row["offered_rps"] < 400


def test_cli_fleet_target_with_real_workers(tmp_path):
    """Two worker processes on the CPU behind the CLI's fleet target:
    every arrival answered, the fit counted over 2 units, exit 0."""
    from heat2d_tpu_torch.load import cli

    out = tmp_path / "fleet.jsonl"
    assert cli.main(["--target", "fleet", "--workers", "2", "--profile",
                     "smoke", "--rate", "8", "--duration", "2",
                     "--device", "cpu", "--metrics-out", str(out)]) == 0
    rec = _read_record(out)
    assert rec["target"] == "fleet" and rec["workers"] == 2
    row = rec["surface"][0]
    assert row["unanswered"] == 0 and row["arrivals"] >= 1
    assert row["completed"] == row["arrivals"]
    assert rec["capacity"]["units"] == 2


def test_cli_nothing_to_do_and_unknown_profile(capsys):
    from heat2d_tpu_torch.load import cli
    assert cli.main(["--device", "cpu"]) == 2
    assert "nothing to do" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="unknown --profile 'nope'"):
        cli.main(["--profile", "nope", "--device", "cpu"])
