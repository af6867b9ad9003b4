"""``heat2d_tpu_torch/fleet`` against ``heat2d_tpu/fleet`` on the CPU.

Three tiers, after ``tests/test_fleet.py``:

- the wire, both ways: a line either stack writes decodes in the other
  with the grid bit for bit; torn lines are skipped;
- the router's state machines against a fake supervisor: every scripted
  case of ``tests/test_fleet.py`` (and the probe, pre-emptive shed and
  retirement-fence cases of the control and autoscale suites) runs
  through both stacks with the same events, and the outcomes, the
  dispatched lines and the counters must be equal;
- real worker subprocesses on ``device="cpu"`` under injected faults:
  two pools (two workers; one worker) and the CLI soak, at most two
  workers each. Every answer is bitwise the port's one-process
  ``SolveServer``'s and within ``tests/test_torch_serve.py``'s bound
  (``steps * 66 * 2**-24 * max|u|``) of the JAX ``SolveServer``'s.

Each wait on a worker is bounded by ``LIMIT`` seconds.
"""

import io
import json
import random
import time
import types

import numpy as np
import pytest

from heat2d_tpu import fleet as jfleet
from heat2d_tpu.fleet import wire as jwire
from heat2d_tpu.obs import MetricsRegistry as JRegistry
from heat2d_tpu.resil import retry as jretry
from heat2d_tpu.serve import schema as jschema
from heat2d_tpu_torch import fleet as tfleet
from heat2d_tpu_torch.fleet import wire as twire
from heat2d_tpu_torch.fleet.supervisor import Supervisor, WorkerHandle
from heat2d_tpu_torch.obs import MetricsRegistry
from heat2d_tpu_torch.resil import retry as tretry
from heat2d_tpu_torch.serve import schema as tschema
from heat2d_tpu_torch.serve.server import SolveServer
from heat2d_tpu_torch.tune.db import TuningDB

NX, NY, STEPS = 16, 16, 4
LIMIT = 60.0

STACKS = {
    "port": types.SimpleNamespace(
        FleetServer=tfleet.FleetServer, TenantPolicy=tfleet.TenantPolicy,
        WorkerGone=tfleet.WorkerGone, wire=twire,
        Registry=MetricsRegistry, DegradedMode=tretry.DegradedMode,
        Rejected=tschema.Rejected, SolveRequest=tschema.SolveRequest,
        SolveResult=tschema.SolveResult),
    "jax": types.SimpleNamespace(
        FleetServer=jfleet.FleetServer, TenantPolicy=jfleet.TenantPolicy,
        WorkerGone=jfleet.WorkerGone, wire=jwire,
        Registry=JRegistry, DegradedMode=jretry.DegradedMode,
        Rejected=jschema.Rejected, SolveRequest=jschema.SolveRequest,
        SolveResult=jschema.SolveResult),
}


def req(cx=0.1, ns=STACKS["port"], **kw):
    kw.setdefault("nx", NX)
    kw.setdefault("ny", NY)
    kw.setdefault("steps", STEPS)
    kw.setdefault("method", "jnp")
    return ns.SolveRequest(cx=cx, cy=0.1, **kw)


def wait_until(pred, limit=LIMIT):
    deadline = time.monotonic() + limit
    while not pred():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.05)


# --------------------------------------------------------------------- #
# the wire
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_wire_lines_cross_stacks_bitwise(writer, reader):
    w, r = STACKS[writer], STACKS[reader]
    u = (np.random.default_rng(1616).standard_normal((5, 7)) * 1e3
         ).astype(np.float32)
    u[0, 0] = np.float32(np.nextafter(np.float32(1), np.float32(2)))
    res = w.SolveResult(u=u, steps_done=7, content_hash="abc",
                        batch_size=3)
    msg = w.wire.encode_result(41, res)
    # the port's worker writes ``result_line``: the same object, unscanned
    line = (twire.result_line(41, res).decode() if writer == "port"
            else json.dumps(msg))
    assert line.endswith("\n") == (writer == "port")
    assert json.loads(line) == msg
    back = r.wire.decode_result(json.loads(line))
    assert back.steps_done == 7 and back.content_hash == "abc"
    assert back.batch_size == 3
    assert np.asarray(back.u).tobytes() == u.tobytes()
    assert np.asarray(back.u).dtype == np.float32
    rej = json.dumps(w.wire.encode_rejection(3, w.Rejected(
        "queue_full", "depth 9 at limit 8", content_hash="h")))
    got = r.wire.decode_rejection(json.loads(rej))
    assert (got.code, got.message, got.fields) == (
        "queue_full", "depth 9 at limit 8", {"content_hash": "h"})
    other = r.wire.decode_rejection(json.loads(json.dumps(
        w.wire.encode_rejection(4, ValueError("boom")))))
    assert other.code == "error" and "boom" in other.message
    assert w.wire.PROTOCOL == r.wire.PROTOCOL == "heat2d-tpu/fleet-wire/v1"
    assert r.wire.decode_trace({"trace": "garbage"}) is None


def test_supervisor_reader_skips_torn_lines():
    """A worker killed mid-line leaves a torn line: the reader skips it
    and every whole line around it still lands."""
    got = []
    sup = Supervisor(1, on_response=lambda s, m: got.append((s, m)))
    ok = twire.encode_result(5, tschema.SolveResult(
        u=np.ones((2, 2), np.float32), steps_done=1, content_hash="x"))
    lines = [json.dumps({"event": "ready", "pid": 1, "worker": 0}),
             '{"id": 4, "ok": tr', json.dumps(ok),
             json.dumps({"event": "hb", "worker": 0,
                         "launches": {"ens_resident": 3}}),
             "not json at all", '{"id": 6, "ok": false, "rej']
    proc = types.SimpleNamespace(stdout=io.StringIO("\n".join(lines)),
                                 pid=1)
    h = WorkerHandle(0, proc)
    sup._read_loop(h)
    assert h.ready and [m["id"] for _s, m in got] == [5]
    assert h.launches == {"ens_resident": 3}


# --------------------------------------------------------------------- #
# routing and policy
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_signature_equals_jax(seed):
    rng = random.Random(seed)
    for _ in range(64):
        r = req(cx=rng.random(), nx=rng.randint(3, 4096),
                ny=rng.randint(3, 4096), steps=rng.randint(0, 10 ** 4),
                method=rng.choice(["jnp", "auto", "band", "pallas"]))
        sig = str(r.signature())
        alive = sorted(rng.sample(range(8), rng.randint(1, 8)))
        assert tfleet.route_signature(sig, alive) == \
            jfleet.route_signature(sig, alive)
    with pytest.raises(ValueError, match="no alive workers"):
        tfleet.route_signature("s", [])


@pytest.mark.parametrize("kw", [dict(max_inflight=0), dict(priority=-1),
                                dict(max_inflight=-3, priority=2)])
def test_tenant_policy_validation_texts_equal_jax(kw):
    with pytest.raises(ValueError) as te:
        tfleet.TenantPolicy(**kw)
    with pytest.raises(ValueError) as je:
        jfleet.TenantPolicy(**kw)
    assert str(te.value) == str(je.value)


def test_restart_backoff_is_full_jitter_like_jax():
    """The supervisor's restart policy draws the same seeded schedule in
    both stacks (full jitter under a capped exponential)."""
    from heat2d_tpu.fleet import supervisor as jsup
    from heat2d_tpu_torch.fleet import supervisor as tsup
    a, b = random.Random(7), random.Random(7)
    for i in range(12):
        t = tsup.DEFAULT_RESTART_POLICY.delay(i, rng=a)
        assert t == jsup.DEFAULT_RESTART_POLICY.delay(i, rng=b)
        assert 0 <= t < tsup.DEFAULT_RESTART_POLICY.cap(i)
    assert tsup.DEFAULT_RESTART_POLICY.cap(10 ** 4) == 5.0


# --------------------------------------------------------------------- #
# the router against a fake supervisor, both stacks
# --------------------------------------------------------------------- #

class FakeSup:
    """The Supervisor surface the router uses, minus the processes."""

    def __init__(self, ns, alive=(0, 1)):
        self.ns = ns
        self.alive = list(alive)
        self.sent = []                  # (slot, msg) in send order
        self.deaths = 0
        self.restarts = 0

    def alive_slots(self):
        return list(self.alive)

    def generations_snapshot(self):
        return []

    def send(self, slot, obj):
        if slot not in self.alive:
            raise self.ns.WorkerGone(f"worker {slot} is not running")
        self.sent.append((slot, obj))

    def start(self, wait_ready=True):
        return self

    def stop(self, timeout=30.0):
        return True


def make_router(ns, **kw):
    kw.setdefault("registry", ns.Registry())
    fs = ns.FleetServer(workers=2, **kw)
    fs.sup = FakeSup(ns)
    return fs


def answer(ns, fs, slot, msg):
    """Worker-side completion for a dispatched envelope."""
    spec = msg["req"]
    u = np.full((spec["nx"], spec["ny"]), spec["cx"], dtype=np.float32)
    res = ns.SolveResult(u=u, steps_done=spec["steps"],
                         content_hash="computed")
    fs._on_response(slot, ns.wire.encode_result(msg["id"], res))


def outcome(ns, f):
    try:
        r = f.result(timeout=5)
    except ns.Rejected as e:
        return ("rejected", e.code, e.message,
                sorted((k, v) for k, v in e.fields.items()
                       if k != "waited_s"))
    return ("ok", r.steps_done, r.cache_hit, r.coalesced,
            np.asarray(r.u).tobytes())


def case_dispatch_cache_coalesce(ns, out):
    fs = make_router(ns)
    r = req(cx=0.17, ns=ns)
    f1, f2 = fs.submit(r), fs.submit(r)
    assert len(fs.sup.sent) == 1        # ONE dispatch for both
    answer(ns, fs, *fs.sup.sent[0])
    out += [outcome(ns, f1), outcome(ns, f2)]
    r3 = fs.submit(r).result(timeout=5)
    assert r3.cache_hit and len(fs.sup.sent) == 1
    return fs


def case_worker_rejection_is_an_answer(ns, out):
    fs = make_router(ns)
    f = fs.submit(req(ns=ns))
    slot, msg = fs.sup.sent[-1]
    fs._on_response(slot, ns.wire.encode_rejection(
        msg["id"], ns.Rejected("queue_full", "worker side")))
    out += [outcome(ns, f), fs.breaker.state]
    return fs


def case_failover_replays_to_survivor(ns, out):
    fs = make_router(ns)
    f = fs.submit(req(cx=0.3, ns=ns))
    slot0, msg0 = fs.sup.sent[-1]
    fs.sup.alive = [s for s in fs.sup.alive if s != slot0]
    fs._on_worker_lost(slot0)
    slot1, msg1 = fs.sup.sent[-1]
    assert slot1 != slot0 and msg1["id"] != msg0["id"]
    answer(ns, fs, slot1, msg1)
    out += [outcome(ns, f), fs.replays]
    # a LATE answer under the dead worker's old id is dropped
    fs._on_response(slot0, ns.wire.encode_result(
        msg0["id"], ns.SolveResult(u=np.zeros((2, 2), np.float32),
                                   steps_done=1, content_hash="stale")))
    return fs


def case_replay_budget_exhausts(ns, out):
    fs = make_router(ns, max_replays=1)
    f = fs.submit(req(cx=0.4, ns=ns))
    for _ in range(2):
        fs._on_worker_lost(fs.sup.sent[-1][0])
    out.append(outcome(ns, f))
    return fs


def case_parks_and_flushes_on_ready(ns, out):
    fs = make_router(ns)
    fs.sup.alive = []
    f = fs.submit(req(cx=0.5, ns=ns))
    out.append(len(fs._parked))
    fs.sup.alive = [1]
    fs._on_worker_ready(1)
    answer(ns, fs, *fs.sup.sent[-1])
    out.append(outcome(ns, f))
    return fs


def case_deadline_expires_parked(ns, out):
    fs = make_router(ns, default_timeout=0.01)
    fs.sup.alive = []
    f = fs.submit(req(cx=0.6, ns=ns))
    time.sleep(0.05)
    fs._expire_overdue()
    out.append(outcome(ns, f))
    return fs


def case_tenant_quota_and_watermark(ns, out):
    fs = make_router(
        ns, max_inflight=10,
        quotas={"small": ns.TenantPolicy(max_inflight=1),
                "batch": ns.TenantPolicy(max_inflight=10, priority=1)})
    f1 = fs.submit(req(cx=0.61, ns=ns), tenant="small")
    f2 = fs.submit(req(cx=0.62, ns=ns), tenant="small")
    out.append(outcome(ns, f2))
    answer(ns, fs, *fs.sup.sent[-1])
    out.append(outcome(ns, f1))
    fs.submit(req(cx=0.63, ns=ns), tenant="small")
    futs = [fs.submit(req(cx=0.7 + 0.001 * i, ns=ns), tenant="batch")
            for i in range(8)]
    out.append(outcome(ns, futs[-1]))   # the 8th would pass 8/10
    crit = fs.submit(req(cx=0.81, ns=ns))
    out.append(crit.done())             # admitted, waiting on a worker
    return fs


def case_breaker_sheds_fresh_cache_answers(ns, out):
    fs = make_router(ns, breaker=ns.DegradedMode(threshold=1,
                                                 cooldown=60.0))
    warm = req(cx=0.9, ns=ns)
    f = fs.submit(warm)
    answer(ns, fs, *fs.sup.sent[-1])
    out.append(outcome(ns, f))
    fs._on_worker_lost(0)               # a death trips threshold=1
    out.append(outcome(ns, fs.submit(req(cx=0.91, ns=ns))))
    out.append(outcome(ns, fs.submit(warm)))
    return fs


def case_warm_restart_gates_routing(ns, out):
    fs = make_router(ns)
    f = fs.submit(req(cx=0.2, ns=ns))
    slot0, msg0 = fs.sup.sent[-1]
    answer(ns, fs, slot0, msg0)
    out.append(outcome(ns, f))
    other = 1 - slot0
    fs._on_worker_ready(other, restarted=False)
    out.append(sorted(fs._cold))
    fs._on_worker_ready(other, restarted=True)
    warmups = [(s, m) for s, m in fs.sup.sent
               if m.get("event") == "warmup"]
    out.append((sorted(fs._cold), warmups))
    n_before = len(fs.sup.sent)
    f2 = fs.submit(req(cx=0.21, ns=ns))
    out.append(fs.sup.sent[n_before][0])    # avoids the cold slot
    wslot, wmsg = warmups[0]
    fs._on_response(wslot, {"id": wmsg["id"], "ok": True, "warm": True})
    out.append(sorted(fs._cold))
    answer(ns, fs, *fs.sup.sent[n_before])
    out.append(outcome(ns, f2))
    return fs


def case_probe_targets_slot_and_bypasses_cache(ns, out):
    fs = make_router(ns)
    r = req(cx=0.33, ns=ns)
    f = fs.submit(r)
    slot, msg = fs.sup.sent[-1]
    answer(ns, fs, slot, msg)
    out.append(outcome(ns, f))
    out.append(outcome(ns, fs.submit(r)))       # a cache hit
    pf = fs.probe(1 - slot, r)
    pslot, pmsg = fs.sup.sent[-1]
    out.append((pslot, "event" in pmsg))
    answer(ns, fs, pslot, pmsg)
    out.append(outcome(ns, pf))
    probe_only = req(cx=0.9, steps=STEPS + 7, ns=ns)
    fs.probe(1 - slot, probe_only)
    out.append(sorted(fs._hot))         # probes never enter the hot set
    return fs


def case_probe_fails_fast_and_expires(ns, out):
    fs = make_router(ns, default_timeout=0.01)
    f = fs.probe(0, req(cx=0.41, ns=ns))
    late = fs.probe(1, req(cx=0.43, ns=ns))
    fs.sup.alive = [1]
    fs._on_worker_lost(0)
    out.append(outcome(ns, f))
    out.append(outcome(ns, fs.probe(0, req(cx=0.42, ns=ns))))
    time.sleep(0.05)
    fs._expire_overdue()
    out.append(outcome(ns, late))
    return fs


def case_preemptive_shed(ns, out):
    fs = make_router(
        ns, max_inflight=10,
        quotas={"batch": ns.TenantPolicy(max_inflight=10, priority=1)})
    warm = req(cx=0.77, ns=ns)
    f = fs.submit(warm, tenant="batch")
    answer(ns, fs, *fs.sup.sent[-1])
    out.append(outcome(ns, f))
    fs.set_preemptive_shed(0.3)            # watermark 10 -> 3
    futs = [fs.submit(req(cx=0.5 + 0.001 * i, ns=ns), tenant="batch")
            for i in range(4)]
    out.append(outcome(ns, futs[-1]))
    out.append(fs.submit(req(cx=0.81, ns=ns)).done())
    out.append(outcome(ns, fs.submit(warm, tenant="batch")))
    fs.set_preemptive_shed(None)
    with pytest.raises(ValueError) as e:
        fs.set_preemptive_shed(1.5)
    out.append(str(e.value))
    return fs


def case_retiring_fence_and_unclean_drain(ns, out):
    fs = make_router(ns)
    fut = msg = None
    for i in range(16):                 # land an in-flight on slot 1
        f = fs.submit(req(cx=0.4, steps=STEPS + i, ns=ns))
        s, m = fs.sup.sent[-1]
        if s == 1:
            fut, msg = f, m
            break
        answer(ns, fs, s, m)
        f.result(timeout=5)
    assert fut is not None
    fs._on_worker_retiring(1)           # the fence, BEFORE any drain
    n0 = len(fs.sup.sent)
    others = [fs.submit(req(cx=0.5, steps=STEPS + 20 + i, ns=ns))
              for i in range(4)]
    out.append([s for s, _ in fs.sup.sent[n0:]])
    fs.sup.alive.remove(1)
    fs._on_worker_lost(1)
    answer(ns, fs, *fs.sup.sent[-1])
    out.append(outcome(ns, fut))
    for f2, (s, m) in zip(others, fs.sup.sent[n0:n0 + 4]):
        answer(ns, fs, s, m)
        out.append(outcome(ns, f2))
    return fs


def case_kill_storm_mid_scale_up(ns, out):
    fs = make_router(ns)
    f = fs.submit(req(cx=0.2, ns=ns))
    answer(ns, fs, *fs.sup.sent[-1])
    f.result(timeout=5)
    fs.sup.alive.append(2)
    fs._on_worker_ready(2, via="scale_up")
    warmups = [(s, m) for s, m in fs.sup.sent
               if m.get("event") == "warmup"]
    fs.sup.alive.remove(1)
    fs._on_worker_lost(1)
    n0 = len(fs.sup.sent)
    pairs = [fs.submit(req(cx=0.3, steps=STEPS + i, ns=ns))
             for i in range(3)]
    out.append([s for s, _ in fs.sup.sent[n0:]])   # all on the warm one
    fs.sup.alive.remove(0)
    fs._on_worker_lost(0)
    replayed = fs.sup.sent[-3:]
    out.append([s for s, _ in replayed])           # the cold one now
    for s, m in replayed:
        answer(ns, fs, s, m)
    out += [outcome(ns, f2) for f2 in pairs]
    wslot, wmsg = warmups[0]
    fs._on_response(wslot, {"id": wmsg["id"], "ok": True, "warm": True})
    out.append(sorted(fs._cold))
    return fs


CASES = [case_dispatch_cache_coalesce, case_worker_rejection_is_an_answer,
         case_failover_replays_to_survivor, case_replay_budget_exhausts,
         case_parks_and_flushes_on_ready, case_deadline_expires_parked,
         case_tenant_quota_and_watermark,
         case_breaker_sheds_fresh_cache_answers,
         case_warm_restart_gates_routing,
         case_probe_targets_slot_and_bypasses_cache,
         case_probe_fails_fast_and_expires, case_preemptive_shed,
         case_retiring_fence_and_unclean_drain,
         case_kill_storm_mid_scale_up]


def _scripted(case, stack):
    ns = STACKS[stack]
    out = []
    fs = case(ns, out)
    snap = fs.registry.snapshot()
    return {"outcomes": out, "sent": fs.sup.sent,
            "counters": snap["counters"],
            "gauges": snap["gauges"], "replays": fs.replays,
            "histograms": sorted(snap["histograms"])}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_router_scripted_cases_equal_jax(case):
    port, jax_ = _scripted(case, "port"), _scripted(case, "jax")
    assert port == jax_


# --------------------------------------------------------------------- #
# end to end: real worker subprocesses on the CPU
# --------------------------------------------------------------------- #

def fleet(**kw):
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("heartbeat_timeout", 1.5)
    kw.setdefault("device", "cpu")
    return tfleet.FleetServer(**kw)


def check_answers(reqs, results):
    """Bitwise the port's one-process server; within the serve suite's
    bound of the JAX server (f32: XLA contracts to FMA, torch does not)."""
    from heat2d_tpu.serve.server import SolveServer as JServer
    with SolveServer(registry=MetricsRegistry(), device="cpu") as one, \
            JServer(registry=JRegistry()) as jone:
        for r, res in zip(reqs, results):
            got = np.asarray(res.u)
            assert got.tobytes() == np.asarray(
                one.solve(r, timeout=LIMIT).u).tobytes()
            j = np.asarray(jone.solve(req(r.cx, STACKS["jax"],
                                          steps=r.steps), timeout=LIMIT).u)
            assert np.abs(got - j).max() <= (
                r.steps * 66 * 2.0 ** -24 * np.abs(j).max())


def steps_routed_to(slot, alive, n=1):
    """``n`` step counts whose signatures rendezvous onto ``slot``."""
    out = [s for s in range(STEPS, STEPS + 64)
           if tfleet.route_signature(str(req(steps=s).signature()),
                                     alive) == slot]
    return out[:n]


@pytest.fixture(scope="module")
def pool2():
    reg = MetricsRegistry()
    fs = fleet(workers=2, registry=reg).start()
    yield fs, reg
    fs.stop()


def test_fleet_serves_and_fails_over_bitwise(pool2, tmp_path):
    """Requests in flight on a hard-killed worker replay to the survivor;
    every request is answered bitwise; the slot's one-generation overlay
    (a slow worker, a candidate tuning db) is gone after its crash
    restart, which rebuilds from the durable env."""
    fs, reg = pool2
    cand = str(tmp_path / "candidate.json")
    TuningDB(cand).save()
    fs.sup.restart_worker(0, env_overlay={
        "HEAT2D_CHAOS_SLOW_WORKER_S": "0.4", "HEAT2D_TUNE_DB": cand})
    wait_until(lambda: ((fs.sup.worker_info(0) or {}).get("tune")
                        or {}).get("path") == cand)
    wait_until(lambda: 0 not in fs._cold)
    on0, on1 = (steps_routed_to(s, [0, 1])[0] for s in (0, 1))
    reqs = [req(cx=0.05 + 0.01 * i, steps=(on0, on1)[i % 2])
            for i in range(6)]
    futs = [fs.submit(r) for r in reqs]
    time.sleep(0.2)                 # work lands on both workers
    assert any(r.slot == 0 for r in list(fs._records.values()))
    deaths = fs.sup.deaths
    fs.sup.kill_worker(0)
    results = [f.result(timeout=LIMIT) for f in futs]
    wait_until(lambda: len(fs.sup.alive_slots()) == 2
               and fs.sup.deaths == deaths + 1)
    check_answers(reqs, results)
    assert fs.sup.worker_info(0).get("tune") is None
    gens = fs.sup.generations_snapshot()
    assert [g["via"] for g in gens] == ["start", "start", "rollout",
                                        "restart"]
    assert gens[2]["overlay"]["HEAT2D_TUNE_DB"] == cand
    assert gens[3]["overlay"] is None and gens[3]["tune"] is None
    assert all(g["ready_at"] >= g["startup"]["ready"] >= g["spawned_at"]
               for g in gens)
    c = reg.snapshot()["counters"]
    assert c["fleet_worker_deaths_total{cause=exit}"] == 1
    assert c["fleet_requests_total{outcome=completed}"] >= 6
    assert fs.replays >= 1


def test_update_slot_env_durable_and_forced_restart_notifies(pool2,
                                                             tmp_path):
    """``update_slot_env`` outlives a restart; a worker that misses a
    deliberate restart's drain window (timeout 0) is killed and the router
    gets the worker-lost sweep."""
    fs, _reg = pool2
    vali = str(tmp_path / "validated.json")
    TuningDB(vali).save()
    fs.sup.update_slot_env(1, {"HEAT2D_TUNE_DB": vali})
    lost = []
    orig = fs.sup.on_worker_lost
    fs.sup.on_worker_lost = lambda s: (lost.append(s), orig(s))
    try:
        fs.sup.restart_worker(1, timeout=0)
    finally:
        fs.sup.on_worker_lost = orig
    assert lost == [1]
    wait_until(lambda: ((fs.sup.worker_info(1) or {}).get("tune")
                        or {}).get("path") == vali)
    r = req(cx=0.91, steps=steps_routed_to(1, [0, 1])[0])
    check_answers([r], [fs.solve(r, timeout=LIMIT)])


def test_worker_skips_a_torn_line(pool2):
    fs, _reg = pool2
    h = fs.sup._handles[0]
    with h.write_lock:
        h.proc.stdin.write('{"id": 99, "req": {"nx": 16, "n\n')
        h.proc.stdin.flush()
    r = req(cx=0.93, steps=steps_routed_to(0, [0, 1])[0])
    check_answers([r], [fs.solve(r, timeout=LIMIT)])
    assert fs.sup.alive_slots() == [0, 1]


def test_fleet_stop_start_cycle_rearms_monitoring(pool2):
    """A stop()/start() cycle re-arms the monitor, and a stopped fleet
    answers submits with Rejected('shutdown') instead of parking them."""
    fs, _reg = pool2
    assert fs.stop()
    with pytest.raises(tschema.Rejected) as e:
        fs.solve(req(cx=0.42), timeout=5)
    assert e.value.code == "shutdown"
    fs.start()
    assert fs.solve(req(cx=0.43), timeout=LIMIT).steps_done == STEPS
    deaths = fs.sup.deaths
    fs.sup.kill_worker(0)
    wait_until(lambda: fs.sup.deaths == deaths + 1)
    assert fs.solve(req(cx=0.44), timeout=LIMIT).steps_done == STEPS


def test_retire_and_add_worker(pool2):
    fs, reg = pool2
    wait_until(lambda: len(fs.sup.alive_slots()) == 2)
    assert fs.retire_worker(1, timeout=30.0) is True
    assert fs.sup.pool_size() == 1 and fs.sup.provisioned_slots() == [0]
    with pytest.raises(tfleet.WorkerGone):
        fs.sup.send(1, {"event": "ping"})
    assert fs.retire_worker(1) is True          # idempotent
    assert fs.solve(req(cx=0.12, steps=STEPS + 1),
                    timeout=LIMIT).steps_done == STEPS + 1
    assert fs.add_worker() == 2
    wait_until(lambda: 2 in fs.sup.alive_slots() and 2 not in fs._cold)
    r = req(cx=0.13, steps=steps_routed_to(2, [0, 2])[0])
    check_answers([r], [fs.solve(r, timeout=LIMIT)])
    assert fs.sup.pool_size() == 2
    c = reg.snapshot()["counters"]
    assert c["fleet_worker_retirements_total{outcome=clean}"] == 1
    assert fs.stop()


@pytest.fixture(scope="module")
def pool1():
    reg = MetricsRegistry()
    fs = fleet(workers=1, registry=reg, max_replays=5,
               heartbeat_interval=0.1, heartbeat_timeout=0.8,
               per_worker_env={0: {"HEAT2D_CHAOS_WORKER_KILL_AFTER": "3"}}
               ).start()
    yield fs, reg
    fs.stop()


def test_fleet_chaos_env_self_kill_parks_and_recovers(pool1):
    """The worker dies picking up its 3rd request; with no survivor the
    replay parks, and the replacement (a fresh chaos counter) drains it
    and the 4th; nothing is lost."""
    fs, _reg = pool1
    reqs = [req(cx=0.2 + 0.01 * i) for i in range(4)]
    results = [fs.solve(r, timeout=LIMIT) for r in reqs]
    assert fs.sup.deaths >= 1 and fs.sup.restarts >= 1
    check_answers(reqs, results)


def test_fleet_heartbeat_drop_is_detected_and_fenced(pool1):
    """A worker that goes silent but keeps running is declared dead on
    heartbeat age, killed, and replaced; traffic keeps flowing."""
    fs, reg = pool1
    fs.sup.restart_worker(0, env_overlay={
        "HEAT2D_CHAOS_WORKER_KILL_AFTER": "0",      # 0 means off
        "HEAT2D_CHAOS_HEARTBEAT_DROP_AFTER": "25"})
    wait_until(lambda: fs.sup.alive_slots() == [0])
    deaths = fs.sup.deaths
    first = fs.solve(req(cx=0.31), timeout=LIMIT)
    wait_until(lambda: fs.sup.deaths > deaths)
    second = fs.solve(req(cx=0.32), timeout=LIMIT)
    assert first.steps_done == STEPS and second.steps_done == STEPS
    assert reg.snapshot()["counters"].get(
        "fleet_worker_deaths_total{cause=heartbeat}", 0) >= 1


def test_fleet_cli_chaos_soak(tmp_path):
    """End to end through the CLI: 1 of 2 workers killed mid-soak, zero
    incorrect results (bitwise oracle), nothing lost, throughput
    recovered, clean exit; a kind='fleet' run record."""
    from heat2d_tpu_torch.fleet.cli import main

    out = tmp_path / "fleet.jsonl"
    rc = main(["--workers", "2", "--soak", "10", "--window", "3",
               "--chaos", "--concurrency", "4", "--device", "cpu",
               "--metrics-out", str(out)])
    assert rc == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    rec = [r for r in lines if r.get("event") == "run_record"][0]
    assert rec["kind"] == "fleet" and rec["device"] == "cpu"
    assert rec["completed"] == rec["submitted"] > 0
    assert rec["deaths"] >= 1 and rec["restarts"] >= 1
    assert rec["clean_exit"] is True
    assert rec["pre_kill_rps"] > 0
    assert rec["throughput_recovery_s"] is not None
    assert rec["post_restart_rps"] >= 0.8 * rec["pre_kill_rps"]
    snap = [r for r in lines if r.get("event") == "snapshot"][0]
    assert snap["gauges"]["fleet_workers_alive"] == 0
    assert snap["counters"]["fleet_worker_restarts_total"] >= 1
    assert "fleet_e2e_latency_s" in snap["histograms"]
    assert snap["gauges"][
        "fleet_throughput_rps{window=post_restart}"] > 0


@pytest.mark.parametrize("argv,names", [
    (["--soak", "1", "--control-storm-phase", "observe"],
     "require --control-rollout"),
    (["--soak", "1", "--control-bad-candidate"],
     "require --control-rollout"),
    (["--control", "--control-storm-phase", "canary",
      "--control-bad-candidate"], "require --control-rollout"),
    ([], "--soak"),
])
def test_cli_refuses_what_the_port_lacks(argv, names, capsys):
    """The refusals the JAX CLI makes too, with its exit code: the chaos
    flags of the control legs without a rollout to act on, and nothing
    to do without ``--soak`` or ``--autoscale``."""
    from heat2d_tpu.fleet.cli import main as jmain
    from heat2d_tpu_torch.fleet.cli import main
    assert main(argv) == 2
    assert names in capsys.readouterr().err
    assert jmain(argv) == 2
