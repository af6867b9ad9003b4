"""The port's serving stack (``heat2d_tpu_torch/serve/``, ``resil/``,
``obs/metrics.py``, ``analysis/locks.py``) on the CPU: request identity
byte-identical to the JAX package's, the pad ladder, the selftest, the
structured rejections of what this slice does not serve, and served
results equal to standalone ensemble runs, bit for bit within the port.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from heat2d_tpu.analysis import locks as jlocks
from heat2d_tpu.models import ensemble as jens
from heat2d_tpu.serve import batcher as jbatcher
from heat2d_tpu.serve import cache as jcache
from heat2d_tpu.serve import engine as jengine
from heat2d_tpu.serve.schema import SolveRequest as JRequest
from heat2d_tpu_torch.analysis import locks as tlocks
from heat2d_tpu_torch.models import ensemble as tens
from heat2d_tpu_torch.obs.metrics import MetricsRegistry
from heat2d_tpu_torch.resil import chaos
from heat2d_tpu_torch.resil.retry import (DegradedMode, RetryPolicy,
                                          TransientError, Watchdog,
                                          call_with_retries)
from heat2d_tpu_torch.serve import batcher as tbatcher
from heat2d_tpu_torch.serve import cache as tcache
from heat2d_tpu_torch.serve import cli as scli
from heat2d_tpu_torch.serve.engine import _pad_capacity
from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest
from heat2d_tpu_torch.serve.server import Client, SolveServer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_chaos():
    chaos.install(None)
    yield
    chaos.uninstall()


@pytest.fixture(autouse=True)
def _lock_audit():
    """The port's lock auditor, armed by HEAT2D_LOCK_AUDIT=1 (the JAX
    package's variable; tests/conftest.py wires the JAX auditor only):
    the test fails on a lock-order cycle or a guarded write without its
    lock."""
    if not tlocks._env_enabled():
        yield
        return
    tlocks.install()
    yield
    rep = tlocks.report()
    tlocks.uninstall()
    assert rep.clean, rep.render()


def _server(**kw):
    kw.setdefault("max_delay", 0.05)
    return SolveServer(registry=MetricsRegistry(), device="cpu", **kw)


# ------------------------------------------------------------------ #
# Request identity: byte-identical to the JAX package
# ------------------------------------------------------------------ #

REQUESTS = [
    dict(nx=24, ny=32, steps=6),
    dict(nx=640, ny=1024, steps=10000, cx=0.05, cy=0.2, method="auto"),
    dict(nx=4096, ny=4096, steps=240, cx=0.1 + 1e-12, method="band"),
    dict(nx=16, ny=16, steps=5, convergence=True, interval=7,
         sensitivity=1e-3, method="pallas"),
    # unused convergence knobs do not enter a fixed-step hash
    dict(nx=16, ny=16, steps=5, interval=99, sensitivity=5.0),
    dict(nx=24, ny=32, steps=4, cx=8.0, cy=6.0, method="adi"),
    dict(nx=16, ny=16, steps=5, method="jnp", problem="heat9"),
    dict(nx=33, ny=17, steps=0, cx=0.25, cy=0.25, method="jnp",
         convergence=True),
    dict(nx=4097, ny=4097, steps=4, cx=51.2, cy=12.8, method="mg"),
    dict(nx=640, ny=1024, steps=10000, cx=0.02, cy=0.15, problem="heat9"),
    dict(nx=4096, ny=4096, steps=240, method="band", problem="advdiff",
         convergence=True, interval=20, sensitivity=3.5),
    dict(nx=16, ny=16, steps=5, method="jnp", problem="varcoef"),
]


@pytest.mark.parametrize("fields", REQUESTS)
def test_hash_and_signature_equal_jax(fields):
    t, j = SolveRequest(**fields), JRequest(**fields)
    assert t.spec() == j.spec()
    assert t.content_hash() == j.content_hash()
    assert t.signature() == j.signature()
    assert repr(t.signature()) == repr(j.signature())


def test_request_fields_equal_jax():
    names = [f.name for f in dataclasses.fields(SolveRequest)]
    assert names == [f.name for f in dataclasses.fields(JRequest)]


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_pad_ladder_equals_jax(cap):
    for n in range(1, 13):
        assert _pad_capacity(n, cap) == jengine._pad_capacity(n, cap)
    assert [_pad_capacity(n, 8) for n in range(1, 9)] == \
        [1, 2, 4, 4, 8, 8, 8, 8]


@pytest.mark.parametrize("fields,name", [
    (dict(problem="reactdiff", method="adi"), "reactdiff"),
    (dict(problem="heat9", method="mg"), "heat9"),
    (dict(problem="varcoef", method="band"), "varcoef"),
    (dict(problem="advdiff", method="adi"), "advdiff"),
])
def test_unsupported_combination_names_it(fields, name):
    """The combinations the capability matrix rules out, rejected with
    the JAX package's message word for word, before any launch."""
    from heat2d_tpu.serve.schema import Rejected as JRejected
    req = SolveRequest(nx=16, ny=16, steps=5, **fields)
    with pytest.raises(Rejected) as e:
        req.validate()
    with pytest.raises(JRejected) as je:
        JRequest(nx=16, ny=16, steps=5, **fields).validate()
    assert e.value.code == je.value.code == "unsupported_combination"
    assert name in e.value.message
    assert e.value.message == je.value.message
    with _server() as srv:
        with pytest.raises(Rejected) as e2:
            Client(srv).solve(req)
    assert e2.value.code == "unsupported_combination"
    assert srv.engine.launches == 0


@pytest.mark.parametrize("fields", [
    dict(method="adi", cx=8.0, cy=6.0),
    dict(method="mg", cx=8.0, cy=6.0),
    dict(problem="heat9"),
    dict(problem="advdiff", method="band"),
    dict(problem="reactdiff", method="pallas"),
    dict(problem="varcoef"),
])
def test_served_methods_and_families_vs_jax(fields):
    """What this port once rejected is served: two same-signature
    requests in one launch, each result bitwise the standalone ensemble
    run and within tolerance of the JAX package's (steps * 66 * 2**-24
    * max|u|, the widest family bound, covers ADI's roundoff here)."""
    kw = dict(nx=20, ny=24, steps=6, **fields)
    scale = [(1.0, 1.0), (0.5, 1.5)]
    reqs = [SolveRequest(**dict(kw, cx=kw.get("cx", 0.1) * a,
                                cy=kw.get("cy", 0.1) * b))
            for a, b in scale]
    with _server() as srv:
        futs = [srv.submit(r) for r in reqs]
        got = [f.result(timeout=60) for f in futs]
    assert srv.engine.launches == 1
    row = srv.engine.launch_log[0]
    assert row["problem"] == kw.get("problem", "heat5")
    cxs, cys = [r.cx for r in reqs], [r.cy for r in reqs]
    method = kw.get("method", "auto")
    problem = kw.get("problem", "heat5")
    want = tens.run_ensemble(20, 24, 6, cxs, cys, method=method,
                             problem=problem, device="cpu").numpy()
    j = np.asarray(jens.run_ensemble(20, 24, 6, cxs, cys, method=method,
                                     problem=problem))
    for m, r in enumerate(got):
        assert r.steps_done == 6
        np.testing.assert_array_equal(r.u, want[m])
        assert np.abs(r.u - j[m]).max() <= 6 * 66 * 2.0 ** -24 * np.abs(
            j[m]).max()
    snap = srv.registry.snapshot()["counters"]
    assert snap[f"problem_requests_total{{problem={problem}}}"] == 1


@pytest.mark.parametrize("fields", [dict(nx=2, ny=8, steps=1),
                                    dict(nx=8, ny=8, steps=-1),
                                    dict(nx=8, ny=8, steps=1,
                                         dtype="float64"),
                                    dict(nx=8, ny=8, steps=1, method="x"),
                                    dict(nx=8, ny=8, steps=1,
                                         convergence=True, interval=0)])
def test_invalid_requests_rejected_like_jax(fields):
    from heat2d_tpu.serve.schema import Rejected as JRejected
    with pytest.raises(JRejected) as je:
        JRequest(**fields).validate()
    with pytest.raises(Rejected) as te:
        SolveRequest(**fields).validate()
    assert te.value.code == je.value.code == "invalid"
    assert te.value.message == je.value.message


def test_from_dict_rejects_unknown_fields():
    with pytest.raises(Rejected, match="unknown request fields"):
        SolveRequest.from_dict(dict(nx=8, ny=8, steps=1, trace="x"))


# ------------------------------------------------------------------ #
# Served results
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("method", ["jnp", "pallas", "band", "auto"])
def test_served_equals_standalone_run_ensemble(method):
    """Three same-signature requests: one launch of capacity 4 (the pad
    member replicates the last), each result bitwise the standalone
    ensemble run of the same (cx, cy)."""
    cxs, cys = [0.05, 0.1, 0.2], [0.1, 0.15, 0.05]
    reqs = [SolveRequest(nx=20, ny=36, steps=13, cx=cx, cy=cy,
                         method=method) for cx, cy in zip(cxs, cys)]
    with _server() as srv:
        client = Client(srv)
        futs = [client.submit(r) for r in reqs]
        got = [f.result(timeout=60) for f in futs]
    assert srv.engine.launches == 1
    row = srv.engine.launch_log[0]
    assert (row["occupancy"], row["capacity"]) == (3, 4)
    assert row["tuned_config"] is None
    want = tens.run_ensemble(20, 36, 13, cxs, cys, method=method,
                             device="cpu").numpy()
    for m, r in enumerate(got):
        assert r.steps_done == 13 and r.batch_size == 3
        np.testing.assert_array_equal(r.u, want[m])
    # ... and within the stated tolerance of the JAX package's ensemble
    j = np.asarray(jens.run_ensemble(20, 36, 13, cxs, cys, method="jnp"))
    tol = 13 * 2.0 ** -21 * np.abs(j).max()
    assert np.abs(np.stack([r.u for r in got]) - j).max() <= tol


@pytest.mark.parametrize("method", ["jnp", "band"])
def test_served_convergence_equals_standalone(method):
    cxs = [0.03125, 0.25, 0.125]
    reqs = [SolveRequest(nx=24, ny=32, steps=57, cx=c, cy=c,
                         convergence=True, interval=8, sensitivity=2.4e6,
                         method=method) for c in cxs]
    with _server() as srv:
        futs = [srv.submit(r) for r in reqs]
        got = [f.result(timeout=60) for f in futs]
    u, k = tens.run_ensemble_convergence(24, 32, 57, 8, 2.4e6, cxs, cxs,
                                         method=method, device="cpu")
    assert [r.steps_done for r in got] == k.tolist()
    assert len(set(k.tolist())) > 1
    for m, r in enumerate(got):
        np.testing.assert_array_equal(r.u, u[m].numpy())


def test_cache_hit_and_coalesced_duplicates_are_bitwise():
    req = SolveRequest(nx=16, ny=24, steps=9, cx=0.2, cy=0.1)
    with _server() as srv:
        a, b = srv.submit(req), srv.submit(req)
        ra, rb = a.result(timeout=60), b.result(timeout=60)
        again = srv.solve(req)
    assert srv.engine.launches == 1
    assert rb.coalesced and not ra.coalesced
    assert again.cache_hit
    assert ra.u.tobytes() == rb.u.tobytes() == again.u.tobytes()
    snap = srv.registry.snapshot()
    assert snap["counters"]["serve_cache_hits_total"] == 1
    assert snap["counters"]["serve_coalesced_total"] == 1


def test_mixed_signatures_launch_separately():
    with _server() as srv:
        futs = [srv.submit(SolveRequest(nx=16, ny=16 + 8 * (i % 2),
                                        steps=3, cx=0.01 * (i + 1)))
                for i in range(6)]
        for f in futs:
            f.result(timeout=60)
    assert srv.engine.launches == 2
    assert sorted(r["occupancy"] for r in srv.engine.launch_log) == [3, 3]


def test_stop_drain_resolves_every_admitted_request():
    srv = _server(max_delay=30.0).start()   # buckets would wait 30 s
    futs = [srv.submit(SolveRequest(nx=8, ny=8, steps=1, cx=0.01 * i))
            for i in range(1, 4)]
    srv.stop(drain=True)
    assert all(f.done() for f in futs)
    assert [f.result().steps_done for f in futs] == [1, 1, 1]
    late = srv.submit(SolveRequest(nx=8, ny=8, steps=1, cx=0.5))
    with pytest.raises(Rejected) as e:
        late.result(timeout=5)
    assert e.value.code == "shutdown"


def test_queue_full_is_shed_at_the_door():
    srv = _server(max_queue=1)      # not started: nothing drains
    with srv.batcher._cond:         # a guarded field: write it locked
        srv.batcher._running = True     # admit without a scheduler thread
    srv.submit(SolveRequest(nx=8, ny=8, steps=1, cx=0.1))
    f = srv.submit(SolveRequest(nx=8, ny=8, steps=1, cx=0.2))
    with pytest.raises(Rejected) as e:
        f.result(timeout=5)
    assert e.value.code == "queue_full"
    with srv.batcher._cond:
        srv.batcher._running = False
    srv.stop()


def test_queue_timeout_rejects():
    gate = threading.Event()
    srv = _server(max_batch=1, max_delay=0.0)
    real = srv.engine.solve_batch

    def slow(reqs):
        gate.wait(10)
        return real(reqs)

    srv.engine.solve_batch = slow
    with srv:
        first = srv.submit(SolveRequest(nx=8, ny=8, steps=1, cx=0.1))
        late = srv.submit(SolveRequest(nx=8, ny=8, steps=1, cx=0.2),
                          timeout=0.05)
        time.sleep(0.3)
        gate.set()
        first.result(timeout=30)
        with pytest.raises(Rejected) as e:
            late.result(timeout=30)
    assert e.value.code == "timeout"


def test_injected_launch_failure_is_retried():
    reg = MetricsRegistry()
    chaos.install(chaos.ChaosConfig(fail_launches=1), registry=reg)
    srv = SolveServer(registry=reg, device="cpu", max_delay=0.01,
                      retry_policy=RetryPolicy(base_delay=0.0))
    with srv:
        r = srv.solve(SolveRequest(nx=8, ny=8, steps=2))
    assert r.steps_done == 2
    c = reg.snapshot()["counters"]
    assert c["serve_retries_total"] == 1
    assert c["resil_chaos_injected_total{point=launch_failure}"] == 1


def test_watchdog_times_out_a_slow_launch():
    chaos.install(chaos.ChaosConfig(launch_latency_s=0.5))
    srv = _server(launch_deadline=0.1, max_delay=0.01)
    with srv:
        with pytest.raises(Rejected) as e:
            srv.solve(SolveRequest(nx=8, ny=8, steps=2))
    assert e.value.code == "watchdog_timeout"
    snap = srv.registry.snapshot()["counters"]
    assert snap["serve_watchdog_timeouts_total"] == 1


def test_breaker_sheds_fresh_work_but_serves_cache_hits():
    breaker = DegradedMode(threshold=1, cooldown=60)
    srv = _server(breaker=breaker, max_delay=0.01,
                  retry_policy=RetryPolicy(max_attempts=1))
    warm = SolveRequest(nx=8, ny=8, steps=1)
    with srv:
        srv.solve(warm)
        chaos.install(chaos.ChaosConfig(fail_launches=1))
        with pytest.raises(chaos.ChaosError):
            srv.solve(SolveRequest(nx=8, ny=8, steps=1, cx=0.2))
        assert breaker.state == "open"
        with pytest.raises(Rejected) as e:
            srv.solve(SolveRequest(nx=8, ny=8, steps=1, cx=0.3))
        assert e.value.code == "degraded"
        assert srv.solve(warm).cache_hit


def test_server_raises_without_a_card(monkeypatch):
    from heat2d_tpu_torch.utils.device import DeviceUnavailableError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="CUDA"):
        SolveServer()


# ------------------------------------------------------------------ #
# The CLI
# ------------------------------------------------------------------ #

def test_selftest_passes_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "m.jsonl"
    assert scli.main(["--selftest", "--device", "cpu", "--metrics-out",
                      str(out)]) == 0
    assert "selftest passed" in capsys.readouterr().out
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines[0]["event"] == "snapshot"
    rec = lines[-1]
    assert rec["event"] == "run_record" and rec["kind"] == "serve"
    assert rec["selftest_failures"] == []
    assert rec["launches"] == len(rec["launch_log"]) < rec[
        "selftest_requests"]
    assert rec["device"]["platform"] == "cpu"


def test_requests_file_mode(tmp_path, capsys):
    path = tmp_path / "req.jsonl"
    rows = [dict(nx=12, ny=12, steps=3, cx=0.1), dict(nx=12, ny=12,
                                                     steps=3, cx=0.2),
            dict(nx=12, ny=12, steps=3, method="adi"),
            dict(nx=12, ny=12, steps=3, bogus=1),
            dict(nx=12, ny=12, steps=3, method="adi", problem="reactdiff")]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    scli.main(["--requests", str(path), "--device", "cpu"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [o.get("rejected") for o in out] == [
        None, None, None, "invalid", "unsupported_combination"]
    assert out[2]["steps_done"] == 3
    assert out[0]["shape"] == [12, 12] and out[0]["steps_done"] == 3


def test_requests_results_out_writes_the_stdout_rows(tmp_path, capsys):
    """``--results-out PATH`` (the JAX serve CLI's flag): the summaries
    ``--requests`` prints, one JSON line per request in order, go to the
    file instead, and stdout stays empty of them."""
    path = tmp_path / "req.jsonl"
    rows = [dict(nx=12, ny=12, steps=3, cx=0.1),
            dict(nx=12, ny=12, steps=3, bogus=1),
            dict(nx=12, ny=12, steps=3, method="adi")]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    assert scli.main(["--requests", str(path), "--device", "cpu"]) == 0
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    out = tmp_path / "results.jsonl"
    assert scli.main(["--requests", str(path), "--device", "cpu",
                      "--results-out", str(out)]) == 0
    assert capsys.readouterr().out == ""
    written = [json.loads(x) for x in out.read_text().splitlines()]
    keep = ("rejected", "content_hash", "steps_done", "shape",
            "max_temperature", "total_heat")
    assert [{k: r.get(k) for k in keep} for r in written] == \
        [{k: r.get(k) for k in keep} for r in printed]
    assert [r.get("rejected") for r in written] == [None, "invalid", None]


# ------------------------------------------------------------------ #
# resil, metrics, locks
# ------------------------------------------------------------------ #

def test_retry_policy_and_classification():
    p = RetryPolicy(base_delay=0.1, backoff=3.0, max_delay=0.5)
    assert [p.delay(i) for i in range(4)] == pytest.approx([0.1, 0.3, 0.5,
                                                            0.5])
    assert p.delay(10 ** 6) == 0.5
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("again")
        return "ok"

    assert call_with_retries(flaky, p, sleep=sleeps.append) == "ok"
    assert sleeps == pytest.approx([0.1, 0.3])
    with pytest.raises(Rejected):
        call_with_retries(lambda: (_ for _ in ()).throw(
            Rejected("x", "y")), p, sleep=sleeps.append)
    with pytest.raises(RuntimeError):   # a CUDA error: terminal
        call_with_retries(lambda: (_ for _ in ()).throw(
            RuntimeError("CUDA error")), p, sleep=sleeps.append)
    assert len(sleeps) == 2


def test_degraded_mode_cycle():
    now = [0.0]
    b = DegradedMode(threshold=2, cooldown=1.0, clock=lambda: now[0])
    b.record_failure()
    assert b.allow()
    b.record_failure()
    assert b.state == "open" and not b.allow()
    now[0] = 1.5
    assert b.allow() and not b.allow()   # one half-open probe
    b.record_success()
    assert b.state == "closed" and b.trips == 1


def test_watchdog_fires_once():
    fired = []
    with Watchdog(0.01, lambda: fired.append(1)) as wd:
        time.sleep(0.1)
    assert wd.fired and fired == [1]
    with Watchdog(None, lambda: fired.append(2)) as wd:
        pass
    assert not wd.fired


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"HEAT2D_CHAOS_FAIL_LAUNCHES": "0"}, None),
    ({"HEAT2D_CHAOS_FAIL_LAUNCHES": "2"}, chaos.ChaosConfig(2, 0.0)),
    ({"HEAT2D_CHAOS_LAUNCH_LATENCY_S": "0.5"}, chaos.ChaosConfig(0, 0.5)),
])
def test_chaos_env(env, want):
    assert chaos.ChaosConfig.from_env(env) == want


def test_chaos_env_is_strict():
    with pytest.raises(ValueError, match="FAIL_LAUNCHES"):
        chaos.ChaosConfig.from_env({"HEAT2D_CHAOS_FAIL_LAUNCHES": "lots"})


def test_metrics_registry(tmp_path):
    r = MetricsRegistry(hist_cap=4)
    r.counter("serve_requests_total", outcome="completed")
    r.counter("serve_requests_total", 2, outcome="completed")
    r.gauge("serve_queue_depth", 3)
    for v in range(10):
        r.observe("serve_launch_s", float(v))
    with r.timer("serve_e2e_latency_s"):
        pass
    s = r.snapshot()
    assert s["counters"]["serve_requests_total{outcome=completed}"] == 3
    assert s["gauges"]["serve_queue_depth"] == 3
    h = s["histograms"]["serve_launch_s"]
    assert (h["count"], h["sum"], h["min"], h["max"]) == (10, 45.0, 0.0,
                                                          9.0)
    path = tmp_path / "m.jsonl"
    r.write_jsonl(str(path), extra_records=[{"event": "run_record"}])
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["event"] for x in lines] == ["snapshot", "run_record"]
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]


def test_lock_declarations_equal_jax():
    for t, j in [(tcache.ResultCache, jcache.ResultCache),
                 (tbatcher.MicroBatcher, jbatcher.MicroBatcher)]:
        assert tlocks.GUARDS[t] == jlocks._GUARDS[j]
    assert isinstance(tlocks.AuditedCondition(), threading.Condition)
    with pytest.raises(ValueError):
        tlocks.guarded_by("_lock")
