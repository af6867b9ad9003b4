"""The port's performance observatory (``heat2d_tpu_torch/obs``: perf,
perf_cli, and the roofline stamps on the serve and mesh launch rows)
against the JAX package's (``heat2d_tpu/obs/perf.py``), on the CPU.

Held against the JAX package: a cost card carries every key of the JAX
card (the XLA-only ``generated_code_bytes`` and ``hlo_bytes_per_cell``
None) and its boundary model; the duty-cycle sampler and the anomaly
sentinel, fed the same spans and registries, give the same duty and the
same findings; the cost-card join of ``--stats``.

Port-only: the card's FLOPs and bytes are the roofline model's at the
launch's plan and its boundary bytes the operands' and results' own
(100% of the model on the batch route); extraction failures are counted,
never raised, and cached; every serve and mesh launch row is stamped,
cards made once per key when armed; ``HEAT2D_PERF_DIR`` arms the
observer; ``heat2d-tpu-torch-perf`` (--roofline, --card and its gate,
--watch, and --soak refused with the module it needs).
"""

import itertools
import json
import os

import pytest

from heat2d_tpu.obs import perf as jperf
from heat2d_tpu.obs import roofline as jroofline
from heat2d_tpu.obs import trace_cli as jtrace_cli
from heat2d_tpu.obs import tracing as jtracing
from heat2d_tpu.obs.metrics import MetricsRegistry as JRegistry
from heat2d_tpu_torch.models import ensemble
from heat2d_tpu_torch.obs import perf, perf_cli, roofline, trace_cli, tracing
from heat2d_tpu_torch.obs.metrics import MetricsRegistry
from heat2d_tpu_torch.serve.schema import SolveRequest


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for k in ("HEAT2D_TRACE_DIR", "HEAT2D_FLIGHT_DIR", "HEAT2D_PERF_DIR",
              "HEAT2D_PERF"):
        monkeypatch.delenv(k, raising=False)
    yield
    for mod in (tracing, jtracing):
        mod.uninstall()
    perf.uninstall()
    perf._env_checked = False


META = {"signature": "s", "nx": 16, "ny": 24, "steps": 5, "method": "jnp",
        "convergence": False, "capacity": 2, "dtype": "float32",
        "problem": "heat5", "route": "batch"}


def _launch(meta=META):
    runner = ensemble.batch_runner(meta["nx"], meta["ny"], meta["steps"],
                                   meta["method"], device="cpu")
    n = meta["capacity"]
    cxs, cys, u0 = ensemble._validated_batch(
        meta["nx"], meta["ny"], [0.1] * n, [0.2] * n, None, "cpu")
    watch = perf.LaunchWatch(u0.device)
    out = runner(u0, cxs, cys)
    return runner, (u0, cxs, cys), out, watch


def _jax_card(meta=META):
    import jax.numpy as jnp

    from heat2d_tpu.models import ensemble as jens
    runner = jens.batch_runner(meta["nx"], meta["ny"], meta["steps"],
                               meta["method"])
    n = meta["capacity"]
    args = (jnp.zeros((n, meta["nx"], meta["ny"]), jnp.float32),
            jnp.full((n,), 0.1, jnp.float32),
            jnp.full((n,), 0.2, jnp.float32))
    return jperf.extract_cost_card(runner, args, meta=meta)


def test_card_has_the_jax_cards_keys():
    runner, args, out, watch = _launch()
    card = perf.extract_cost_card(runner, args, meta=META, outputs=out,
                                  watch=watch)
    jcard = _jax_card()
    assert set(jcard) <= set(card)
    assert set(card) - set(jcard) == {"kernel", "plan", "registers",
                                      "local_bytes"}
    assert set(card["model"]) == set(jcard["model"])
    assert card["schema"] == jcard["schema"] == perf.PERF_SCHEMA
    assert card["model"]["boundary_bytes"] == \
        jcard["model"]["boundary_bytes"]
    # the XLA-only fields, and what the CPU cannot watch
    assert card["generated_code_bytes"] is None
    assert card["model"]["hlo_bytes_per_cell"] is None
    assert card["temp_bytes"] is None is card["peak_bytes"]
    assert card["registers"] is None and card["backend"] == "cpu"


@pytest.mark.parametrize("method,steps,kernel", [
    ("jnp", 5, None), ("pallas", 30, "H5"), ("band", 30, "H6/H7")])
def test_card_counts_from_the_launch_plan(method, steps, kernel):
    meta = dict(META, method=method, steps=steps)
    runner, args, out, watch = _launch(meta)
    card = perf.extract_cost_card(runner, args, meta=meta, outputs=out,
                                  watch=watch)
    cells = 2 * 16 * 24
    m = roofline.analytic_bytes_per_cell_step(16, 24, method=method,
                                              steps=steps, batch=2)
    assert card["kernel"] == kernel and card["plan"] == m["model"]
    assert card["flops"] == 7.0 * cells * steps
    assert card["bytes_accessed"] == pytest.approx(
        m["bytes_per_cell_step"] * cells * steps)
    assert card["argument_bytes"] == 4 * cells + 2 * 2 * 4
    assert card["output_bytes"] == 4 * cells
    assert card["model"]["boundary_agreement_pct"] == 100.0
    assert card["arithmetic_intensity"] == round(
        card["flops"] / card["bytes_accessed"], 4)


def test_card_failures_counted_and_cached(tmp_path):
    reg = MetricsRegistry()
    runner, args, out, watch = _launch()
    bad = dict(META, dtype="int8", signature="bad")
    assert perf.extract_cost_card(runner, args, meta=bad,
                                  registry=reg) is None
    assert reg.find_counters("perf_card_failures_total") == {
        (("stage", "model"),): 1.0}
    obs = perf.PerfObserver(registry=reg, dir=str(tmp_path), service="t")
    assert obs.observe(runner, args, bad) is None
    assert obs.seen(bad) and obs.observe(runner, args, bad) is None
    assert reg.find_counters("perf_card_failures_total")[
        (("stage", "model"),)] == 2.0            # probed once, cached
    first = obs.observe(runner, args, META, outputs=out)
    assert obs.observe(runner, args, META) is first
    assert obs.card_for("s", 2, "batch") is first
    obs.close()
    (f,) = [p for p in os.listdir(tmp_path) if p.startswith("cost-cards-t")]
    lines = (tmp_path / f).read_text().splitlines()
    assert [json.loads(x)["signature"] for x in lines] == ["s"]
    assert trace_cli.load_cost_cards(str(tmp_path)) == \
        jtrace_cli.load_cost_cards(str(tmp_path))


def _span(t0, t1, lane="serve", pid=1):
    return {"event": "span", "kind": "launch", "service": lane,
            "pid": pid, "span_id": f"{t0}-{t1}", "t0": t0, "t1": t1}


def test_duty_cycle_equals_jax():
    feed = [_span(998.5, 999.2), _span(999.0, 999.5), _span(999.8, 1000.0),
            {"event": "span_start", "kind": "launch", "service": "mesh",
             "pid": 2, "span_id": "o", "t0": 999.0},
            {"event": "span", "kind": "queue", "service": "serve",
             "pid": 1, "span_id": "q", "t0": 999.0, "t1": 1000.0}]
    t, j = perf.DutyCycleSampler(window_s=2.0), \
        jperf.DutyCycleSampler(window_s=2.0)
    for rec in feed:
        t.feed(rec)
        j.feed(rec)
    for now in (1000.0, 1000.5, 1100.0):
        assert t._sample(now) == j._sample(now)
    assert t.snapshot() == j.snapshot()


def test_duty_sampler_rides_the_tracer(tmp_path):
    reg = MetricsRegistry()
    s = perf.DutyCycleSampler(reg, window_s=1.0, interval_s=0.01)
    tracing.install(tracing.Tracer(str(tmp_path), service="serve"))
    tracing.add_span_tap(s.feed)
    s.start()
    try:
        import time
        t0 = time.monotonic()
        tracing.emit("serve.launch", t0 - 0.5, t0, kind="launch")
        time.sleep(0.1)
    finally:
        s.stop()
        tracing.remove_span_tap(s.feed)
    assert s.samples >= 1 and reg.find_gauges("perf_duty_cycle")


def _drive(sentinel, reg, windows, latency, sig="sig", n=3):
    out = []
    for w in range(windows):
        for i in range(n):
            reg.counter("serve_signature_requests_total",
                        signature=sig, outcome="completed")
            reg.observe("serve_signature_latency_s", latency(w, i),
                        signature=sig)
        reg.gauge("perf_pct_of_bound", 20.0 - (5.0 if w > 9 else 0.0),
                  signature=sig)
        out.append(sentinel.tick(reg))
    return out


@pytest.mark.parametrize("latency", [
    lambda w, i: 0.02 + (0.5 if w >= 8 else 0.001 * (i % 2)),
    lambda w, i: 0.02 * (1 + 0.2 * ((w + i) % 3))])
def test_sentinel_findings_equal_jax(latency):
    def clock():
        c = itertools.count()
        return lambda: float(next(c))
    t = perf.AnomalySentinel(warmup=3, sustain=2, clock=clock())
    j = jperf.AnomalySentinel(warmup=3, sustain=2, clock=clock())
    got = _drive(t, MetricsRegistry(), 14, latency)
    want = _drive(j, JRegistry(), 14, latency)
    assert got == want
    assert t.findings == j.findings


def _reqs(n, **kw):
    return [SolveRequest(nx=16, ny=24, steps=20, cx=0.05 + 0.01 * i,
                         cy=0.1, **kw) for i in range(n)]


@pytest.mark.parametrize("kw", [dict(method="jnp"), dict(method="auto"),
                                dict(method="band", convergence=True,
                                     interval=5, sensitivity=1e-30)])
def test_serve_rows_stamped_and_carded_once(kw):
    from heat2d_tpu_torch.serve.engine import EnsembleEngine
    reg = MetricsRegistry()
    eng = EnsembleEngine(registry=reg, max_batch=4, device="cpu")
    eng.solve_batch(_reqs(2, **kw))               # no observer: no card
    obs = perf.PerfObserver(registry=reg)
    perf.install(obs)
    eng.solve_batch(_reqs(2, **kw))
    eng.solve_batch(_reqs(2, **kw))
    eng.solve_batch(_reqs(3, **kw))               # capacity 4: a new key
    jkeys = {"achieved_mcells_per_s", "bound_mcells_per_s",
             "pct_of_bound", "bytes_per_cell_step", "mcells_per_hbm_byte",
             "route", "elapsed_s"}
    for row in eng.launch_log:
        p = row["perf"]
        assert jkeys <= set(p) and p["achieved_mcells_per_s"] > 0
        assert p["bound_mcells_per_s"] is None        # no card, no bound
        assert p["elapsed_s"] == round(row["run_s"], 6)
    assert [c["capacity"] for c in obs.cards()] == [2, 4]
    assert reg.find_counters("perf_cost_cards_total") == {
        (("route", "batch"),): 2.0}
    assert reg.find_counters("perf_launches_stamped_total") == {(): 4.0}


def test_mesh_rows_stamped():
    from heat2d_tpu_torch.mesh import MeshEnsembleEngine
    from heat2d_tpu_torch.parallel.mesh import host_devices
    reg = MetricsRegistry()
    perf.install(perf.PerfObserver(registry=reg))
    eng = MeshEnsembleEngine(registry=reg, max_batch_per_chip=2,
                             devices=host_devices(2, "cpu"))
    eng.solve_batch(_reqs(3, method="jnp"))
    row = eng.launch_log[-1]
    assert row["perf"]["achieved_mcells_per_s"] > 0
    assert row["perf"]["route"] == "jnp"
    (card,) = perf.observer().cards()
    assert card["route"] == "mesh_batch" and card["capacity"] == 4


def test_env_arming(tmp_path, monkeypatch):
    monkeypatch.setenv("HEAT2D_PERF_DIR", str(tmp_path))
    perf._env_checked = False
    assert perf.enabled() and perf.observer().dir == str(tmp_path)
    perf.uninstall()
    assert not perf.enabled()                # an explicit uninstall wins
    assert perf.launch_watch(META, "cpu") is None


def test_perf_cli(tmp_path, capsys):
    assert perf_cli.main(["--roofline", "640x1024,4096x4096", "--steps",
                          "240", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [(r["route"], r["kernel"]) for r in rows] == [
        ("resident", "H4"), ("tile", "H2/H3")]
    b = roofline.roofline_bound(4096, 4096, steps=240,
                                device_kind=roofline.H100_KIND)
    assert rows[1]["bound_mcells_per_s"] == round(
        b["bound_mcells_per_s"], 1)
    assert perf_cli.main(["--roofline", "64x64", "--device-kind",
                          "cpu"]) == 0
    assert "| 64x64 | resident | H4 |" in capsys.readouterr().out
    assert perf_cli.main(["--card", "16x24", "--steps", "3", "--method",
                          "jnp", "--batch", "2", "--device", "cpu",
                          "--gate-model-pct", "1", "--json"]) == 0
    card = json.loads(capsys.readouterr().out.splitlines()[0])
    assert card["model"]["boundary_agreement_pct"] == 100.0
    assert perf_cli.main(["--soak", "1"]) == 2
    assert "control.plane.ControlPlane" in capsys.readouterr().err
    assert perf_cli.main([]) == 2
    (tmp_path / "cost-cards-t-1.jsonl").write_text(json.dumps(
        {"signature": "SIG", "kernel": "H5", "plan": "p",
         "bytes_accessed": 1.0}) + "\n")
    assert perf_cli.main(["--watch", str(tmp_path), "--watch-ticks", "1",
                          "--json"]) == 0
    assert "SIG: H5 p" in capsys.readouterr().out


def test_stats_join_reads_port_cards_like_jax(tmp_path):
    runner, args, out, watch = _launch()
    obs = perf.PerfObserver(dir=str(tmp_path), service="t")
    obs.observe(runner, args, META, outputs=out)
    obs.close()
    report = {"dir": str(tmp_path), "traces": [
        {"signature": "s", "connected": True,
         "breakdown": {"launch": 1.0}}]}
    cards = trace_cli.load_cost_cards(str(tmp_path))
    assert trace_cli.segment_stats(report, cards) == \
        jtrace_cli.segment_stats(report, jtrace_cli.load_cost_cards(
            str(tmp_path)))
    assert trace_cli.segment_stats(report, cards)["launch"]["hbm_bytes"] \
        == round(cards["s"]["bytes_accessed"], 1)
    assert jroofline.boundary_bytes(16, 24, batch=2)["total_bytes"] == \
        cards["s"]["model"]["measured_boundary_bytes"]
