"""The port's request tracing, flight recorder and trace merger
(``heat2d_tpu_torch/obs``: tracing, flight, trace_cli) and their hook
sites (the solver and serve CLIs, ``SolveServer``, the batcher), against
the JAX package's on the CPU.

Held against the JAX package: span files the port writes, merged by
``heat2d_tpu.obs.trace_cli.merge_report`` and by the port's merger, give
equal reports; a post-mortem the port flushes passes
``heat2d_tpu.obs.flight.load_postmortem`` with its digest verified, and a
torn one is refused by both; the serve and solver CLIs' records carry the
JAX CLIs' ``trace``/``perf``/``slo``/``trace_id``/``residual_trajectory``
keys, with the same inner keys.

Port-only: tracing and streaming on or off give the same grid bit for
bit, the same launch counts and residual reads (the port's counterpart
of the JAX jaxpr pin); a served request is traced end to end and
connected, an untraced server writes nothing; the crash hooks flush on an
unhandled exception and on SIGTERM in a child process; the tracer's
writer under many threads.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from heat2d_tpu.obs import flight as jflight
from heat2d_tpu.obs import trace_cli as jtrace_cli
from heat2d_tpu.obs import tracing as jtracing
from heat2d_tpu_torch.obs import flight, perf, trace_cli, tracing
from heat2d_tpu_torch.obs.metrics import MetricsRegistry
from heat2d_tpu_torch.serve.schema import (SolveRequest, attach_trace,
                                           request_trace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("HEAT2D_TRACE_DIR", "HEAT2D_FLIGHT_DIR", "HEAT2D_PERF_DIR",
       "HEAT2D_PERF")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No campaign from the environment, and no tracer, recorder or
    observer of either package left behind."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    yield
    for mod in (tracing, jtracing):
        mod.set_ambient(None)
        mod.uninstall()
    for mod in (flight, jflight):
        mod.uninstall()
    perf.uninstall()
    perf._env_checked = False


def _spans(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_request_trace_never_changes_identity():
    r = SolveRequest(nx=16, ny=16, steps=4, cx=0.2)
    h, sig = r.content_hash(), r.signature()
    attach_trace(r, tracing.TraceContext("a" * 32, "b" * 16))
    assert request_trace(r).trace_id == "a" * 32
    assert (r.content_hash(), r.signature()) == (h, sig)
    assert r == SolveRequest(nx=16, ny=16, steps=4, cx=0.2)
    with pytest.raises(Exception, match="unknown request fields"):
        SolveRequest.from_dict({"nx": 16, "ny": 16, "steps": 4,
                                "trace": None})


def _write_campaign(d):
    """Two processes' span files: a request whose queue and launch spans
    come from a second service, an event, and a span that never ended."""
    a = tracing.Tracer(d, service="front")
    b = tracing.Tracer(d, service="worker")
    b.pid = a.pid + 1
    b.path = os.path.join(d, f"spans-worker-{b.pid}.jsonl")
    root = a.begin("serve.request", kind="request", content_hash="h1",
                   signature="(16, 16)")
    q = b.begin("serve.queue", kind="queue", parent=root.ctx)
    q.end()
    b.emit_span("serve.launch", q.t0, q.t0 + 0.01, kind="launch",
                parent=root.ctx, first_launch=True)
    b.event("retry", parent=root.ctx)
    root.end(outcome="completed")
    a.begin("serve.request", kind="request", content_hash="h2")
    other = a.begin("cli.run", kind="request")
    a.begin("phase.stencil_chunk", kind="phase", parent=other.ctx).end()
    other.end()
    a.close()
    b.close()


def test_port_span_files_merge_equally_in_both_packages(tmp_path):
    d = str(tmp_path)
    _write_campaign(d)
    files = sorted(os.listdir(d))
    assert [f.split("-")[:2] for f in files] == [["spans", "front"],
                                                 ["spans", "worker"]]
    got, want = trace_cli.merge_report(d), jtrace_cli.merge_report(d)
    assert got == want
    assert got["schema"] == jtrace_cli.MERGE_SCHEMA
    rows = {r["content_hash"]: r for r in got["traces"]}
    assert rows["h1"]["connected"] and rows["h1"]["processes"] == 2
    assert rows["h1"]["breakdown"]["compile"] == pytest.approx(0.01)
    assert rows["h2"]["spans"] == 1         # unfinished, synthesized
    loaded = trace_cli.load_dir(d)
    assert trace_cli.to_chrome(loaded["spans"]) == jtrace_cli.to_chrome(
        jtrace_cli.load_dir(d)["spans"])
    assert trace_cli.segment_stats(got) == jtrace_cli.segment_stats(want)
    assert trace_cli.to_markdown(got) == jtrace_cli.to_markdown(want)


def test_merger_cli_gates(tmp_path, capsys):
    d = str(tmp_path)
    _write_campaign(d)
    out = str(tmp_path / "chrome.json")
    assert trace_cli.main([d, "--assert-connected", "--perfetto-out",
                           out]) == 0
    assert json.load(open(out))["traceEvents"]
    assert trace_cli.main([d, "--require-postmortem"]) == 1
    assert trace_cli.main([d, "--stats", "--format", "json"]) == 0
    assert trace_cli.main([str(tmp_path / "nope")]) == 1
    capsys.readouterr()


def _flushed(tmp_path, ring=4):
    reg = MetricsRegistry()
    reg.counter("serve_requests_total", outcome="completed")
    rec = flight.FlightRecorder(str(tmp_path / "flight-t-1.jsonl"),
                                ring=ring, service="t", registry=reg)
    flight.install(rec, crash_hooks=False)
    tracing.install(tracing.Tracer(sink=lambda r: None, service="t"))
    for i in range(6):
        tracing.begin("serve.request", kind="request", i=i).end()
    flight.note("wire_line", n=1)
    return rec, rec.flush("test")


def test_port_postmortem_verifies_in_both_packages(tmp_path):
    rec, path = _flushed(tmp_path)
    assert path and rec.flush("again") is None          # first flush wins
    for load in (flight.load_postmortem, jflight.load_postmortem):
        got = load(path)
        assert got[0]["event"] == "flight_header"
        assert got[0]["schema"] == jflight.FLIGHT_SCHEMA
        assert got[0]["entries"] == 4                    # the bounded ring
        assert got[-1]["event"] == "metrics_snapshot"
    assert flight.find_postmortems(str(tmp_path)) == [path]
    rep = trace_cli.merge_report(str(tmp_path))
    assert rep == jtrace_cli.merge_report(str(tmp_path))
    assert rep["postmortems"][0]["spans"] >= 1


@pytest.mark.parametrize("tear", ["byte", "sidecar", "truncate"])
def test_torn_postmortem_refused_by_both(tmp_path, tear):
    _, path = _flushed(tmp_path)
    if tear == "byte":
        blob = bytearray(open(path, "rb").read())
        blob[10] ^= 1
        open(path, "wb").write(bytes(blob))
    elif tear == "sidecar":
        os.remove(path + ".digest.json")
    else:
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:len(blob) // 2])
    for load, err in ((flight.load_postmortem,
                       flight.PostmortemCorruptError),
                      (jflight.load_postmortem,
                       jflight.PostmortemCorruptError)):
        with pytest.raises(err):
            load(path)
    rep = trace_cli.merge_report(str(tmp_path))
    assert rep["corrupt_postmortems"] and not rep["postmortems"]


@pytest.mark.parametrize("death,reason,rc", [
    ("raise ValueError('boom')", "unhandled:ValueError", 1),
    ("os.kill(os.getpid(), signal.SIGTERM); time.sleep(30)", "sigterm",
     143)])
def test_crash_hooks_flush_in_a_child(tmp_path, death, reason, rc):
    """A child armed by HEAT2D_FLIGHT_DIR (``maybe_install_from_env``)
    flushes its black box when it dies by an unhandled exception or by
    SIGTERM, and the previous disposition still ends it."""
    code = ("import os, signal, time\n"
            "from heat2d_tpu_torch.obs import flight, tracing\n"
            "flight.maybe_install_from_env(service='child')\n"
            "tracing.install(tracing.Tracer(sink=lambda r: None))\n"
            "tracing.begin('serve.request', kind='request').end()\n"
            + death + "\n")
    env = dict(os.environ, HEAT2D_FLIGHT_DIR=str(tmp_path),
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == rc, r.stderr
    (path,) = flight.find_postmortems(str(tmp_path))
    got = jflight.load_postmortem(path)
    assert got[0]["reason"] == reason and got[0]["service"] == "child"
    assert any(e.get("name") == "serve.request" for e in got)


def test_tracer_writer_under_many_threads(tmp_path):
    """Spans from more threads than cores, switching often: every line
    whole, none lost."""
    t = tracing.Tracer(str(tmp_path), service="stress")
    tracing.install(t)
    n_threads, n_spans = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(n_spans):
                sp = tracing.begin("serve.request", kind="request", i=i)
                tracing.emit("serve.queue", 0.0, 0.0, kind="queue",
                             parent=sp.ctx)
                sp.end()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    tracing.uninstall()
    recs = _spans(t.path)
    assert len(recs) == n_threads * n_spans * 3
    assert t.spans_emitted == n_threads * n_spans * 2
    rep = trace_cli.merge_report(str(tmp_path))
    assert len(rep["traces"]) == n_threads * n_spans
    assert all(r["connected"] for r in rep["traces"])


# --------------------------------------------------------------------- #
# hook sites
# --------------------------------------------------------------------- #

def test_served_request_traced_end_to_end(tmp_path):
    from heat2d_tpu_torch.serve.server import Client, SolveServer

    tracing.install(tracing.Tracer(str(tmp_path), service="serve"))
    reg = MetricsRegistry()
    with SolveServer(registry=reg, device="cpu", max_delay=0.05) as s:
        c = Client(s)
        r = SolveRequest(nx=16, ny=16, steps=4, cx=0.21, method="jnp")
        futs = [c.submit(r), c.submit(SolveRequest(nx=16, ny=16, steps=4,
                                                   cx=0.21, method="jnp"))]
        [f.result(timeout=60) for f in futs]
        # a fresh request object: one already served carries its trace,
        # and a resubmission would join it
        c.solve(SolveRequest(nx=16, ny=16, steps=4, cx=0.21,
                             method="jnp"), timeout=60)    # cache hit
    tracing.uninstall()
    rep = trace_cli.merge_report(str(tmp_path))
    assert rep == jtrace_cli.merge_report(str(tmp_path))
    assert len(rep["traces"]) == 3 and all(
        r["connected"] for r in rep["traces"])
    by_outcome = {r["outcome"]: r for r in rep["traces"]}
    assert set(by_outcome) == {"completed", "cache_hit"}
    spans = trace_cli.assemble(trace_cli.load_dir(str(tmp_path))["spans"])
    kinds = sorted(sorted({s["kind"] for s in ss}) for ss in spans.values())
    assert kinds == [["launch", "queue", "request"], ["request"],
                     ["request"]]
    cold = [ss for ss in spans.values() if len(ss) > 1][0]
    launch = [s for s in cold if s["kind"] == "launch"][0]
    assert launch["attrs"]["first_launch"] is True
    assert launch["attrs"]["capacity"] == 1


def test_untraced_server_writes_nothing(tmp_path):
    from heat2d_tpu_torch.serve.server import Client, SolveServer

    with SolveServer(registry=MetricsRegistry(), device="cpu") as s:
        Client(s).solve(SolveRequest(nx=16, ny=16, steps=4, cx=0.23,
                                     method="jnp"), timeout=60)
    assert not tracing.enabled() and tracing.tracer() is None
    assert os.listdir(tmp_path) == []


def _port_cli(argv):
    from heat2d_tpu_torch.cli import main
    return main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("mode", ["pallas", "serial"])
def test_tracing_and_streaming_leave_results_alone(tmp_path, mode,
                                                   capsys):
    """The CLI with --trace-dir, --metrics-out and --profile against the
    CLI without: the same final.dat bytes, the same steps, launch counts
    and residual reads; only the traced record has trace_id."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    base = ["--mode", mode, "--nxprob", "24", "--nyprob", "32", "--steps",
            "60", "--convergence", "--interval", "10", "--sensitivity",
            "1e-30"]
    runs = {}
    for name, extra in (("plain", []),
                        ("traced", ["--trace-dir", str(tmp_path / "tr"),
                                    "--metrics-out", str(tmp_path / "m"),
                                    "--profile", str(tmp_path / "p")])):
        out = tmp_path / name
        cs.reset_launch_counts()
        assert _port_cli(base + ["--outdir", str(out), "--run-record",
                                 str(out / "rec.json")] + extra) == 0
        runs[name] = (open(out / "final.dat", "rb").read(),
                      json.load(open(out / "rec.json")),
                      cs.launch_counts())
        tracing.set_ambient(None)
        tracing.uninstall()
        os.environ.pop("HEAT2D_TRACE_DIR", None)
    (a, ra, ca), (b, rb, cb) = runs["plain"], runs["traced"]
    assert a == b and ca == cb
    assert (ra["steps_done"], ra["residual_reads"]) == (
        rb["steps_done"], rb["residual_reads"])
    assert "trace_id" not in ra and "residual_trajectory" not in ra
    rep = trace_cli.merge_report(str(tmp_path / "tr"))
    (row,) = rep["traces"]
    assert row["connected"] and row["trace_id"] == rb["trace_id"]
    names = {s["name"] for s in trace_cli.load_dir(
        str(tmp_path / "tr"))["spans"]}
    # the kernel route's chunks are phases (the golden loop has none)
    assert names == ({"cli.run", "phase.stencil_chunk",
                      "phase.residual_reduction"} if mode == "pallas"
                     else {"cli.run"})
    assert len(rb["residual_trajectory"]) == rb["residual_reads"]
    capsys.readouterr()


def test_ensemble_refuses_profile_as_jax_does(tmp_path, capsys):
    rc = _port_cli(["--ensemble-cx", "0.1", "--ensemble-cy", "0.1",
                    "--profile", str(tmp_path), "--outdir", str(tmp_path)])
    err = capsys.readouterr().err
    assert rc == 1 and "do not support --profile" in err


def _jax_cli(argv, module="heat2d_tpu.cli"):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for k in ENV:
        env.pop(k, None)
    return subprocess.run([sys.executable, "-m", module] + argv, env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_solver_cli_record_keys_equal_jax(tmp_path, capsys):
    base = ["--nxprob", "16", "--nyprob", "16", "--steps", "40",
            "--convergence", "--interval", "10", "--sensitivity", "1.0",
            "--dat-layout", "none"]
    recs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        argv = base + ["--outdir", str(d), "--run-record",
                       str(d / "rec.json"), "--trace-dir", str(d / "tr"),
                       "--metrics-out", str(d / "m.jsonl")]
        if name == "jax":
            r = _jax_cli(argv + ["--platform", "cpu"])
            assert r.returncode == 0, r.stderr
        else:
            assert _port_cli(argv) == 0
        recs[name] = json.load(open(d / "rec.json"))
        assert trace_cli.merge_report(str(d / "tr"))["traces"][0][
            "connected"]
    j, t = recs["jax"], recs["torch"]
    for k in ("trace_id", "residual_trajectory", "metrics_aggregate"):
        assert k in j and k in t
    assert [p["step"] for p in t["residual_trajectory"]] == \
        [p["step"] for p in j["residual_trajectory"]]
    capsys.readouterr()


def test_serve_cli_record_keys_equal_jax(tmp_path, capsys):
    reqs = tmp_path / "req.jsonl"
    reqs.write_text("".join(json.dumps(
        {"nx": 16, "ny": 16, "steps": 4, "cx": 0.1 + 0.01 * i,
         "method": "jnp"}) + "\n" for i in range(3)))
    recs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        argv = ["--requests", str(reqs), "--results-out",
                str(d / "res.jsonl"), "--metrics-out", str(d / "m.jsonl"),
                "--trace-dir", str(d / "tr"), "--perf", "--slo-p99", "30"]
        if name == "jax":
            r = _jax_cli(argv + ["--platform", "cpu"],
                         module="heat2d_tpu.serve.cli")
            assert r.returncode == 0, r.stderr
        else:
            from heat2d_tpu_torch.serve.cli import main
            assert main(argv + ["--device", "cpu"]) == 0
            tracing.uninstall()
            os.environ.pop("HEAT2D_TRACE_DIR", None)
        lines = [json.loads(x) for x in open(d / "m.jsonl")]
        recs[name] = lines[-1]
        rep = trace_cli.merge_report(str(d / "tr"))
        assert len(rep["traces"]) == 3
        assert all(r["connected"] for r in rep["traces"])
    j, t = recs["jax"], recs["torch"]
    assert {"slo", "trace", "perf"} <= set(j) & set(t)
    assert set(t["trace"]) == set(j["trace"])
    assert t["trace"]["spans_emitted"] == j["trace"]["spans_emitted"]
    assert set(t["perf"]) == set(j["perf"])
    jcard, tcard = j["perf"]["cards"][0], t["perf"]["cards"][0]
    assert set(jcard) <= set(tcard)
    assert set(tcard["model"]) == set(jcard["model"])
    assert [set(r) for r in t["slo"]] == [set(r) for r in j["slo"]]
    assert set(j["launch_log"][0]) <= set(t["launch_log"][0])
    assert set(j["launch_log"][0]["perf"]) <= set(t["launch_log"][0]["perf"])
    capsys.readouterr()
