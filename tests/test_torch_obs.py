"""The port's telemetry core (``heat2d_tpu_torch/obs``: metrics, slo,
stream, roofline, trace_report, ``utils/profiling``) against the JAX
package's (``heat2d_tpu/obs``) on the same inputs, on the CPU at tens of
cells.

Held against the JAX package: registries fed the same observations give
equal ``find_histograms``, ``prometheus_text``, ``slo.evaluate`` rows and
``BurnWindow`` ticks; ``boundary_bytes`` is the JAX function's; a stamped
launch row has the JAX row's keys; the port's convergence trajectory
(``TelemetryStream``) has the JAX solver's steps and its residuals
within the f32 reductions' spread; ``heat2d_tpu.obs.trace_report.
to_markdown`` renders the port's digest.

Port-only: the tile route's bytes against a count made from the tile
plan cell by cell, the resident route's exchange bytes against the
plan's bands and rings, the bound's honest absence off the H100, the
digest of synthetic CUDA-layout events (exact shares, H labels of
templated names, idle gaps and the annotations open in them, sync), a
real CPU capture through ``profile_span``, stale captures skipped.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from heat2d_tpu.config import HeatConfig as JHeatConfig
from heat2d_tpu.models.solver import Heat2DSolver as JSolver
from heat2d_tpu.obs import metrics as jmetrics
from heat2d_tpu.obs import roofline as jroofline
from heat2d_tpu.obs import slo as jslo
from heat2d_tpu.obs import trace_report as jtrace_report
from heat2d_tpu.obs.stream import TelemetryStream as JStream
from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.models.solver import Heat2DSolver
from heat2d_tpu_torch.obs import metrics, roofline, slo, trace_report
from heat2d_tpu_torch.obs.stream import TelemetryStream
from heat2d_tpu_torch.ops import cuda_ensemble as ce
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops import resident as rs
from heat2d_tpu_torch.utils.profiling import phase, profile_span


def _feed(reg, seed: int, n: int) -> None:
    """The same observation stream into either package's registry."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        sig = f"(16, {16 + i % 3}, 5)"
        reg.observe("serve_signature_latency_s", float(rng.random()),
                    signature=sig)
        reg.counter("serve_signature_requests_total", signature=sig,
                    outcome=("completed" if rng.random() < 0.9
                             else "rejected_queue_timeout"))
        reg.counter("serve_signature_requests_total", signature=sig,
                    outcome="rejected_invalid")
        reg.gauge("serve_queue_depth", float(i % 5))
        reg.observe("weird name-1", float(i), label='a"b\nc\\d')


@pytest.mark.parametrize("cap,n", [(4096, 40), (8, 40), (4096, 0)])
def test_registry_views_equal_jax(cap, n):
    """Below the cap (exact) and past it (the seeded reservoir): equal
    summaries, structured lookups and Prometheus text."""
    t, j = metrics.MetricsRegistry(cap), jmetrics.MetricsRegistry(cap)
    _feed(t, 3, n)
    _feed(j, 3, n)
    for name in ("serve_signature_latency_s", "weird name-1", "absent"):
        assert t.find_histograms(name) == j.find_histograms(name)
    assert t.find_counters("serve_signature_requests_total") == \
        j.find_counters("serve_signature_requests_total")
    assert t.prometheus_text() == j.prometheus_text()
    assert t.snapshot()["histograms"] == j.snapshot()["histograms"]


def test_reservoir_exact_flag_and_reset_registry():
    r = metrics.Reservoir(cap=3)
    for v in range(3):
        r.add(float(v))
    assert r.exact()
    r.add(9.0)
    assert not r.exact() and r.count == 4 and r.max == 9.0
    a = metrics.get_registry()
    b = metrics.reset_registry()
    assert b is metrics.get_registry() and b is not a


@pytest.mark.parametrize("policies", [None, {"(16, 17, 5)": (0.01, 0.5)}])
def test_slo_rows_and_burn_windows_equal_jax(policies):
    t, j = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _feed(t, 5, 30)
    _feed(j, 5, 30)
    tp = {k: slo.SLOPolicy(*v) for k, v in (policies or {}).items()}
    jp = {k: jslo.SLOPolicy(*v) for k, v in (policies or {}).items()}
    rows = slo.evaluate(t, default=slo.SLOPolicy(0.9, 0.05), policies=tp)
    jrows = jslo.evaluate(j, default=jslo.SLOPolicy(0.9, 0.05),
                          policies=jp)
    assert rows == jrows and rows
    assert t.find_gauges("slo_burn_rate") == j.find_gauges("slo_burn_rate")
    assert slo.stamp_record({}, rows) == jslo.stamp_record({}, jrows)
    tw = slo.BurnWindow(slo.SLOPolicy(1.0, 0.05), prefix="serve",
                        sustain=2)
    jw = jslo.BurnWindow(jslo.SLOPolicy(1.0, 0.05), prefix="serve",
                         sustain=2)
    for seed in (7, 8, 9):
        assert tw.tick(t) == jw.tick(j)
        assert tw.sustained() == jw.sustained()
        _feed(t, seed, 10)
        _feed(j, seed, 10)
    assert tw.tick(None) == jw.tick(None) == {}


@pytest.mark.parametrize("bad", [dict(latency_p99_s=0.0),
                                 dict(latency_p99_s=1.0, error_budget=0.0)])
def test_slo_policy_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        slo.SLOPolicy(**bad)
    with pytest.raises(ValueError):
        jslo.SLOPolicy(**bad)


@pytest.mark.parametrize("nx,ny,batch,conv", [(10, 12, 1, False),
                                              (64, 48, 8, True),
                                              (4096, 4096, 4, False)])
def test_boundary_bytes_equal_jax(nx, ny, batch, conv):
    for dtype in ("float32", "bfloat16", "float64"):
        assert roofline.boundary_bytes(
            nx, ny, batch=batch, dtype=dtype, convergence=conv) == \
            jroofline.boundary_bytes(nx, ny, batch=batch, dtype=dtype,
                                     convergence=conv)


def _counted_tile_bytes(plan, nx, ny, b):
    """A sweep's bytes counted tile by tile on a mask of the grid: each
    tile reads its ext (clipped to the grid; a fast tile, as
    ``tile_paths`` counts it, reads the whole ext) and the centre is
    written once."""
    h = plan.tsteps
    read = 0
    fast = 0
    for a in range(plan.grid[0]):
        for c in range(plan.grid[1]):
            m = np.zeros((nx, ny), dtype=bool)
            r0, c0 = a * plan.ty - h, c * plan.tx - h
            m[max(r0, 0):max(r0 + plan.ty + 2 * h, 0),
              max(c0, 0):max(c0 + plan.tx + 2 * h, 0)] = True
            n = int(m.sum())
            read += n
            fast += n == (plan.ty + 2 * h) * (plan.tx + 2 * h)
    assert fast == cs.tile_paths(plan, nx, ny)["fast"]
    return b * (read + nx * ny)


@pytest.mark.parametrize("nx,ny,steps", [(2000, 2000, 240), (1000, 1100, 40),
                                         (2000, 2100, 13), (37, 53, None)])
def test_tile_route_bytes_equal_a_count_from_the_plan(nx, ny, steps):
    m = roofline.analytic_bytes_per_cell_step(nx, ny, method="band",
                                              steps=steps)
    plan = cs.tile_plan(nx, ny, cs.DEFAULT_TSTEPS, "cpu")
    n = steps or plan.tsteps
    sweeps = -(-n // plan.tsteps)
    want = sweeps * _counted_tile_bytes(plan, nx, ny, 4) / (nx * ny * n)
    assert m["route"] == "tile" and m["kernel"] == "H2/H3"
    assert m["bytes_per_cell_step"] == pytest.approx(want, rel=1e-12)
    # per member the batched route (H6/H7) moves the same bytes
    mb = roofline.analytic_bytes_per_cell_step(nx, ny, method="band",
                                               steps=steps, batch=4)
    assert mb["bytes_per_cell_step"] == m["bytes_per_cell_step"]
    assert mb["kernel"] == "H6/H7"
    assert ce.tile_plan(nx, ny, "cpu") == plan


def test_resident_route_bytes_from_the_plan():
    """One read and one write of the grid a launch, and every exchange's
    published bands and read-back ring as 8-byte words, from the plan."""
    nx, ny, steps = 640, 1024, 10000
    plan = rs.plan_resident(1, nx, ny, 1, "cpu")
    m = roofline.analytic_bytes_per_cell_step(nx, ny, steps=steps)
    assert m["route"] == "resident" and m["kernel"] == "H4"
    cells = 0
    for ti in range(plan.gx):
        for tj in range(plan.gy):
            cells += sum((r1 - r0) * (c1 - c0)
                         for r0, r1, c0, c1 in rs._bands(plan, ti, tj))
            mask = np.zeros((nx, ny), dtype=bool)
            i0, j0 = ti * plan.ty - plan.halo, tj * plan.tx - plan.halo
            for r0, r1, c0, c1 in rs._ring(plan):
                mask[max(i0 + r0, 0):max(i0 + r1, 0),
                     max(j0 + c0, 0):max(j0 + c1, 0)] = True
            cells += int(mask.sum())
    exchanges = -(-steps // plan.k) - 1
    want = (8 * nx * ny + exchanges * 8 * cells) / (nx * ny * steps)
    assert m["bytes_per_cell_step"] == pytest.approx(want, rel=1e-12)
    # one chunk, no exchange: 2b/K (the JAX model's 2b/T)
    one = roofline.analytic_bytes_per_cell_step(nx, ny)
    assert one["bytes_per_cell_step"] == pytest.approx(8 / plan.k)
    assert roofline.analytic_bytes_per_cell_step(
        nx, ny, steps=steps, batch=8)["kernel"] == "H5"


@pytest.mark.parametrize("problem,method,route,kernel", [
    ("heat5", "jnp", "jnp", None), ("heat5", "serial", "jnp", None),
    ("heat5", "adi", "adi", None), ("heat5", "mg", "mg", None),
    ("heat9", "auto", "resident", "H8"), ("heat9", "band", "tile", "H9"),
    ("varcoef", "auto", "jnp", None)])
def test_routes_resolve_through_the_port_dispatch(problem, method, route,
                                                  kernel):
    m = roofline.analytic_bytes_per_cell_step(64, 48, method=method,
                                              problem=problem, batch=2)
    assert (m["route"], m["kernel"]) == (route, kernel)
    assert m["coarse"] == (route in ("adi", "mg"))
    if route == "jnp" and problem == "heat5":
        # the golden loop is the JAX jnp route's 2b stream
        assert m["bytes_per_cell_step"] == jroofline.\
            analytic_bytes_per_cell_step(64, 48, method="jnp")[
                "bytes_per_cell_step"]


def test_bound_absent_off_the_calibrated_card():
    for kind in (None, "cpu", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert roofline.roofline_bound(4096, 4096, device_kind=kind) is None
    assert roofline.roofline_bound(4096, 4096, dtype="bfloat16",
                                   device_kind=roofline.H100_KIND) is None
    b = roofline.roofline_bound(4096, 4096, steps=240,
                                device_kind=roofline.H100_KIND)
    bpcs = roofline.analytic_bytes_per_cell_step(
        4096, 4096, steps=240)["bytes_per_cell_step"]
    t = max(bpcs / 3.35e12, 7 / 67e12)
    assert b["bound_mcells_per_s"] == pytest.approx(1 / t / 1e6)
    assert b["bound_by"] == "bytes" and b["kernel"] == "H2/H3"
    assert roofline.device_kind("cpu") == "cpu"


def test_stamped_row_has_the_jax_row_keys():
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    row, jrow = {"signature": (64, 48)}, {"signature": (64, 48)}
    kw = dict(nx=64, ny=48, steps=20, members=2, elapsed_s=0.01,
              method="jnp", signature="s", card={"arithmetic_intensity": 1})
    perf = roofline.stamp_launch_row(row, reg, **kw, device="cpu")
    jperf = jroofline.stamp_launch_row(jrow, jreg, **kw)
    assert set(jperf) <= set(perf)
    assert set(perf) - set(jperf) == {"bound_by", "kernel"}
    assert perf["achieved_mcells_per_s"] == jperf["achieved_mcells_per_s"]
    assert perf["bytes_per_cell_step"] == jperf["bytes_per_cell_step"]
    assert perf["bound_mcells_per_s"] is None is perf["pct_of_bound"]
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert set(snap["gauges"]) == set(jsnap["gauges"])
    assert snap["counters"] == jsnap["counters"]


def _trajectory_jax(cfg):
    from heat2d_tpu.obs.stream import flush_taps
    stream = JStream()
    JSolver(cfg, telemetry=stream).run()
    flush_taps()
    return stream.trajectory()


@pytest.mark.parametrize("interval,steps", [(10, 200), (7, 60)])
def test_stream_trajectory_matches_jax_solver(interval, steps):
    """64^2 with --convergence: the port's stream (the loops' own reads)
    has the JAX solver's steps, and its residuals within 1e-5 relative
    (both sum f32 squares; only their reduction orders differ)."""
    kw = dict(nxprob=64, nyprob=64, steps=steps, convergence=True,
              interval=interval, sensitivity=1.0, mode="serial")
    stream = TelemetryStream(registry=metrics.MetricsRegistry())
    res = Heat2DSolver(HeatConfig(**kw), device="cpu",
                       telemetry=stream).run()
    want = _trajectory_jax(JHeatConfig(**kw))
    got = stream.trajectory()
    assert [p["step"] for p in got] == [p["step"] for p in want]
    assert len(got) == res.residual_reads       # the timed run's reads
    np.testing.assert_allclose([p["residual"] for p in got],
                               [p["residual"] for p in want], rtol=1e-5)
    series = stream.registry.snapshot()["series"]["residual"]
    assert [s[0] for s in series] == [p["step"] for p in got]


def test_stream_member_taps_take_tensors():
    s = TelemetryStream(registry=metrics.MetricsRegistry())
    s.tap_members(1, torch.tensor([20, 20]), torch.tensor([0.5, 2.0]),
                  torch.tensor([True, False]))
    s.tap_members(1, [99], [9.0], [False])            # dedupe by chunk
    assert s.chunk_progress() == [{"chunk": 1, "steps_done": [20, 20],
                                   "residuals": [0.5, 2.0],
                                   "done": [True, False]}]
    assert [e["event"] for e in s.registry.events()] == ["ensemble_chunk"]


# --------------------------------------------------------------------- #
# trace_report: the digest of a torch.profiler capture
# --------------------------------------------------------------------- #

H2 = ("void (anonymous namespace)::k_tile<0, false>(float const*, float*, "
      "float*, unsigned int*, int, int, float, float, float, int, int, int,"
      " int, int)")
H3 = "void (anonymous namespace)::k_tile<0, true>(float const*, float*)"
H7 = "void (anonymous namespace)::k_ens_tile<(bool)1>(float const*)"
H9 = ("void (anonymous namespace)::k_fam_tile<(anonymous namespace)::"
      "Heat9>(float const*)")


def _x(name, cat, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def _synthetic_events():
    """A host thread (pid 100) and one stream (GPU 0 / stream 7), in
    Kineto's layout: a 100 us window, 60 us of device events."""
    return [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0,
         "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "thread_name", "pid": 100, "tid": 100,
         "args": {"name": "thread 100 (python3)"}},
        _x("stencil_chunk", "user_annotation", 1000, 100, 100, 100),
        _x("residual_reduction", "user_annotation", 1045, 30, 100, 100),
        _x("aten::add", "cpu_op", 1001, 2, 100, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 1002, 3, 100, 100),
        _x("cudaStreamSynchronize", "cuda_runtime", 1070, 25, 100, 100),
        _x("cudaDeviceSynchronize", "cuda_runtime", 1096, 4, 100, 100),
        _x(H2, "kernel", 1010, 20),
        _x(H2, "kernel", 1030, 10),
        _x(H3, "kernel", 1065, 10),
        _x(H7, "kernel", 1075, 5),
        _x(H9, "kernel", 1080, 5),
        _x("ncclKernel_AllReduce_RING", "kernel", 1085, 4),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1089, 6),
        _x("stencil_chunk", "gpu_user_annotation", 1010, 80),
    ]


def test_digest_of_synthetic_cuda_events():
    d = trace_report.digest(_synthetic_events())
    assert d["schema"] == jtrace_report.DIGEST_SCHEMA
    assert d["device_lanes"] and d["window_s"] == pytest.approx(100e-6)
    assert d["total_op_s"] == pytest.approx(60e-6)
    kern = {k["kernel"]: k for k in d["kernels"]}
    assert {k: (v["count"], v["total_s"]) for k, v in kern.items()} == {
        "H2": (2, 30e-6), "H3": (1, 10e-6), "H7": (1, 5e-6),
        "H9": (1, 5e-6)}
    assert kern["H2"]["share_pct"] == 50.0
    assert kern["H2"]["mean_ms"] == pytest.approx(0.015)
    top = d["top_ops"][0]
    assert (top["op"], top["kernel"], top["category"], top["share_pct"]) \
        == (H2, "H2", "compute", 50.0)
    assert d["categories"] == {"collective": 4e-06, "compute": 5e-05,
                               "host/transfer": 6e-06, "sync": 2.9e-05}
    lane, = d["lanes"]
    assert lane["lane"] == "GPU 0/stream 7"
    assert lane["busy_s"] == pytest.approx(60e-6)
    assert lane["idle_pct"] == 40.0
    assert lane["collective_pct"] == pytest.approx(100 * 4 / 60, abs=0.01)
    gaps = [(g["start_ms"], g["dur_ms"], g["annotations"])
            for g in lane["gaps"]]
    assert gaps == [(0.04, 0.025, ["stencil_chunk", "residual_reduction"]),
                    (0.0, 0.01, ["stencil_chunk"]),
                    (0.095, 0.005, ["stencil_chunk"])]
    sync, = d["sync"]
    assert sync["count"] == 2 and sync["total_s"] == pytest.approx(29e-6)
    assert [a["name"] for a in d["annotations"]] == [
        "stencil_chunk", "residual_reduction"]
    # the JAX package's renderer reads the port's digest
    md = jtrace_report.to_markdown(d, logdir="x")
    assert "`" + H2 + "`" in md and "GPU 0/stream 7" in md
    assert "H2" in trace_report.to_markdown(d)


#: H10's and H11's right-hand-side builds (one launch an ADI half), as a
#: CUDA profiler's trace names them on the H100
ADI_HALF_X = ("void (anonymous namespace)::k_td_rows<true, true>(float "
              "const*, float*, float const*, float const*, float const*, "
              "int, int)")
ADI_HALF_Y = ("void (anonymous namespace)::k_td_lanes<true, true>(float "
              "const*, float*, float const*, float const*, float const*, "
              "int, int)")


@pytest.mark.parametrize("name,label", [
    (H2, "H2"), (H3, "H3"), (H7, "H7"), (H9, "H9"),
    ("void (anonymous namespace)::k_ens_tile<false>(float const*)", "H6"),
    ("void (anonymous namespace)::k_shard_tile<1, true>(float*)", "H13"),
    ("void (anonymous namespace)::k_shard_tile<1, false>(float*)", "H12"),
    ("void (anonymous namespace)::k_step<1>(float const*)", "H1"),
    ("void (anonymous namespace)::k_resident<0>(float const*)", "H4"),
    ("void (anonymous namespace)::k_ens_resident<true>(float*)", "H5"),
    ("void (anonymous namespace)::k_fam_resident<(anonymous namespace)::"
     "AdvDiff, false>(float*)", "H8"),
    ("void (anonymous namespace)::k_td_rows<true>(float*)", "H10"),
    ("void (anonymous namespace)::k_td_lanes<false>(float*)", "H11"),
    (ADI_HALF_X, "H10"), (ADI_HALF_Y, "H11"),
    ("k_td_coeffs(float const*, float*, int, int)", "td_coeffs"),
    ("void (anonymous namespace)::k_shard_fused<0>(float**)", "H14"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int)", None),
    ("ncclKernel_AllReduce_RING_LL_Sum_float", None)])
def test_kernel_labels_cover_every_hand_kernel(name, label):
    assert trace_report.kernel_label(name) == label


@pytest.mark.parametrize("name,label", [
    (ADI_HALF_X, "H10 k_td_rows"), (ADI_HALF_Y, "H11 k_td_lanes")])
def test_benchmark_digest_labels_the_adi_halves(name, label):
    """The benchmark's digest (``portbench/trace_digest.py``) gives the
    ADI halves' builds the solves' labels, which
    ``kernels_roofline.adi_tridiag`` reads."""
    from portbench import trace_digest
    assert trace_digest.kernel_label(name) == label.split()[0]
    assert trace_digest.op_name({"cat": "kernel", "name": name}) == label


def _write_capture(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_latest_capture_only_and_main(tmp_path, capsys):
    old = [_x(H3, "kernel", 10, 5)]
    _write_capture(str(tmp_path / "a.1.pt.trace.json"), old)
    os.utime(tmp_path / "a.1.pt.trace.json", (1, 1))
    _write_capture(str(tmp_path / "b.2.pt.trace.json.gz"),
                   _synthetic_events(), gz=True)
    d = trace_report.report(str(tmp_path))
    assert {k["kernel"]: k["count"] for k in d["kernels"]}["H3"] == 1
    assert "latest capture only" in capsys.readouterr().err
    out = tmp_path / "d.json"
    assert trace_report.main([str(tmp_path), "--format", "json",
                              "--json-out", str(out)]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(out.read_text())
    assert trace_report.main([str(tmp_path / "none")]) == 1


def test_overlapping_captures_of_one_world_merge(tmp_path):
    ev = _synthetic_events()
    _write_capture(str(tmp_path / "r0.pt.trace.json"), ev)
    _write_capture(str(tmp_path / "r1.pt.trace.json"), ev)
    d = trace_report.report(str(tmp_path))
    assert [row["lane"] for row in d["lanes"]] == [
        "h0:GPU 0/stream 7", "h1:GPU 0/stream 7"]
    assert {k["kernel"]: k["count"] for k in d["kernels"]}["H2"] == 4


def test_cpu_capture_through_profile_span_digests(tmp_path):
    """A real capture on the CPU: the solver's phases annotated, the host
    thread's aten ops digested in place of the device lanes."""
    cfg = HeatConfig(nxprob=24, nyprob=32, steps=30, convergence=True,
                     interval=10, mode="pallas")
    with profile_span(str(tmp_path), device="cpu"):
        with phase("outer"):
            Heat2DSolver(cfg, device="cpu").run()
    files = trace_report.find_trace_files(str(tmp_path))
    assert len(files) == 1 and not trace_report.has_kernel_events(files[0])
    d = trace_report.report(str(tmp_path))
    assert not d["device_lanes"] and d["top_ops"] and d["lanes"]
    assert d["total_op_s"] > 0 and d["kernels"] == []
    names = {a["name"] for a in d["annotations"]}
    assert {"outer", "stencil_chunk", "residual_reduction"} <= names
    assert jtrace_report.to_markdown(d)


def test_profile_span_none_is_a_noop_and_phase_names(tmp_path):
    with profile_span(None):
        with phase("stencil_chunk"):
            pass
    assert os.listdir(tmp_path) == []
