"""The port's sweep harnesses (``tools/sweep_torch.py``,
``tools/sweep_iters_torch.py``, ``tools/sweep_ensemble_torch.py``) and
phase profiler (``tools/profile_phases_torch.py``) against the JAX
package's (``benchmarks/sweep*.py``): the ports of ``tests/test_sweep.py``'s
math tests run on the same inputs through both and give equal outputs
(suite points, the two-point estimator, suspect rows, the conv overhead,
the scaling columns, Table 13's pairs, the iteration sweep's markdown);
then each tool runs end to end on the CPU at a small size."""

import json
import os
import sys
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmarks import sweep as jsweep  # noqa: E402
from benchmarks import sweep_iters as jiters  # noqa: E402
from heat2d_tpu.tune import measure as jmeasure  # noqa: E402
from heat2d_tpu_torch.tune import measure as tmeasure  # noqa: E402
from tools import profile_phases_torch as phases  # noqa: E402
from tools import sweep_ensemble_torch as tens  # noqa: E402
from tools import sweep_iters_torch as titers  # noqa: E402
from tools import sweep_torch as tsweep  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# The math, through both packages
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("n", (1, 2, 4, 8, 16))
def test_mesh_shapes_equal(n):
    assert tsweep.mesh_shapes(n) == jsweep.mesh_shapes(n)


@pytest.mark.parametrize("quick", (True, False))
def test_suite_points_equal(quick):
    assert list(tsweep.suite_chip(100, quick)) == \
        list(jsweep.suite_chip(100, quick))
    assert list(tsweep.suite_conv(100, quick)) == \
        list(jsweep.suite_conv(100, quick))
    for n in (1, 4, 8):
        assert list(tsweep.suite_scaling(10, quick, n)) == \
            list(jsweep.suite_scaling(10, quick, n))
        assert list(tsweep.suite_mesh(10, quick, n)) == \
            list(jsweep.suite_mesh(10, quick, n))


def test_reference_columns_equal():
    for name in ("REF_SIZES", "NORTH_STAR", "REF_SERIAL_S", "REF_BEST_S",
                 "REF_CUDA_MCELLS", "REF_CONV_SERIAL_S", "REF_CONV_BEST_S",
                 "MAX_HI_STEPS"):
        assert getattr(tsweep, name) == getattr(jsweep, name), name
    assert tsweep.AGREE_FACTOR == jsweep.AGREE_FACTOR
    assert tmeasure.NOISE_FLOOR_S == jmeasure.NOISE_FLOOR_S


class _FakeTimer:
    """Scripted timed_run: elapsed = overhead + marginal * n, plus
    scripted noise spikes keyed by (n, call index)."""

    def __init__(self, marginal, overhead=0.2, spikes=None):
        self.marginal, self.overhead = marginal, overhead
        self.spikes, self.calls = dict(spikes or {}), {}

    def __call__(self, n):
        i = self.calls.get(n, 0)
        self.calls[n] = i + 1
        return types.SimpleNamespace(elapsed=self.overhead + self.marginal
                                     * n + self.spikes.get((n, i), 0.0))


@pytest.mark.parametrize("case", ("lucky_jitter", "confirm", "noise"))
def test_two_point_estimate_equal(case):
    marginal, spikes = {
        "lucky_jitter": (1.2e-6, {(100, 0): 0.06, (100, 1): 0.062}),
        "confirm": (1e-4, None),
        "noise": (1e-9, None)}[case]
    got = tmeasure.two_point_estimate(_FakeTimer(marginal, spikes=spikes),
                                      lo=20, hi0=100, max_hi=100_000)
    want = jmeasure.two_point_estimate(_FakeTimer(marginal, spikes=spikes),
                                       lo=20, hi0=100, max_hi=100_000)
    assert got[:2] == want[:2]
    assert got[2].elapsed == want[2].elapsed
    if case == "lucky_jitter":
        assert abs(got[0] - 1.2e-6) / 1.2e-6 < 0.2 and got[1] == 100_000
    elif case == "confirm":
        assert abs(got[0] - 1e-4) / 1e-4 < 0.05 and got[1] == 10_000
    else:
        assert got[0] is None and got[1] == 100_000


SUSPECT_CASES = {
    "bogus_row": [
        {"mode": "serial", "grid": "320x256", "step_time_s": 2.768e-6},
        {"mode": "pallas", "grid": "320x256", "step_time_s": 3.38677e-4},
        {"mode": "serial", "grid": "1280x1024", "step_time_s": 3.5101e-5},
        {"mode": "pallas", "grid": "1280x1024", "step_time_s": 9.94e-6},
        {"mode": "pallas", "grid": "80x64",
         "method": "end-to-end (two-point within noise)"}],
    "large_healthy": [
        {"mode": "pallas", "grid": "4096x4096", "step_time_s": 7.6e-5},
        {"mode": "pallas", "grid": "8192x8192", "step_time_s": 3.3e-4}],
    "large_bogus": [
        {"mode": "pallas", "grid": "4096x4096", "step_time_s": 7.6e-5},
        {"mode": "pallas", "grid": "8192x8192", "step_time_s": 3.3e-3}],
    "small_exempt": [
        {"mode": "pallas", "grid": "80x64", "step_time_s": 2.0e-6},
        {"mode": "pallas", "grid": "640x512", "step_time_s": 2.4e-6}],
    "serial_exempt": [
        {"mode": "serial", "grid": "4096x4096", "step_time_s": 7.6e-5},
        {"mode": "serial", "grid": "8192x8192", "step_time_s": 3.3e-3}],
    "monotone_bad": [
        {"mode": "pallas", "grid": "640x512", "step_time_s": 2e-5},
        {"mode": "pallas", "grid": "1280x1024", "step_time_s": 9.9e-6}],
    "monotone_ok": [
        {"mode": "pallas", "grid": "640x512", "step_time_s": 5e-6},
        {"mode": "pallas", "grid": "1280x1024", "step_time_s": 9.9e-6}],
    "wobble": [
        {"mode": "serial", "grid": "80x64", "step_time_s": 2.0e-6},
        {"mode": "serial", "grid": "160x128", "step_time_s": 1.8e-6}],
    "meshes": [
        {"mode": "dist2d", "grid": "640x512", "mesh": "8x1",
         "step_time_s": 2e-5},
        {"mode": "dist2d", "grid": "1280x1024", "mesh": "2x4",
         "step_time_s": 9.9e-6}],
}
SUSPECT_WANT = {"bogus_row": [1], "large_healthy": [], "large_bogus": [0, 1],
                "small_exempt": [], "serial_exempt": [],
                "monotone_bad": [0], "monotone_ok": [], "wobble": [],
                "meshes": []}


@pytest.mark.parametrize("case", sorted(SUSPECT_CASES))
def test_suspect_rows_equal(case):
    recs = SUSPECT_CASES[case]
    assert tsweep.suspect_rows(recs) == jsweep.suspect_rows(recs) \
        == SUSPECT_WANT[case]


def test_sanity_pass_keeps_the_row_labels(monkeypatch, capsys):
    """A re-measured row replaces a suspect one with the same suite,
    platform and card, flagged ``rechecked``: the report's header and its
    readers find every row labelled alike."""
    recs = [dict(r, suite="chip", platform="cpu x1", card="cpu", steps=10)
            for r in SUSPECT_CASES["bogus_row"]]
    points = [dict(mode=r["mode"], nx=80, ny=64, steps=10) for r in recs]
    monkeypatch.setattr(tsweep, "run_point", lambda **kw: {
        "mode": kw["mode"], "grid": "80x64", "steps": kw["min_hi"]})
    out = tsweep.sanity_pass(recs, points, max_hi=1000)
    assert out[0]["card"] == "cpu" and "rechecked" not in out[0]
    assert out[1] == {"mode": out[1]["mode"], "grid": "80x64", "steps": 100,
                      "suite": "chip", "platform": "cpu x1", "card": "cpu",
                      "rechecked": True}


def test_redesign_payoff_pairs_equal():
    recs = [
        {"mode": "dist1d", "grid": "2560x2048", "mesh": "8x1",
         "steps": 100, "step_time_s": 1.2e-2, "elapsed_s": 1.2},
        {"mode": "dist2d", "grid": "2560x2048", "mesh": "2x4",
         "steps": 100, "step_time_s": 0.4e-2, "elapsed_s": 0.4},
        {"mode": "dist2d", "grid": "2560x2048", "mesh": "8x1",
         "steps": 100, "step_time_s": 1.1e-2, "elapsed_s": 1.1},
        {"mode": "dist1d", "grid": "640x512", "mesh": "4x1",
         "steps": 50, "elapsed_s": 0.5},
        {"mode": "dist2d", "grid": "640x512", "mesh": "2x2",
         "steps": 50, "elapsed_s": 0.25},
    ]
    rows = tsweep.redesign_payoff(recs)
    assert rows == jsweep.redesign_payoff(recs)
    assert [r[-1] for r in rows] == [3.0, 2.0]


def test_scaling_columns_equal():
    pts = list(tsweep.suite_scaling(10, quick=True, n_devices=8))
    recs = [{"mesh": f"{p['gridx']}x{p['gridy']}", "elapsed_s": 1.0 / (i + 1)}
            for i, p in enumerate(pts)]
    mine = tsweep.add_scaling_columns([dict(r) for r in recs])
    assert mine == jsweep.add_scaling_columns([dict(r) for r in recs])
    assert mine[3]["speedup_vs_1dev"] == 4.0 and mine[3]["efficiency"] == 0.5


def test_conv_overhead_equal():
    recs = [
        {"mode": "pallas", "grid": "2560x2048", "mesh": "1x1",
         "step_time_s": 2.0e-5},
        {"mode": "pallas", "grid": "2560x2048", "mesh": "1x1",
         "step_time_s": 2.2e-5, "convergence": True, "sensitivity": 0.0},
        {"mode": "pallas", "grid": "80x64", "mesh": "1x1",
         "elapsed_s": 0.1, "convergence": True},
    ]
    mine = tsweep.add_conv_overhead([dict(r) for r in recs])
    assert mine == jsweep.add_conv_overhead([dict(r) for r in recs])
    assert mine[1]["conv_overhead_pct"] == 10.0


def _iter_rows():
    return [{"steps": 10, "total_s": 0.2}, {"steps": 100, "total_s": 0.29},
            {"steps": 1000, "total_s": 1.19}, {"steps": 10000,
                                               "total_s": 1.25}]


def test_iters_rows_and_markdown_equal():
    floor = jiters.NOISE_FLOOR_S
    rows = titers.finish(_iter_rows(), floor=floor)
    # the JAX sweep's post-pass (benchmarks/sweep_iters.py:measure)
    want = _iter_rows()
    for i, r in enumerate(want):
        r["per_step_s"] = r["total_s"] / r["steps"]
        r["x_vs_10it"] = r["total_s"] / want[0]["total_s"]
        if i:
            dt = r["total_s"] - want[i - 1]["total_s"]
            if dt > floor:
                r["marginal_s"] = dt / (r["steps"] - want[i - 1]["steps"])
            else:
                r["marginal_noise"] = True
    assert rows == want
    assert abs(rows[2]["marginal_s"] - 1e-3) < 1e-12
    assert rows[1]["marginal_noise"] and rows[3]["marginal_noise"]
    key = {"mode": "pallas", "grid": "2560x2048", "platform": "test"}
    md = titers.section_markdown(rows, key, floor=floor)
    assert md == jiters.section_markdown(rows, key)
    assert "(window < noise floor)" in md and "| 1000 |" in md
    for r in rows:
        r["key"] = key
    assert "## pallas 2560x2048 on test" in titers.render(rows)


def test_iters_port_floor_admits_card_windows():
    rows = titers.finish([{"steps": 10, "total_s": 0.0004},
                          {"steps": 10_000, "total_s": 0.0404}])
    assert titers.NOISE_FLOOR_S == 0.02
    assert rows[1]["marginal_s"] == pytest.approx(0.04 / 9990)


# --------------------------------------------------------------------- #
# End to end on the CPU
# --------------------------------------------------------------------- #

def test_run_point_has_reference_columns():
    rec = tsweep.run_point("serial", 80, 64, 100, max_hi=1000,
                           device="cpu")
    assert rec["steps"] >= 100 and rec["mcells_per_s"] > 0
    assert rec["route"] == "serial" and rec["kind"] == "sweep-point"
    if rec["method"] == "two-point":
        assert rec["ref_serial_100step_s"] == 2.53e-2
        assert rec["speedup_vs_ref_serial"] > 0


def test_sweep_quick_end_to_end(tmp_path, capsys):
    assert tsweep.main(["--suite", "chip", "--quick", "--steps", "10",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    recs = [json.loads(x) for x in
            (tmp_path / "sweep_chip_quick.jsonl").read_text().splitlines()]
    assert [(r["mode"], r["grid"]) for r in recs] == [
        ("serial", "80x64"), ("pallas", "80x64"),
        ("serial", "160x128"), ("pallas", "160x128")]
    assert all(r["card"] == "cpu" and r["platform"] == "cpu x1"
               for r in recs)
    md = (tmp_path / "sweep_chip_quick.md").read_text()
    assert md.startswith("# heat2d-tpu-torch sweep (cpu x1; cpu)")
    assert "**CPU run.**" in md


def test_sweep_mesh_rows_run_on_slots():
    rec = tsweep.run_point("dist2d", 32, 32, 5, gridx=2, gridy=2,
                           max_hi=20, device="cpu")
    assert rec["mesh"] == "2x2" and rec["route"] == "sharded"


def test_iters_sweep_end_to_end(tmp_path):
    assert titers.main(["40", "32", "pallas", "--device", "cpu",
                        "--max-steps", "100", "--out", str(tmp_path)]) == 0
    rows = [json.loads(x) for x in
            (tmp_path / "sweep_iters.jsonl").read_text().splitlines()]
    assert [r["steps"] for r in rows] == [10, 100]
    assert rows[0]["key"]["platform"] == "cpu (cpu)"
    assert "## pallas 40x32 on cpu (cpu)" in \
        (tmp_path / "sweep_iters.md").read_text()


def test_ensemble_sweep_rows_on_the_cpu():
    classes = [("resident 12x16", 12, 16, "pallas", 2,
                {c: ((10, 200), (10, 200)) for c in (False, True)})]
    rows = tens.sweep(1.0, "cpu", classes)
    assert [(r["route"], r["convergence"], r["B"]) for r in rows] == [
        ("pallas", False, 2), ("pallas", True, 2)]
    for r in rows:
        if r["single_step_s"] and r["batch_step_s"]:
            assert r["batching_efficiency"] == pytest.approx(
                2 * r["single_step_s"] / r["batch_step_s"])
    md = tens.to_markdown(rows, "cpu x1", "cpu")
    assert md.startswith("# Ensemble batching efficiency (cpu x1; cpu)")
    assert md.count("| resident 12x16 (pallas) |") == 2


def test_phase_split_of_a_digest():
    d = {"window_s": 1.0, "total_op_s": 0.5, "device_lanes": True,
         "top_ops": [
             {"op": "k_tile<false>", "category": "compute",
              "kernel": "H2", "total_s": 0.3},
             {"op": "k_tile<true>", "category": "compute",
              "kernel": "H3", "total_s": 0.1},
             {"op": "Memcpy DtoH", "category": "host/transfer",
              "kernel": None, "total_s": 0.05},
             {"op": "reduce_kernel", "category": "compute",
              "kernel": None, "total_s": 0.04},
             {"op": "elementwise_kernel", "category": "compute",
              "kernel": None, "total_s": 0.01}],
         "annotations": [{"name": "halo_exchange", "total_s": 0.2,
                          "count": 4},
                         {"name": "stencil_chunk", "total_s": 0.1,
                          "count": 4},
                         {"name": "cli.run", "total_s": 0.9, "count": 1}],
         "sync": [{"total_s": 0.02, "count": 3}]}
    s = phases.phase_split(d)
    assert s["device"] == pytest.approx({
        "stencil compute": 0.3, "residual": 0.14,
        "copies (memcpy/memset)": 0.05, "other PyTorch kernels": 0.01})
    assert s["host"] == pytest.approx({
        "halo exchange (host)": 0.2, "stencil launches (host)": 0.1,
        "synchronisation (host waits)": 0.02})
    md = phases.to_markdown(s, "t", "p", {"exchanges": 4, "phases": 8,
                                          "bytes": 1024, "seconds": 0.004})
    assert "| halo exchange (host) | 0.200000 | 4 | 50.0000 | 20.0% |" in md
    assert "4 exchanges, 8 phases, 1024 bytes, 0.004000 s (1.0000 ms an " \
           "exchange)" in md


def test_profile_phases_end_to_end_on_the_cpu(tmp_path):
    assert phases.main(["--device", "cpu", "--mode", "pallas", "--nxprob",
                        "32", "--nyprob", "32", "--steps", "16", "--out",
                        str(tmp_path)]) == 0
    out = json.loads((tmp_path / "phases.json").read_text())
    assert [o["rank"] for o in out] == [0]
    assert out[0]["split"]["host"]["stencil launches (host)"] > 0
    assert "## pallas 32x32, rank 0" in (tmp_path / "phases.md").read_text()
