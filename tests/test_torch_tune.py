"""The port's tuning subsystem (``heat2d_tpu_torch/tune``) against the
JAX package's (``heat2d_tpu/tune``), case by case as ``tests/test_tune.py``
runs it where a counterpart exists, on the CPU: the simulated backend and
grids of tens of cells.

Held against the JAX package: one db document, written with the JAX
package's ``TuningDB`` (points, bests, rollout stamps) under a salt
pinned to the same string in both packages, gives the same lookups
(exact, nearest and its matched key, too far, missing), the same
entries, equal merges and the same frontier rows in the port.

Port-only cases: with no db the planners, launches and results are the
parent's; a db entry steers T, the tile height, K and the fused depth,
with bitwise the untuned results and ``tuned_config`` in the records;
entries the live planners refuse fall back; the env var; the search's
resume; the CLI.

Cases of ``tests/test_tune.py`` with no counterpart here, and why:

- the VMEM budget and stamp cases (``test_env_vmem_budget_*``,
  ``test_vmem_budget_source_default_and_flag``,
  ``test_db_vmem_stamp_applies_as_budget``,
  ``test_flag_beats_db_vmem_stamp``,
  ``test_cli_rejects_bad_env_budget_at_startup``): the card's planners
  read its shared memory from the card; there is no VMEM budget to set;
- the ``probe_limits`` cases (``test_probe_limits_restores_on_exception``,
  ``test_probe_limits_with_env_budget``): the card has no VMEM hard limit
  to lift, so ``probe_limits`` is not ported;
- the C2 relabel and degrade cases
  (``test_c2_entry_degrades_to_legacy_off_tpu``,
  ``test_allow_window_relabels_c2_for_legacy_consumers``): H2 (and H6/H7)
  replace both the window and the legacy band kernels, so there is no
  route to relabel;
- the jaxpr pins (``test_band_chunk_jaxpr_identical_without_db``,
  ``test_batched_band_runner_jaxpr_identical_without_db``): the port has
  no traced program; plans, launch counts and bitwise results pin the
  same contract in ``test_no_db_leaves_plans_and_results_alone``.

Since H6/H7 now take the sweep depth at run time, as H2 does, a T of 12
is a valid H6 answer; the H6 case of the invalid entries is a depth H6's
tile plan cannot fit.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from heat2d_tpu.tune import cli as jcli
from heat2d_tpu.tune import db as jdb
from heat2d_tpu_torch.config import ConfigError, HeatConfig
from heat2d_tpu_torch.models import ensemble as tens
from heat2d_tpu_torch.models.solver import Heat2DSolver
from heat2d_tpu_torch.ops import cuda_stencil as cs
from heat2d_tpu_torch.ops import resident as rs
from heat2d_tpu_torch.parallel import sharded as sh
from heat2d_tpu_torch.parallel.mesh import host_devices, make_mesh
from heat2d_tpu_torch.tune import cli as tcli
from heat2d_tpu_torch.tune import db as tdb
from heat2d_tpu_torch.tune import runtime as tr
from heat2d_tpu_torch.tune.db import TuningDB
from heat2d_tpu_torch.tune.measure import (SimulatedBackend,
                                           classify_failure,
                                           measure_candidate)
from heat2d_tpu_torch.tune.space import Candidate, Problem, candidate_space
from heat2d_tpu_torch.utils.device import DeviceUnavailableError

SALT = "pinned-salt0"


@pytest.fixture(autouse=True)
def _no_db():
    """Every test starts and ends with no tuning db active."""
    tr.set_tuning_db(None)
    yield
    tr.set_tuning_db(None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pinned_salt(monkeypatch):
    """Both packages' salts pinned to one string (their code differs, so
    their own salts do)."""
    for mod in (jdb, jcli, tdb, tcli):
        monkeypatch.setattr(mod, "current_salt", lambda: SALT)


def make_db(path, entries, kind="cpu", salt=None):
    """A db file with stamped bests: entries = {"64x64:float32":
    {"route": "tile", "bm": 16, "tsteps": 4, "mcells": 123.0}}."""
    db = TuningDB(str(path))
    for key, e in entries.items():
        db.set_best(kind, key,
                    {"route": e["route"], "bm": e["bm"],
                     "tsteps": e["tsteps"]},
                    e.get("mcells", 100.0), {"protocol": "test"})
        if salt is not None:
            db.data["devices"][kind]["entries"][key]["salt"] = salt
    db.save()
    return db


def _inputs(nx, ny, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 100, (nx, ny)).astype(np.float32)


# --------------------------------------------------------------------- #
# Candidate space
# --------------------------------------------------------------------- #

def test_candidate_space_respects_tile_rules():
    cands, pruned = candidate_space(Problem(4096, 4096))
    assert cands and pruned
    for c in cands:
        if c.route == "tile":
            assert c.bm % cs.BLOCK[1] == 0, c
            plan = cs.tile_plan(4096, 4096, c.tsteps, "cpu", c.bm)
            assert plan.ty == c.bm and plan.tsteps == c.tsteps
        elif c.route == "fused":
            assert 4096 >= 2 * c.tsteps
    assert all(reason for _, reason in pruned)
    # 4096^2 does not stay on the chip: no resident point is measured
    assert not [c for c in cands if c.route == "resident"]
    assert {c.tsteps for c in cands if c.route == "tile"} == {4, 8, 12, 16}


def test_candidate_space_prunes_what_the_planners_refuse():
    cands, pruned = candidate_space(Problem(1800, 1800),
                                    routes=("resident", "tile"))
    ks = {c.tsteps for c in cands if c.route == "resident"}
    assert ks == {k for k in range(1, rs.MAX_CHUNK + 1)
                  if cs.resident_plan(1800, 1800, "cpu", k) is not None}
    assert ks and ks != set(range(1, rs.MAX_CHUNK + 1))
    assert Candidate("tile", 64, 16) in [c for c, _ in pruned]
    # probe_past_envelope keeps the rejects measurable
    cands2, pruned2 = candidate_space(Problem(1800, 1800),
                                      routes=("resident", "tile"),
                                      probe_past_envelope=True)
    assert len(cands2) == len(cands) + len(pruned) and not pruned2


def test_candidate_space_includes_planner_picks():
    p = Problem(640, 1024)
    cands, _ = candidate_space(p)
    k = cs.resident_plan(640, 1024, "cpu").k
    ty = cs.tile_plan(640, 1024, cs.DEFAULT_TSTEPS, "cpu").ty
    assert Candidate("resident", 0, k) in cands
    assert Candidate("tile", ty, cs.DEFAULT_TSTEPS) in cands
    assert Candidate("fused", 0, sh.DEFAULT_HALO_DEPTH) in cands
    # a custom ladder still carries the planner's pick
    cands, _ = candidate_space(Problem(24, 40), routes=("tile",),
                               ty_grid=(16,), t_ladder=(4,))
    assert Candidate("tile", 24, 8) in cands


# --------------------------------------------------------------------- #
# Measurement library
# --------------------------------------------------------------------- #

def test_simulated_backend_deterministic_and_classified():
    b = SimulatedBackend(build_error=Candidate("tile", 32, 12))
    p = Problem(4096, 4096)
    ok = measure_candidate(p, Candidate("tile", 64, 8), backend=b)
    assert ok.status == "ok"
    assert ok.step_time_s == measure_candidate(
        p, Candidate("tile", 64, 8), backend=b).step_time_s
    assert measure_candidate(p, Candidate("tile", 64, 16),
                             backend=b).status == "oom"
    assert measure_candidate(Problem(1800, 1800), Candidate("resident", 0, 8),
                             backend=b).status == "oom"
    assert measure_candidate(p, Candidate("tile", 32, 12),
                             backend=b).status == "compile_error"


def test_classify_failure_maps_the_cards_classes():
    assert classify_failure(ConfigError("bad config")) == "oom"
    assert classify_failure(torch.cuda.OutOfMemoryError("x")) == "oom"
    assert classify_failure(ValueError(
        "halo depth T=99 leaves no tile that fits 1 bytes of shared "
        "memory")) == "oom"
    assert classify_failure(RuntimeError(
        "nvcc failed building csrc/stencil.cu (rc 1)")) == "compile_error"
    assert classify_failure(RuntimeError(
        "H2 tile_multi failed: CUDA error 1 (x)")) == "compile_error"
    assert classify_failure(RuntimeError("flaky")) == "error"
    # a resident wait that gave up is a transient, retried on resume
    assert classify_failure(RuntimeError(
        "H4 resident: a block ... gave up")) == "error"


def test_real_measurement_refused_on_the_cpu(tmp_path, capsys):
    with pytest.raises(ValueError, match="card"):
        measure_candidate(Problem(32, 32), Candidate("tile", 32, 8),
                          device="cpu")
    with pytest.raises(ValueError, match="card"):
        tcli.search_problem(TuningDB(str(tmp_path / "db.json")),
                            Problem(32, 32), device="cpu",
                            out=io.StringIO())
    assert tcli.main(["--device", "cpu", "--shapes", "32x32",
                      "--db", str(tmp_path / "db.json")]) == 2
    assert "card" in capsys.readouterr().err
    assert not (tmp_path / "db.json").exists()


def test_device_kind_keys_the_cpu_apart(monkeypatch):
    assert tr.device_kind("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        tr.device_kind("cuda")


# --------------------------------------------------------------------- #
# The db: persistence, corruption, salt
# --------------------------------------------------------------------- #

def test_db_roundtrip_atomic(tmp_path):
    path = tmp_path / "db.json"
    db = TuningDB(str(path))
    db.record_point("cpu", "64x64:float32",
                    {"route": "tile", "bm": 16, "tsteps": 4,
                     "status": "ok", "step_time_s": 1e-6,
                     "mcells_per_s": 100.0})
    db.set_best("cpu", "64x64:float32",
                {"route": "tile", "bm": 16, "tsteps": 4}, 100.0, {})
    db.save()
    assert path.exists() and not (tmp_path / "db.json.tmp").exists()
    assert json.loads(path.read_text())["schema"] == jdb.DB_SCHEMA
    again = TuningDB(str(path))
    assert again.entry("cpu", "64x64:float32")["best"]["bm"] == 16


def test_corrupt_db_ignored_with_warning(tmp_path, caplog):
    path = tmp_path / "db.json"
    path.write_text("{ torn json!!")
    with caplog.at_level("WARNING", logger="heat2d_tpu_torch.tune"):
        db = TuningDB(str(path))
    assert db.corrupt
    assert any("corrupt" in r.message for r in caplog.records)
    assert db.lookup("cpu", 64, 64) is None
    tr.set_tuning_db(db)
    assert tr.band_config(64, 64, device="cpu") is None
    db.save()
    assert (tmp_path / "db.json.corrupt").read_text() == "{ torn json!!"
    assert TuningDB(str(path)).corrupt is False


def test_salt_mismatch_invisible(tmp_path):
    make_db(tmp_path / "db.json",
            {"64x64:float32": {"route": "tile", "bm": 16, "tsteps": 4}},
            salt="stale-salt")
    db = TuningDB(str(tmp_path / "db.json"))
    assert db.entry("cpu", "64x64:float32") is None
    assert db.lookup("cpu", 64, 64) is None
    assert db.entry("cpu", "64x64:float32", salted=False) is not None
    tr.set_tuning_db(db)
    assert tr.band_config(64, 64, device="cpu") is None


def test_salt_covers_the_kernels_and_planners(monkeypatch):
    """The salt hashes csrc/*.cu, *.cuh, NVCC_FLAGS and the two planner
    modules: a flag change hides every entry."""
    from heat2d_tpu_torch.ops import _build
    monkeypatch.setattr(tdb, "_salt_cache", None)
    before = tdb.current_salt()
    monkeypatch.setattr(tdb, "_salt_cache", None)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert tdb.current_salt() != before


# --------------------------------------------------------------------- #
# The lookup ladder
# --------------------------------------------------------------------- #

def test_lookup_exact_hit(tmp_path):
    db = make_db(tmp_path / "db.json",
                 {"64x64:float32": {"route": "tile", "bm": 16,
                                    "tsteps": 4}})
    cfg = db.lookup("cpu", 64, 64)
    assert cfg is not None and cfg.source == "exact"
    assert (cfg.route, cfg.bm, cfg.tsteps) == ("tile", 16, 4)
    assert cfg.matched_key == "64x64:float32"


def test_lookup_nearest_is_flagged(tmp_path):
    db = make_db(tmp_path / "db.json",
                 {"64x64:float32": {"route": "tile", "bm": 16,
                                    "tsteps": 4}})
    cfg = db.lookup("cpu", 96, 64)
    assert cfg is not None and cfg.source == "nearest"
    assert cfg.matched_key == "64x64:float32"
    assert db.lookup("cpu", 64, 4096) is None
    assert db.lookup("cpu", 64, 64, "bfloat16") is None


def test_lookup_missing_db_is_none(tmp_path):
    assert TuningDB(str(tmp_path / "absent.json")).lookup("cpu", 64,
                                                          64) is None


# --------------------------------------------------------------------- #
# Held against the JAX package
# --------------------------------------------------------------------- #

def _jax_document(path):
    """One document written by the JAX package's TuningDB: points, bests
    of several routes and shapes, a fused key, rollout stamps, a device
    stamp and a stale entry."""
    db = jdb.TuningDB(str(path))
    for key, best, pts in [
            ("64x64:float32", ("C", 16, 4),
             [("C", 16, 4, 120.0), ("C", 24, 8, 90.0),
              ("C2", 32, 8, None)]),
            ("96x128:float32", ("tile", 32, 12),
             [("tile", 32, 12, 300.0), ("tile", 64, 8, 250.0)]),
            ("640x1024:float32", ("resident", 0, 7),
             [("resident", 0, 7, 900.0), ("tile", 64, 8, 500.0)]),
            ("fused:32x32:float32", ("fused", 0, 4),
             [("fused", 0, 4, 50.0), ("fused", 0, 8, 40.0)])]:
        for route, bm, t, mc in pts:
            p = {"route": route, "bm": bm, "tsteps": t,
                 "status": "ok" if mc else "oom"}
            if mc:
                p.update(mcells_per_s=mc, step_time_s=1.0 / mc)
            db.record_point("cpu", key, p)
        db.set_best("cpu", key, dict(zip(("route", "bm", "tsteps"), best)),
                    max(mc or 0 for *_, mc in pts),
                    {"protocol": "jax", "timestamp":
                     "2026-01-01T00:00:00+00:00"})
    db.record_point("cpu", "8x8:float32", {"route": "C", "bm": 8,
                                           "tsteps": 2, "status": "ok",
                                           "mcells_per_s": 1.0})
    db.data["devices"]["cpu"]["entries"]["8x8:float32"]["salt"] = "stale"
    db.stamp_device("cpu", vmem_total_bytes=123)
    db.stamp_rollout(epoch=2, validated=True)
    db.mark_entries(validated=True, epoch=2)
    db.save()
    return db


@pytest.mark.parametrize("query,want", [
    ((64, 64), ("C", 16, 4, "exact", "64x64:float32")),
    ((80, 64), ("C", 16, 4, "nearest", "64x64:float32")),
    ((96, 128), ("tile", 32, 12, "exact", "96x128:float32")),
    ((96, 120), ("tile", 32, 12, "nearest", "96x128:float32")),
    ((640, 1024), ("resident", 0, 7, "exact", "640x1024:float32")),
    ((64, 4096), None),                    # too far
    ((8, 8), None),                        # stale salt
    ((32, 32, "bfloat16"), None),          # missing
])
def test_db_lookups_match_jax(tmp_path, pinned_salt, query, want):
    _jax_document(tmp_path / "db.json")
    jax_db = jdb.TuningDB(str(tmp_path / "db.json"))
    port_db = TuningDB(str(tmp_path / "db.json"))
    got, ref = port_db.lookup("cpu", *query), jax_db.lookup("cpu", *query)
    assert (got is None) == (ref is None) == (want is None)
    if want is not None:
        assert got.to_dict() == ref.to_dict()
        assert (got.route, got.bm, got.tsteps, got.source,
                got.matched_key) == want
    for key in ("64x64:float32", "fused:32x32:float32", "8x8:float32",
                "absent:float32"):
        assert port_db.entry("cpu", key) == jax_db.entry("cpu", key)
    assert (port_db.epoch, port_db.validated) == (jax_db.epoch,
                                                  jax_db.validated)


def test_db_merge_matches_jax(tmp_path, pinned_salt):
    _jax_document(tmp_path / "a.json")
    b = jdb.TuningDB(str(tmp_path / "b.json"))
    b.record_point("cpu", "64x64:float32",
                   {"route": "C", "bm": 16, "tsteps": 4, "status": "ok",
                    "mcells_per_s": 150.0})
    b.record_point("cpu", "64x64:float32",
                   {"route": "C2", "bm": 32, "tsteps": 8, "status": "ok",
                    "mcells_per_s": 140.0})
    b.set_best("cpu", "64x64:float32", {"route": "C", "bm": 16,
                                         "tsteps": 4}, 150.0,
               {"protocol": "b", "timestamp": "2026-02-01T00:00:00"})
    b.set_best("NVIDIA H100 80GB HBM3", "640x1024:float32",
               {"route": "resident", "bm": 0, "tsteps": 5}, 9e5, {})
    b.mark_entries(validated=False, epoch=3)
    b.save()
    for first, second in (("a", "b"), ("b", "a")):
        docs = []
        for mod in (jdb, tdb):
            db = mod.TuningDB(str(tmp_path / f"{first}.json"))
            summary = db.merge(mod.TuningDB(str(tmp_path / f"{second}.json")))
            docs.append((summary, json.dumps(db.data, sort_keys=True)))
        assert docs[0] == docs[1]


def test_frontier_table_matches_jax(tmp_path, pinned_salt):
    _jax_document(tmp_path / "db.json")
    jtable = jcli.frontier_table(jdb.TuningDB(str(tmp_path / "db.json")),
                                 "cpu")
    table = tcli.frontier_table(TuningDB(str(tmp_path / "db.json")), "cpu")
    # the port adds one line under a fused frontier saying what it timed
    assert table.splitlines() == jtable.splitlines() + [tcli.FUSED_NOTE]


# --------------------------------------------------------------------- #
# No db: nothing changes
# --------------------------------------------------------------------- #

def test_no_db_leaves_plans_and_results_alone(monkeypatch):
    """With no db the consults return None without reading anything, and
    the runner's depth and plans, H4's plan, the fused depth and the
    serve engine's tuned answer are the parent's; a CPU run's bytes are
    the plain steps'."""
    def boom(*a, **k):
        raise AssertionError("a consult read the db without a db")
    monkeypatch.setattr(TuningDB, "lookup", boom)
    monkeypatch.setattr(TuningDB, "entry", boom)
    assert tr.active_db() is None
    assert tr.band_config(64, 64, device="cpu") is None
    assert tr.resident_config(64, 64, device="cpu") is None
    assert tr.fused_config(64, 64, device="cpu") is None
    assert tr.measured_rate(64, 64, device="cpu") is None
    assert tr.applied_configs() == []

    streamed = HeatConfig(nxprob=2000, nyprob=2000, steps=9, mode="pallas")
    runner = cs.make_single_chip_runner(streamed, "cpu")
    assert runner.plan == cs.plan_strip_sweep(2000, 2000, cs.DEFAULT_TSTEPS)
    assert runner.plan.tsteps == 8 and runner.plan.ty == 64
    res = HeatConfig(nxprob=40, nyprob=56, steps=9, mode="pallas")
    runner = cs.make_single_chip_runner(res, "cpu")
    assert runner.plan == rs.plan_for_limits(
        1, 40, 56, 1, cs.smem_limit("cpu"), rs.H100_SM_COUNT)
    assert cs.resident_plan(40, 56, "cpu") == runner.plan
    u = torch.from_numpy(_inputs(40, 56))
    out, n = runner(u)
    assert n == 9 and torch.equal(out, cs.multi_step_plain(u, 9, 0.1, 0.1))

    cfg = HeatConfig(nxprob=40, nyprob=48, steps=5, mode="hybrid",
                     gridx=2, gridy=2, halo="fused")
    mesh = make_mesh(2, 2, host_devices(4, "cpu"))
    assert sh.effective_halo_depth(cfg, mesh) == sh.DEFAULT_HALO_DEPTH

    from heat2d_tpu_torch.obs import MetricsRegistry
    from heat2d_tpu_torch.serve.engine import EnsembleEngine
    from heat2d_tpu_torch.serve.schema import SolveRequest
    reg = MetricsRegistry()
    eng = EnsembleEngine(registry=reg, max_batch=4, device="cpu")
    req = SolveRequest(nx=16, ny=24, steps=3, cx=0.1, cy=0.1, method="band")
    eng.solve_batch([req])
    assert eng.launch_log[-1]["tuned_config"] is None
    assert reg.find_counters("tune_serve_signatures_total") == {
        (("tuned", "false"),): 1.0}


# --------------------------------------------------------------------- #
# A db steers the plans, never the bits
# --------------------------------------------------------------------- #

def test_db_entry_steers_the_tile_route(tmp_path):
    """A tile entry sets H2's depth and tile height (the runner's plan
    moves), its convergence sweeps (H3) too, and the result is bitwise
    the untuned run's."""
    cfg = HeatConfig(nxprob=2000, nyprob=2000, steps=30, mode="pallas",
                     convergence=True, interval=10, sensitivity=0.0)
    base = cs.make_single_chip_runner(cfg, "cpu")
    make_db(tmp_path / "db.json",
            {"2000x2000:float32": {"route": "tile", "bm": 16,
                                   "tsteps": 12}})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    tuned = cs.make_single_chip_runner(cfg, "cpu")
    assert (tuned.plan.ty, tuned.plan.tsteps) == (16, 12)
    assert base.plan != tuned.plan
    assert tuned.route == "streamed-fused"
    applied = tr.applied_configs()
    assert [(a["route"], a["bm"], a["tsteps"], a["source"])
            for a in applied] == [("tile", 16, 12, "exact")]
    # the plan moves no bit (on the CPU the plain steps run either way)
    u = torch.from_numpy(_inputs(2000, 2000))
    fixed = cfg.replace(convergence=False, steps=5)
    tr.set_tuning_db(None)
    want = cs.make_single_chip_runner(fixed, "cpu")(u)[0]
    tr.set_tuning_db(str(tmp_path / "db.json"))
    r = cs.make_single_chip_runner(fixed, "cpu")
    assert (r.plan.ty, r.plan.tsteps) == (16, 12)
    assert torch.equal(r(u)[0], want)


def test_db_entry_steers_the_resident_k(tmp_path):
    make_db(tmp_path / "db.json",
            {"40x56:float32": {"route": "resident", "bm": 0, "tsteps": 3}})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    cfg = HeatConfig(nxprob=40, nyprob=56, steps=9, mode="pallas")
    runner = cs.make_single_chip_runner(cfg, "cpu")
    assert runner.route == "resident" and runner.plan.k == 3
    assert runner.plan == cs.resident_plan(40, 56, "cpu", 3)
    u = torch.from_numpy(_inputs(40, 56))
    assert torch.equal(runner(u)[0], cs.multi_step_plain(u, 9, 0.1, 0.1))
    assert tr.applied_configs()[0]["tsteps"] == 3
    # the tile consult does not answer with the resident route's K
    assert tr.band_config(40, 56, device="cpu") is None


def test_db_entry_steers_the_fused_depth(tmp_path):
    """A fused entry for the shard shape sets the overlap depth of a
    hybrid --halo fused run (and of its halo record) and leaves its bits
    and the collective route alone."""
    cfg = HeatConfig(nxprob=40, nyprob=48, steps=11, mode="hybrid",
                     gridx=2, gridy=2, halo="fused")
    devs = host_devices(4, "cpu")
    want = Heat2DSolver(cfg, device="cpu", devices=devs).run(timed=False)
    make_db(tmp_path / "db.json",
            {"fused:20x24:float32": {"route": "fused", "bm": 0,
                                     "tsteps": 4}})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    mesh = make_mesh(2, 2, devs)
    assert sh.effective_halo_depth(cfg, mesh) == 4
    got = Heat2DSolver(cfg, device="cpu", devices=devs).run(timed=False)
    assert got.halo["depth"] == 4 and want.halo["depth"] == 8
    assert np.array_equal(got.u, want.u)
    # an explicit --halo-depth and the collective route never consult it
    assert sh.effective_halo_depth(cfg.replace(halo_depth=2), mesh) == 2
    assert sh.effective_halo_depth(cfg.replace(halo="collective"),
                                   mesh) == 8
    assert [a["matched_key"] for a in tr.applied_configs()] == [
        "fused:20x24:float32"]


def test_db_entry_steers_the_batched_routes(tmp_path):
    """The ensemble routes take the db's answer for the member shape:
    H6/H7's depth and tile height (band), H5's K (pallas); the serve
    engine's launch rows carry it, and the results are bitwise the
    untuned ones."""
    from heat2d_tpu_torch.serve.engine import EnsembleEngine
    from heat2d_tpu_torch.serve.schema import SolveRequest
    cxs, cys = [0.05, 0.1], [0.1, 0.2]
    want = tens.run_ensemble(24, 40, 13, cxs, cys, method="band",
                             device="cpu")
    make_db(tmp_path / "db.json",
            {"24x40:float32": {"route": "tile", "bm": 16, "tsteps": 12},
             "32x48:float32": {"route": "resident", "bm": 0,
                               "tsteps": 2}})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    u0 = torch.zeros(2, 24, 40)
    assert tens.tuned_tile(u0) == {"tsteps": 12, "ty": 16}
    assert tens.tuned_config("pallas", 32, 48, "cpu").tsteps == 2
    assert tens.tuned_config("jnp", 24, 40, "cpu") is None
    got = tens.run_ensemble(24, 40, 13, cxs, cys, method="band",
                            device="cpu")
    assert torch.equal(got, want)
    eng = EnsembleEngine(max_batch=4, device="cpu")
    for req, route, knobs in (
            (SolveRequest(nx=24, ny=40, steps=5, cx=0.1, cy=0.1,
                          method="band"), "tile", (16, 12)),
            (SolveRequest(nx=32, ny=48, steps=5, cx=0.1, cy=0.1,
                          method="auto"), "resident", (0, 2))):
        eng.solve_batch([req])
        row = eng.launch_log[-1]["tuned_config"]
        assert row["route"] == route and (row["bm"], row["tsteps"]) == knobs
        assert eng.tuned[req.signature()] == row
    # a jnp request runs no tuned kernel
    eng.solve_batch([SolveRequest(nx=24, ny=40, steps=5, cx=0.1, cy=0.1,
                                  method="jnp")])
    assert eng.launch_log[-1]["tuned_config"] is None
    # H5 takes the db's K (measured on one member) for one member only:
    # a batch of two keeps its planner's K, and its row says so
    assert tens.tuned_config("pallas", 32, 48, "cpu", members=2) is None
    eng.solve_batch([SolveRequest(nx=32, ny=48, steps=5, cx=c, cy=0.1)
                     for c in (0.05, 0.1)])
    assert eng.launch_log[-1]["capacity"] == 2
    assert eng.launch_log[-1]["tuned_config"] is None


def test_h6_takes_the_depth_at_run_time():
    """H6/H7's wrappers take T and the tile height as H2's do: any depth
    up to T, the plan of ``tile_plan`` at that depth."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    u = torch.from_numpy(np.stack([_inputs(24, 40, s) for s in (1, 2)]))
    cxs, cys = torch.tensor([0.05, 0.1]), torch.tensor([0.1, 0.2])
    want = ce.ens_multi_step_plain(u, 12, cxs, cys)
    assert torch.equal(ce.ens_tile_multi(u, 12, cxs, cys, tsteps=12), want)
    with pytest.raises(ValueError, match="T=8"):
        ce.ens_tile_multi(u, 12, cxs, cys)
    assert ce.tile_plan(24, 40, "cpu", 12, 16) == cs.plan_strip_sweep(
        24, 40, 12, ty=16)
    assert torch.equal(
        ce.ens_tiled_chunk(u, 30, cxs, cys, tsteps=16, ty=16),
        ce.ens_multi_step_plain(u, 30, cxs, cys))


@pytest.mark.parametrize("key,entry,consult", [
    # a T no tile fits
    ("200x300:float32", {"route": "tile", "bm": 32, "tsteps": 200},
     lambda: tr.band_config(200, 300, device="cpu")),
    # a tile the planner shrinks (64 rows at T = 16)
    ("4096x4096:float32", {"route": "tile", "bm": 64, "tsteps": 16},
     lambda: tr.band_config(4096, 4096, device="cpu")),
    # a tile height off the thread block's rows
    ("200x300:float32", {"route": "tile", "bm": 20, "tsteps": 8},
     lambda: tr.band_config(200, 300, device="cpu")),
    # a K plan_for_limits rejects
    ("1800x1800:float32", {"route": "resident", "bm": 0, "tsteps": 8},
     lambda: tr.resident_config(1800, 1800, device="cpu")),
    # a fused T over the shard
    ("fused:20x24:float32", {"route": "fused", "bm": 0, "tsteps": 16},
     lambda: tr.fused_config(20, 24, device="cpu")),
    # a depth H6's tile plan cannot fit, on the batched band route
    ("24x40:float32", {"route": "tile", "bm": 16, "tsteps": 300},
     lambda: tens.tuned_tile(torch.zeros(1, 24, 40))["ty"]),
])
def test_invalid_db_entry_falls_back(tmp_path, key, entry, consult):
    make_db(tmp_path / "db.json", {key: entry})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    assert consult() is None
    assert tr.applied_configs() == []


def test_invalid_entry_leaves_the_runners_on_their_plans(tmp_path):
    make_db(tmp_path / "db.json",
            {"1800x1800:float32": {"route": "resident", "bm": 0,
                                   "tsteps": 8},
             "2000x2000:float32": {"route": "tile", "bm": 32,
                                   "tsteps": 400}})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    r = cs.make_single_chip_runner(
        HeatConfig(nxprob=1800, nyprob=1800, mode="pallas"), "cpu")
    assert r.plan == cs.resident_plan(1800, 1800, "cpu")
    r = cs.make_single_chip_runner(
        HeatConfig(nxprob=2000, nyprob=2000, mode="pallas"), "cpu")
    assert r.plan == cs.tile_plan(2000, 2000, 8, "cpu")


def test_env_var_activates_and_switches_db(tmp_path, monkeypatch):
    make_db(tmp_path / "a.json",
            {"64x128:float32": {"route": "tile", "bm": 24, "tsteps": 4}})
    make_db(tmp_path / "b.json",
            {"64x128:float32": {"route": "tile", "bm": 32, "tsteps": 8}})
    monkeypatch.setenv(tr.ENV_VAR, str(tmp_path / "a.json"))
    assert tr.active_db() is not None
    assert tr.band_config(64, 128, device="cpu").bm == 24
    monkeypatch.setenv(tr.ENV_VAR, str(tmp_path / "b.json"))
    assert tr.band_config(64, 128, device="cpu").bm == 32
    assert tr.describe_active()["path"] == str(tmp_path / "b.json")
    monkeypatch.delenv(tr.ENV_VAR)
    assert tr.active_db() is None and tr.describe_active() is None


def test_a_card_db_never_steers_the_cpu(tmp_path):
    make_db(tmp_path / "db.json",
            {"64x128:float32": {"route": "tile", "bm": 24, "tsteps": 4}},
            kind="NVIDIA H100 80GB HBM3")
    tr.set_tuning_db(str(tmp_path / "db.json"))
    assert tr.band_config(64, 128, device="cpu") is None
    assert tr.measured_rate(64, 128, device="cpu") is None


def test_mesh_scheduler_prices_with_the_db_rate(tmp_path):
    from heat2d_tpu_torch.mesh.scheduler import MeshAdmission, MeshScheduler
    from heat2d_tpu_torch.serve.schema import SolveRequest
    req = SolveRequest(nx=24, ny=40, steps=5, cx=0.1, cy=0.1)
    devs = host_devices(2, "cpu")
    assert MeshScheduler(devices=devs).decide(req)[
        "tuned_mcells_per_s"] is None
    make_db(tmp_path / "db.json",
            {"24x40:float32": {"route": "tile", "bm": 16, "tsteps": 4,
                               "mcells": 777.0}})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    assert MeshScheduler(devices=devs).decide(req)[
        "tuned_mcells_per_s"] == 777.0
    adm = MeshAdmission(devices=devs)
    assert adm.capacity_cells_per_s(req) == 777.0 * 1e6 * 2


# --------------------------------------------------------------------- #
# Search end to end (simulated backend)
# --------------------------------------------------------------------- #

def test_search_resumes_as_pure_cache_hit(tmp_path):
    backend = SimulatedBackend()
    path = str(tmp_path / "db.json")
    s1 = tcli.search_problem(TuningDB(path), Problem(1800, 1800),
                             backend=backend, probe_past_envelope=True,
                             out=io.StringIO())
    assert s1["measured"] > 0 and s1["best"] is not None
    assert s1["failed"] > 0
    s2 = tcli.search_problem(TuningDB(path), Problem(1800, 1800),
                             backend=backend, probe_past_envelope=True,
                             out=io.StringIO())
    assert s2["measured"] == 0
    assert s2["cached"] == s1["measured"] + s1["cached"]
    assert s2["best"] == s1["best"]


def test_plain_resume_never_clobbers_probed_measurements(tmp_path):
    backend = SimulatedBackend()
    path = str(tmp_path / "db.json")
    tcli.search_problem(TuningDB(path), Problem(1800, 1800),
                        backend=backend, probe_past_envelope=True,
                        out=io.StringIO())
    key = "1800x1800:float32"
    before = TuningDB(path).entry(backend.device_kind, key)["points"]
    assert any(p["status"] == "oom" for p in before)
    tcli.search_problem(TuningDB(path), Problem(1800, 1800),
                        backend=backend, out=io.StringIO())
    after = TuningDB(path).entry(backend.device_kind, key)["points"]

    def by_key(points):
        return sorted(points, key=lambda p: (p["route"], p["bm"],
                                             p["tsteps"]))
    assert by_key(after) == by_key(before)


def test_search_then_lookup_roundtrip(tmp_path):
    backend = SimulatedBackend()
    path = str(tmp_path / "db.json")
    s = tcli.search_problem(TuningDB(path), Problem(4096, 4096),
                            backend=backend, out=io.StringIO())
    cfg = TuningDB(path).lookup(backend.device_kind, 4096, 4096)
    assert cfg is not None and cfg.source == "exact"
    assert (cfg.route, cfg.bm, cfg.tsteps) == (
        s["best"]["route"], s["best"]["bm"], s["best"]["tsteps"])
    fused = TuningDB(path).entry(backend.device_kind,
                                 "fused:4096x4096:float32")
    assert fused["best"]["route"] == "fused"
    assert fused["provenance"]["mesh"] == "2x2 slots on one card"


def test_frontier_table_matches_entries(tmp_path):
    backend = SimulatedBackend()
    path = str(tmp_path / "db.json")
    tcli.search_problem(TuningDB(path), Problem(640, 1024),
                        backend=backend, out=io.StringIO())
    db = TuningDB(path)
    table = tcli.frontier_table(db, backend.device_kind)
    best = db.entry(backend.device_kind, "640x1024:float32")["best"]
    tagged = [ln for ln in table.splitlines() if "<-- best" in ln]
    # one best per frontier: the shape's and its fused shard's
    assert len(tagged) == 2
    plain = [ln for ln in tagged if ln.lstrip().startswith("640x1024:")]
    assert len(plain) == 1 and best["route"] in plain[0]
    assert table.splitlines()[-1] == tcli.FUSED_NOTE
    rows = tcli.planner_rows(db, backend.device_kind, Problem(640, 1024))
    assert [r["route"] for r in rows] == ["resident", "tile", "fused"]
    assert sum(r["is_best"] for r in rows if r["key"] == "640x1024:float32") \
        == 1
    assert all(r["planner_point"]["status"] == "ok" for r in rows)


def test_selftest_cli_idempotent(tmp_path, capsys):
    rc = tcli.main(["--selftest", "--device", "cpu", "--db",
                    str(tmp_path / "db.json")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "selftest passed" in out and (tmp_path / "db.json").exists()
    rc2 = tcli.main(["--selftest", "--device", "cpu", "--db",
                     str(tmp_path / "db.json")])
    assert rc2 == 0, capsys.readouterr().out


def test_tune_metrics_flow_through_registry(tmp_path):
    from heat2d_tpu_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    tcli.search_problem(TuningDB(str(tmp_path / "db.json")),
                        Problem(640, 1024), backend=SimulatedBackend(),
                        registry=reg, out=io.StringIO())
    snap = reg.snapshot()
    measured = [v for k, v in snap["counters"].items()
                if k.startswith("tune_points_measured_total")]
    assert measured and sum(measured) > 0
    assert any(k.startswith("tune_best_mcells_per_s")
               for k in snap["gauges"])
    assert "tune_measure_s" in snap["histograms"]


def test_simulate_cli_writes_a_tune_record(tmp_path, capsys):
    metrics = tmp_path / "tune.jsonl"
    assert tcli.main(["--simulate", "--device", "cpu", "--shapes",
                      "640x1024", "--db", str(tmp_path / "db.json"),
                      "--metrics-out", str(metrics), "--export",
                      str(tmp_path / "export.json")]) == 0
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    rec = [x for x in lines if x["event"] == "run_record"][0]
    assert rec["kind"] == "tune" and rec["measured"] > 0
    assert json.loads((tmp_path / "export.json").read_text())[
        "schema"] == jdb.DB_SCHEMA
    assert tcli.main(["--print", "--db", str(tmp_path / "db.json")]) == 0
    assert "<-- best" in capsys.readouterr().out


# --------------------------------------------------------------------- #
# Records
# --------------------------------------------------------------------- #

def test_cli_run_record_has_tuned_config(tmp_path):
    from heat2d_tpu_torch.cli import main
    make_db(tmp_path / "db.json",
            {"2000x2000:float32": {"route": "tile", "bm": 16,
                                   "tsteps": 4}})
    outs = {}
    for use in (False, True):
        tr.set_tuning_db(str(tmp_path / "db.json") if use else None)
        out = tmp_path / f"run{use}"
        assert main(["--device", "cpu", "--mode", "pallas", "--nxprob",
                     "2000", "--nyprob", "2000", "--steps", "6",
                     "--dat-layout", "none", "--binary-dumps", "--outdir",
                     str(out), "--run-record", str(out / "rec.json")]) == 0
        outs[use] = (json.loads((out / "rec.json").read_text()),
                     (out / "final_binary.dat").read_bytes())
    assert "tuned_config" not in outs[False][0]
    tuned = outs[True][0]["tuned_config"]
    assert [(t["route"], t["bm"], t["tsteps"], t["source"])
            for t in tuned] == [("tile", 16, 4, "exact")]
    assert outs[True][1] == outs[False][1]


def test_ensemble_record_has_tuned_config(tmp_path):
    from heat2d_tpu_torch.cli import main
    make_db(tmp_path / "db.json",
            {"20x36:float32": {"route": "resident", "bm": 0, "tsteps": 3}})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    rec = tmp_path / "rec.json"
    args = ["--device", "cpu", "--nxprob", "20", "--nyprob", "36",
            "--steps", "9", "--dat-layout", "none", "--outdir",
            str(tmp_path), "--run-record", str(rec)]
    # one member: H5 takes the db's K
    assert main(args + ["--ensemble-cx", "0.1", "--ensemble-cy",
                        "0.1"]) == 0
    tuned = json.loads(rec.read_text())["tuned_config"]
    assert tuned[0]["route"] == "resident" and tuned[0]["tsteps"] == 3
    # two: the batch keeps its planner's K, and nothing was applied
    tr.reset_applied()
    assert main(args + ["--ensemble-cx", "0.1,0.2", "--ensemble-cy",
                        "0.1,0.1"]) == 0
    assert "tuned_config" not in json.loads(rec.read_text())


def test_inverse_record_has_no_tuned_config_without_db(tmp_path):
    """The JAX package's rule: the inverse record has a ``tuned_config``
    key only when a config was applied."""
    from heat2d_tpu_torch.diff import cli as dcli
    from heat2d_tpu_torch.obs import MetricsRegistry

    class Args:
        metrics_out = None
        run_record = str(tmp_path / "rec.json")
        device = "cpu"
    dcli._write_outputs(Args, MetricsRegistry(), {"iterations": 1})
    assert "tuned_config" not in json.loads(
        (tmp_path / "rec.json").read_text())
    make_db(tmp_path / "db.json",
            {"64x64:float32": {"route": "tile", "bm": 16, "tsteps": 4}})
    tr.set_tuning_db(str(tmp_path / "db.json"))
    assert tr.adjoint_config(64, 64, device="cpu").bm == 16
    dcli._write_outputs(Args, MetricsRegistry(), {"iterations": 1})
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["tuned_config"][0]["matched_key"] == "64x64:float32"


def test_solver_metrics_out_matches_the_jax_cli(tmp_path):
    """``--metrics-out`` writes the JAX CLI's JSONL: a ``run_start``
    event, the snapshot with the steps_done/elapsed_s/warmup_compile_s
    gauges, and the run record with ``metrics_aggregate``; ``--log-level``
    is taken."""
    from heat2d_tpu.cli import main as jmain
    from heat2d_tpu_torch.cli import main
    args = ["--mode", "serial", "--nxprob", "24", "--nyprob", "24",
            "--steps", "30", "--dat-layout", "none", "--log-level",
            "warning"]
    lines = {}
    for name, fn, extra in (("jax", jmain, []),
                            ("port", main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        assert fn(args + extra + ["--outdir", str(tmp_path / name),
                                  "--metrics-out", str(path)]) == 0
        lines[name] = [json.loads(x) for x in path.read_text().splitlines()]
    for name in ("jax", "port"):
        assert [x["event"] for x in lines[name]] == [
            "run_start", "snapshot", "run_record"]
    assert set(lines["port"][0]) == set(lines["jax"][0])
    for k in ("mode", "grid", "steps"):
        assert lines["port"][0][k] == lines["jax"][0][k]
    assert set(lines["port"][1]["gauges"]) == set(lines["jax"][1]["gauges"])
    assert lines["port"][1]["gauges"]["steps_done"] == 30
    rec, jrec = lines["port"][2], lines["jax"][2]
    assert set(rec["metrics_aggregate"]) == set(jrec["metrics_aggregate"])
    assert rec["metrics_aggregate"]["steps_done"] == {
        "rank_max": 30.0, "rank_mean": 30.0, "rank_min": 30.0}
    assert "tuned_config" not in rec and "tuned_config" not in jrec


# --------------------------------------------------------------------- #
# fleet-wide db consolidation: TuningDB.merge + --merge CLI
# --------------------------------------------------------------------- #

def _point(route, bm, t, mcells=None, status="ok"):
    p = {"route": route, "bm": bm, "tsteps": t, "status": status}
    if mcells is not None:
        p["mcells_per_s"] = mcells
        p["step_time_s"] = 1.0 / mcells
    return p


def _worker_db(path, kind="cpu", points=(), best=None, ts="2026-01-01"):
    db = TuningDB(str(path))
    key = "64x64:float32"
    for p in points:
        db.record_point(kind, key, dict(p))
    if best is not None:
        db.set_best(kind, key,
                    {"route": best["route"], "bm": best["bm"],
                     "tsteps": best["tsteps"]}, best["mcells_per_s"],
                    {"protocol": f"worker@{path}",
                     "timestamp": f"{ts}T00:00:00+00:00"})
    db.save()
    return db


def _best(route, bm, t, mc):
    return {"route": route, "bm": bm, "tsteps": t, "mcells_per_s": mc}


def test_db_merge_same_salt_keeps_best_and_unions_points(tmp_path):
    a = _worker_db(tmp_path / "a.json",
                   points=[_point("tile", 8, 8, 100.0),
                           _point("tile", 16, 8, 120.0),
                           _point("resident", 0, 4, status="oom")],
                   best=_best("tile", 16, 8, 120.0))
    _worker_db(tmp_path / "b.json",
               points=[_point("tile", 16, 8, 150.0),
                       _point("resident", 0, 4, 140.0),
                       _point("tile", 32, 8, 90.0)],
               best=_best("tile", 16, 8, 150.0), ts="2026-02-01")
    s = a.merge(TuningDB(str(tmp_path / "b.json")))
    assert s["entries_merged"] == 1 and s["points_added"] == 1
    e = a.entry("cpu", "64x64:float32")
    by_key = {(p["route"], p["bm"], p["tsteps"]): p for p in e["points"]}
    assert len(by_key) == 4
    assert by_key[("tile", 16, 8)]["mcells_per_s"] == 150.0
    assert by_key[("resident", 0, 4)]["status"] == "ok"
    assert e["best"] == {"route": "tile", "bm": 16, "tsteps": 8}
    assert e["provenance"]["protocol"].endswith("b.json")
    cfg = a.lookup("cpu", 64, 64)
    assert cfg is not None and cfg.bm == 16 and cfg.source == "exact"


def test_db_merge_current_salt_wins_over_stale(tmp_path):
    a = _worker_db(tmp_path / "a.json",
                   points=[_point("tile", 8, 8, 999.0)],
                   best=_best("tile", 8, 8, 999.0))
    a.data["devices"]["cpu"]["entries"]["64x64:float32"]["salt"] = \
        "stale-aaaa"
    b = _worker_db(tmp_path / "b.json",
                   points=[_point("tile", 16, 8, 10.0)],
                   best=_best("tile", 16, 8, 10.0))
    a.merge(b)
    assert a.entry("cpu", "64x64:float32")["best"]["bm"] == 16
    b2 = TuningDB(str(tmp_path / "b.json"))
    stale = {"devices": {"cpu": {"entries": {"64x64:float32": {
        "salt": "stale-bbbb", "points": [_point("tile", 24, 8, 5000.0)],
        "best": {"route": "tile", "bm": 24, "tsteps": 8},
        "mcells_per_s": 5000.0,
        "provenance": {"timestamp": "2030-01-01T00:00:00+00:00"}}}}}}
    assert b2.merge(stale)["entries_kept"] == 1
    assert b2.entry("cpu", "64x64:float32")["best"]["bm"] == 16


def test_db_merge_new_device_kind_and_stamps(tmp_path):
    a = TuningDB(str(tmp_path / "a.json"))
    a.stamp_device("cpu", note=111)
    b = _worker_db(tmp_path / "b.json", kind="NVIDIA H100 80GB HBM3",
                   points=[_point("tile", 64, 16, 9000.0)],
                   best=_best("tile", 64, 16, 9000.0))
    b.stamp_device("cpu", note=222)
    assert a.merge(b)["entries_added"] == 1
    assert a.lookup("NVIDIA H100 80GB HBM3", 64, 64).route == "tile"
    assert a.device("cpu")["note"] == 111
    with pytest.raises(ValueError):
        a.merge({"not": "a db"})


def test_db_rollout_stamps_roundtrip(tmp_path):
    db = _worker_db(tmp_path / "a.json",
                    points=[_point("tile", 8, 8, 100.0)],
                    best=_best("tile", 8, 8, 100.0))
    assert db.epoch == 0 and db.validated is True
    db.stamp_rollout(epoch=3, validated=False)
    assert db.mark_entries(validated=False, epoch=3) == 1
    db.save()
    back = TuningDB(str(tmp_path / "a.json"))
    assert back.epoch == 3 and back.validated is False
    e = back.entry("cpu", "64x64:float32")
    assert e["validated"] is False and e["epoch"] == 3


def test_db_merge_prefers_validated_at_equal_salt(tmp_path):
    a = _worker_db(tmp_path / "a.json",
                   points=[_point("tile", 8, 8, 100.0)],
                   best=_best("tile", 8, 8, 100.0))
    a.mark_entries(validated=True, epoch=2)
    a.save()
    b = _worker_db(tmp_path / "b.json",
                   points=[_point("tile", 16, 8, 500.0)],
                   best=_best("tile", 16, 8, 500.0), ts="2026-03-01")
    b.mark_entries(validated=False, epoch=3)
    b.save()
    assert a.merge(TuningDB(str(tmp_path / "b.json")))["points_added"] == 1
    e = a.entry("cpu", "64x64:float32")
    assert e["best"]["bm"] == 8 and e["validated"] is True
    b2 = TuningDB(str(tmp_path / "b.json"))
    b2.merge(TuningDB(str(tmp_path / "a.json")))
    assert b2.entry("cpu", "64x64:float32")["best"]["bm"] == 8


def test_db_merge_unstamped_incumbent_beats_staged_candidate(tmp_path):
    inc = _worker_db(tmp_path / "incumbent.json",
                     points=[_point("tile", 8, 8, 100.0)],
                     best=_best("tile", 8, 8, 100.0))
    cand = _worker_db(tmp_path / "candidate.json",
                      points=[_point("tile", 16, 8, 999.0)],
                      best=_best("tile", 16, 8, 999.0), ts="2026-05-01")
    cand.mark_entries(validated=False, epoch=1)
    cand.save()
    inc.merge(TuningDB(str(tmp_path / "candidate.json")))
    assert inc.entry("cpu", "64x64:float32")["best"]["bm"] == 8
    cand2 = TuningDB(str(tmp_path / "candidate.json"))
    cand2.merge(inc)
    e2 = cand2.entry("cpu", "64x64:float32")
    assert e2["best"]["bm"] == 8 and e2.get("validated", True) is True


def test_frontier_table_surfaces_validation_stamps(tmp_path):
    db = _worker_db(tmp_path / "a.json",
                    points=[_point("tile", 8, 8, 100.0)],
                    best=_best("tile", 8, 8, 100.0))
    assert "[" not in tcli.frontier_table(db, "cpu").split("best")[-1]
    db.mark_entries(validated=False, epoch=4)
    assert "<-- best [candidate e4]" in tcli.frontier_table(db, "cpu")
    db.mark_entries(validated=True, epoch=4)
    assert "<-- best [validated e4]" in tcli.frontier_table(db, "cpu")


def test_merge_cli_writes_consolidated_db(tmp_path):
    _worker_db(tmp_path / "a.json", points=[_point("tile", 8, 8, 100.0)],
               best=_best("tile", 8, 8, 100.0))
    _worker_db(tmp_path / "b.json", points=[_point("tile", 16, 8, 160.0)],
               best=_best("tile", 16, 8, 160.0), ts="2026-03-01")
    out = tmp_path / "merged.json"
    assert tcli.main(["--merge", str(tmp_path / "a.json"),
                      str(tmp_path / "b.json"), "-o", str(out)]) == 0
    cfg = TuningDB(str(out)).lookup("cpu", 64, 64)
    assert cfg is not None and cfg.bm == 16 and cfg.mcells_per_s == 160.0
    assert tcli.main(["--merge", str(tmp_path / "a.json")]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{torn")
    assert tcli.main(["--merge", str(tmp_path / "a.json"), str(bad),
                      "-o", str(out)]) == 1
    assert TuningDB(str(out)).lookup("cpu", 64, 64).bm == 8
    assert os.path.exists(out)
