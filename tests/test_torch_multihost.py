"""Real multi-process worlds of the port's CLI on the CPU: the mpiexec-
style launch the reference's MPI programs assume, as
tests/test_multihost.py runs the JAX package's (which skips here: its
CPU backend cannot run cross-process computations; gloo can).

Each world is ``python -m heat2d_tpu_torch.cli --device cpu --coordinator
... --num-processes N --process-id i`` spawned through
``dist/harness.spawn_world`` with a 60 s timeout; the mesh spans the
processes, strips cross ranks by gloo sends and receives, and the
residual is summed in shard order on every rank. Six worlds:

- dist2d, 2 processes x 2 slots, with the parallel binary write and the
  collective managed checkpoints every 6 steps under
  HEAT2D_FORBID_GATHER=1, then a second world that resumes from the
  directory past a torn newest snapshot;
- dist2d in float64, 4 processes x 1 slot, text output (the gather);
- hybrid ``--halo fused`` (the CPU twins of H12), which must record the
  collective tier, with the single-file collective checkpoint;
- hybrid ``--convergence`` (the CPU twins of H13), steps_done equal; in
  the same world ``--metrics-out`` (process 0's file: the aggregate over
  ranks and the residual trajectory) and ``--trace-dir`` (a span file a
  rank, each rank's run one connected trace);
- ensembles, 2 processes, four CLI runs in one world: spatial members on
  a 2x1 submesh of each rank (('b'=2, x=2, y=1)) and on one submesh
  spanning both ranks with per-member exits, batch-sharded members over
  every rank's slots, fixed and with exits; ``.dat`` bytes equal the
  one-process runs' and the JAX package's serial runs'.

Tolerances. Within the port every comparison is bitwise: against the
one-process run of the same mode (and dist2d against mode serial). The
JAX package's single-process serial run in float32 is within
``n * 2**-21 * max|ref|`` after n steps (XLA's CPU jit contracts
multiply-adds into FMAs, torch eager rounds every operation); in float64
its ``.dat`` text is byte for byte the port's.
"""

import json
import sys

import numpy as np
import pytest
import torch

from heat2d_tpu import cli as jcli
from heat2d_tpu.config import HeatConfig as JConfig
from heat2d_tpu.models.solver import Heat2DSolver as JSolver
from heat2d_tpu_torch import cli as tcli
from heat2d_tpu_torch.dist.harness import clean_env, spawn_world
from heat2d_tpu_torch.io.binary import load_checkpoint
from heat2d_tpu_torch.resil import CheckpointManager

GRID = ["--nxprob", "16", "--nyprob", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(outdir, args, *, n=2, slots=2, env=None):
    """One N-process world of the port's CLI; returns every process's
    merged output (asserting each exited 0)."""
    results = spawn_world(
        n, lambda i, coord: [
            sys.executable, "-m", "heat2d_tpu_torch.cli", "--device", "cpu",
            "--coordinator", coord, "--num-processes", str(n),
            "--process-id", str(i), "--host-device-count", str(slots),
            "--outdir", str(outdir)] + args,
        env=clean_env(env), timeout=60)
    outs = [r.output for r in results]
    assert all(r.ok for r in results), outs
    return outs


def _one_process(outdir, args, slots=4):
    """The same run in this process over ``slots`` CPU slots."""
    assert tcli.main(["--device", "cpu", "--host-device-count", str(slots),
                      "--outdir", str(outdir)] + args) == 0


def _bytes(path):
    return path.read_bytes()


def test_two_process_dist2d_parallel_binary_write(tmp_path):
    """dist2d 16x16 x 10 on a 2x2 mesh of two processes x two slots: the
    per-shard binary dumps (the MPI_File_write_all analogue) and the
    collective managed checkpoints (``--checkpoint DIR/
    --checkpoint-every 6``: snapshots at steps 6 and 10), all under the
    no-gather tripwire, are byte for byte the one-process dist2d run's
    and mode serial's; within the FMA bound of the JAX package's serial
    run; process 0 alone prints the banner and writes the record, whose
    elapsed time is the slowest process's (``max_over_processes``).
    Then step 10's snapshot is torn and a second world resumes from
    ``latest_valid()`` (step 6) for the remaining 4 steps, still under
    the tripwire: its final_binary.dat is the first world's."""
    args = ["--mode", "dist2d", "--gridx", "2", "--gridy", "2"] + GRID + [
        "--steps", "10", "--binary-dumps", "--dat-layout", "none"]
    w = tmp_path / "world"
    ck = tmp_path / "ck"
    outs = _world(w, args + ["--checkpoint", str(ck) + "/",
                             "--checkpoint-every", "6",
                             "--run-record", str(w / "rec.json")],
                  env={"HEAT2D_FORBID_GATHER": "1"})
    assert sum("Problem size:16x16" in o for o in outs) == 1, outs
    assert sum("Elapsed time:" in o for o in outs) == 1, outs
    _one_process(tmp_path / "one", args)
    _one_process(tmp_path / "serial", ["--mode", "serial"] + GRID
                 + ["--steps", "10", "--binary-dumps", "--dat-layout",
                    "none"], slots=1)
    for name in ("initial_binary.dat", "final_binary.dat"):
        assert _bytes(w / name) == _bytes(tmp_path / "one" / name), name
        assert _bytes(w / name) == _bytes(tmp_path / "serial" / name), name
    got = np.fromfile(w / "final_binary.dat", np.float32).reshape(16, 16)
    ref = np.asarray(JSolver(JConfig(nxprob=16, nyprob=16, steps=10))
                     .run(timed=False).u)
    assert float(np.abs(got - ref).max()) <= 10 * 2.0 ** -21 * float(
        np.abs(ref).max())
    m = CheckpointManager(ck, keep=None)
    assert m.steps() == [6, 10]
    grid, step, _ = load_checkpoint(m.path_for(10))
    assert step == 10 and grid.shape == (16, 16)
    assert grid.tobytes() == _bytes(w / "final_binary.dat")
    with open(m.path_for(10), "r+b") as f:      # tear the newest
        f.write(b"\xff" * 16)
    r = tmp_path / "resumed"
    outs = _world(r, args + ["--resume", str(ck),
                             "--run-record", str(r / "rec.json")],
                  env={"HEAT2D_FORBID_GATHER": "1"})
    assert sum("Resuming from step 6" in o for o in outs) == 1, outs
    assert _bytes(r / "final_binary.dat") == _bytes(w / "final_binary.dat")
    rr = json.loads((r / "rec.json").read_text())
    assert (rr["resume_from_step"], rr["steps_done"],
            rr["total_steps_including_resume"]) == (6, 4, 10)
    rec = json.loads((w / "rec.json").read_text())
    assert rec["world"] == {"process_index": 0, "process_count": 2}
    assert rec["mesh"]["processes"] == [0, 1]
    assert len(rec["elapsed_by_process"]) == 2
    assert rec["elapsed_s"] == max(rec["elapsed_by_process"])
    assert rec["checkpoints_written"] == 2
    # the timed runs' exchanges alone (the warmups' left out): one chunk
    # in each segment, of 6 and 4 steps, each moving two (t, 8) strips
    # each way a rank
    ex = rec["exchange_by_process"]
    assert [e["exchanges"] for e in ex] == [2, 2]
    assert [e["bytes"] for e in ex] == [2 * 2 * (6 + 4) * 8 * 4] * 2


def test_four_process_dist2d_float64_text_equals_jax(tmp_path):
    """dist2d in float64 on a 2x2 mesh of four processes, one slot each:
    the ``.dat`` text (gathered to process 0) is byte for byte the
    one-process dist2d run's and the JAX package's serial float64
    run's."""
    args = ["--mode", "dist2d", "--gridx", "2", "--gridy", "2"] + GRID + [
        "--steps", "10", "--accum-dtype", "float64"]
    w = tmp_path / "world"
    outs = _world(w, args, n=4, slots=1)
    assert sum("Writing final.dat" in o for o in outs) == 1, outs
    _one_process(tmp_path / "one", args)
    assert jcli.main(["--mode", "serial", "--accum-dtype", "float64",
                      "--steps", "10", "--outdir", str(tmp_path / "jax")]
                     + GRID) == 0
    for name in ("initial.dat", "final.dat"):
        assert _bytes(w / name) == _bytes(tmp_path / "one" / name), name
        assert _bytes(w / name) == _bytes(tmp_path / "jax" / name), name


def test_two_process_hybrid_fused_takes_the_collective_tier(tmp_path):
    """hybrid ``--halo fused`` across processes: H14 cannot read another
    process's blocks, so the route records the collective tier (as the
    JAX package records a degradation), and the result is bit for bit
    the one-process hybrid run's (which takes H14's tier there)."""
    args = ["--mode", "hybrid", "--gridx", "2", "--gridy", "2"] + GRID + [
        "--steps", "10", "--halo", "fused", "--halo-depth", "2",
        "--binary-dumps", "--dat-layout", "none"]
    w = tmp_path / "world"
    _world(w, args + ["--run-record", str(w / "rec.json"),
                      "--checkpoint", str(w / "ck.bin")],
           env={"HEAT2D_FORBID_GATHER": "1"})
    _one_process(tmp_path / "one",
                 args + ["--run-record", str(tmp_path / "one.json")])
    assert _bytes(w / "final_binary.dat") == \
        _bytes(tmp_path / "one" / "final_binary.dat")
    # the single-file collective checkpoint of the final state
    grid, step, _ = load_checkpoint(str(w / "ck.bin"))
    assert step == 10 and grid.tobytes() == _bytes(w / "final_binary.dat")
    halo = json.loads((w / "rec.json").read_text())["halo"]
    assert (halo["requested"], halo["route"], halo["tier"]) == \
        ("fused", "collective", "collective")
    one = json.loads((tmp_path / "one.json").read_text())["halo"]
    assert (one["route"], one["tier"]) == ("fused", "ici")


def test_two_process_hybrid_convergence_matches_one_process(tmp_path):
    """hybrid ``--convergence`` across processes (the H13 route): every
    rank sums the shards' residual partials in shard order, so the run
    exits at the one-process run's step with its bytes."""
    args = ["--mode", "hybrid", "--gridx", "2", "--gridy", "2"] + GRID + [
        "--steps", "400", "--convergence", "--interval", "10",
        "--sensitivity", "1000", "--binary-dumps", "--dat-layout", "none"]
    w = tmp_path / "world"
    _world(w, args + ["--run-record", str(w / "rec.json"),
                      "--metrics-out", str(w / "m.jsonl"),
                      "--trace-dir", str(w / "trace")])
    _one_process(tmp_path / "one",
                 args + ["--run-record", str(tmp_path / "one.json")])
    rec = json.loads((w / "rec.json").read_text())
    one = json.loads((tmp_path / "one.json").read_text())
    assert rec["route"] == one["route"] == "sharded-kernel-resid"
    assert rec["steps_done"] == one["steps_done"] == 230
    assert rec["residual_reads"] == one["residual_reads"]
    assert _bytes(w / "final_binary.dat") == \
        _bytes(tmp_path / "one" / "final_binary.dat")
    # --metrics-out in the world: process 0 writes the aggregate over
    # both ranks and the residual trajectory every rank read alike
    lines = [json.loads(x) for x in
             (w / "m.jsonl").read_text().splitlines()]
    agg = lines[-1]["metrics_aggregate"]
    assert agg["steps_done"] == {"rank_max": 230.0, "rank_mean": 230.0,
                                 "rank_min": 230.0}
    assert agg["elapsed_s"]["rank_max"] >= agg["elapsed_s"]["rank_min"]
    traj = lines[-1]["residual_trajectory"]
    assert [p["step"] for p in traj] == list(range(10, 240, 10))
    assert traj == rec["residual_trajectory"]
    # --trace-dir in the world: one span file a rank, each rank's run one
    # connected trace
    from heat2d_tpu_torch.obs import trace_cli
    files = sorted((w / "trace").iterdir())
    assert len(files) == 2 and all(f.name.startswith("spans-cli-")
                                   for f in files)
    report = trace_cli.merge_report(str(w / "trace"))
    assert len(report["traces"]) == 2
    assert all(r["connected"] and r["processes"] == 1
               for r in report["traces"])
    assert rec["trace_id"] in {r["trace_id"] for r in report["traces"]}


#: One process of the ensemble world: joins the world once and runs the
#: CLI for each launch line in turn (``cli._main`` inside the world).
_ENSEMBLE_DRIVER = """
import json, sys
from heat2d_tpu_torch import cli
from heat2d_tpu_torch.parallel import multihost as mh
coord, n, pid, runs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    json.loads(sys.argv[4])
mh.initialize_distributed(coord, n, pid)
try:
    for argv in runs:
        args = cli.build_parser().parse_args(argv)
        args.trace_span = None
        rc = cli._main(args)
        if rc:
            sys.exit(rc)
finally:
    mh.shutdown_distributed()
"""

#: The ensemble runs of the world, by name: (the port's flags, slots a
#: process); the JAX package's serial run takes the same steps and
#: convergence flags.
CONV = ["--steps", "60", "--convergence", "--interval", "2",
        "--sensitivity", "5e3"]
ENSEMBLE_RUNS = {
    # ('b'=2, x=2, y=1): each member's 2x1 submesh on one process
    "spatial": (["--mode", "dist2d", "--gridx", "2", "--gridy", "1"], 2),
    # one 2x1 submesh spanning both processes, members exiting early:
    # strips and residual partials cross the ranks
    "spatial_span": (["--mode", "dist2d", "--gridx", "2", "--gridy", "1"]
                     + CONV, 1),
    # batch-sharded: members over every rank's slots
    "batch": (["--mode", "dist1d"], 2),
    "batch_conv": (["--mode", "hybrid"] + CONV, 1),
}
MEMBERS = ["--ensemble-cx", "0.03125,0.25,0.1", "--ensemble-cy",
           "0.03125,0.25,0.1"]


def test_two_process_ensembles_match_one_process_and_jax(tmp_path):
    """Ensembles across processes (batch-sharded and spatial, fixed and
    with per-member exits) in one 2-process world: process 0 alone prints
    and writes, every ``final_m<i>.dat`` equals the one-process run's
    (over as many slots) and the JAX package's single-process serial
    run's, steps_done equal, and the record carries each rank's
    elapsed."""
    runs = []
    for name, (flags, slots) in ENSEMBLE_RUNS.items():
        runs.append(["--device", "cpu", "--host-device-count", str(slots),
                     "--outdir", str(tmp_path / name), "--run-record",
                     str(tmp_path / f"{name}.json"), "--steps", "10"]
                    + GRID + MEMBERS + flags)
    results = spawn_world(
        2, lambda i, coord: [sys.executable, "-c", _ENSEMBLE_DRIVER, coord,
                             "2", str(i), json.dumps(runs)],
        env=clean_env(), timeout=120)
    outs = [r.output for r in results]
    assert all(r.ok for r in results), outs
    assert outs[1] == "", outs[1]
    assert outs[0].count("Starting ensemble of 3 members") == 4
    assert "Each member decomposed over a 2x1 spatial submesh" in outs[0]
    for name, (flags, slots) in ENSEMBLE_RUNS.items():
        one = tmp_path / f"{name}_one"
        _one_process(one, ["--steps", "10"] + GRID + MEMBERS + flags
                     + ["--run-record", str(tmp_path / f"{name}_one.json")],
                     slots=2 * slots)
        jax = tmp_path / f"{name}_jax"
        assert jcli.main(["--mode", "serial", "--platform", "cpu",
                          "--outdir", str(jax), "--steps", "10"] + GRID
                         + MEMBERS + (CONV if CONV[-1] in flags
                                      else [])) == 0
        for i in range(3):
            got = _bytes(tmp_path / name / f"final_m{i}.dat")
            assert got == _bytes(one / f"final_m{i}.dat"), (name, i)
            assert got == _bytes(jax / f"final_m{i}.dat"), (name, i)
        rec = json.loads((tmp_path / f"{name}.json").read_text())
        ref = json.loads((tmp_path / f"{name}_one.json").read_text())
        assert rec["summary"] == ref["summary"], name
        assert len(rec["elapsed_by_process"]) == 2
        assert rec["elapsed_s"] == max(rec["elapsed_by_process"])
        assert rec["route"] == ref["route"]
    for name in ("spatial_span", "batch_conv"):
        done = json.loads((tmp_path / f"{name}.json").read_text())[
            "summary"]["steps_done"]
        assert done[0] < 60 and done[1] == 60, (name, done)
