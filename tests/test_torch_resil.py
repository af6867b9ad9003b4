"""The port's resilience layer (``heat2d_tpu_torch/resil``: the checkpoint
manager, the async writer, the checkpoint kill points, and the solver
CLI's managed and periodic checkpoints) against ``heat2d_tpu/resil`` on
the CPU.

- the manager's retention, torn-entry fallback, lost-manifest scan and
  metrics, the async writer's overlap, back-pressure and abandoned
  commits, and the chaos environment's parsing, as
  ``tests/test_resil.py`` checks the JAX package's;
- manager directories written by either stack load verified in the
  other;
- a CLI run killed at a checkpoint's commit (a subprocess: the kill is
  ``os._exit(137)``) resumes from the last durable snapshot, and a torn
  newest snapshot falls back to the previous one; the final bytes equal
  an uninterrupted run's and, at ``--accum-dtype float64``, the JAX
  CLI's;
- ``--checkpoint-every`` leaves the grid bit for bit as it is, in every
  mode (the segment driver), and refuses what the JAX CLI refuses.

Tolerance: every comparison is bitwise.

With ``HEAT2D_LOCK_AUDIT=1`` every test runs under the port's lock
auditor and fails on a lock-order cycle or a guarded write without its
lock.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from heat2d_tpu import cli as jcli
from heat2d_tpu.config import HeatConfig as JConfig
from heat2d_tpu.resil import CheckpointManager as JManager
from heat2d_tpu.resil import chaos as jchaos
from heat2d_tpu_torch import cli as tcli
from heat2d_tpu_torch.analysis import locks
from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.io import binary as tbin
from heat2d_tpu_torch.obs import MetricsRegistry
from heat2d_tpu_torch.ops.init import inidat
from heat2d_tpu_torch.resil import (AsyncCheckpointer, ChaosConfig,
                                    CheckpointManager, is_manager_dir)
from heat2d_tpu_torch.resil import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _chaos_disarmed():
    """Every test starts and ends with no campaign in either package."""
    chaos.uninstall()
    jchaos.uninstall()
    yield
    chaos.uninstall()
    jchaos.uninstall()


@pytest.fixture(autouse=True)
def _lock_audit():
    """The port's lock auditor, armed by HEAT2D_LOCK_AUDIT=1 (the JAX
    package's variable; tests/conftest.py wires the JAX auditor only)."""
    if not locks._env_enabled():
        yield
        return
    locks.install()
    yield
    rep = locks.report()
    locks.uninstall()
    assert rep.clean, rep.render()


def _cfg(**kw):
    base = dict(nxprob=16, nyprob=16, steps=12)
    base.update(kw)
    return HeatConfig(**base)


def _u(n=8):
    return inidat(n, n, device="cpu").numpy()


# --------------------------------------------------------------------- #
# CheckpointManager
# --------------------------------------------------------------------- #

def test_manager_retention_gc(tmp_path):
    reg = MetricsRegistry()
    m = CheckpointManager(tmp_path / "ck", keep=2, registry=reg)
    u = _u()
    for step in (4, 8, 12):
        m.save(u + step, step, _cfg())
    assert m.steps() == [8, 12]
    assert not os.path.exists(m.path_for(4))
    assert not os.path.exists(m.path_for(4) + ".meta.json")
    snap = reg.snapshot()
    assert snap["counters"]["resil_ckpt_saves_total"] == 3
    assert snap["counters"]["resil_ckpt_gc_total"] == 1
    assert snap["gauges"]["resil_ckpt_latest_step"] == 12
    assert snap["gauges"]["resil_ckpt_retained"] == 2


@pytest.mark.parametrize("mmap", [False, True])
def test_manager_latest_valid_skips_torn(tmp_path, mmap):
    reg = MetricsRegistry()
    m = CheckpointManager(tmp_path / "ck", keep=None, registry=reg)
    u = _u()
    for step in (4, 8, 12):
        m.save(torch.from_numpy(u + step), step, _cfg())
    # newest torn (binary corrupted), next-newest missing entirely
    with open(m.path_for(12), "r+b") as f:
        f.write(b"\x00" * 16)
    os.remove(m.path_for(8))
    grid, step, cfg_dict = m.latest_valid(mmap=mmap)
    assert step == 4
    assert isinstance(grid, np.memmap) == mmap
    np.testing.assert_array_equal(grid, u + 4)
    assert cfg_dict["nxprob"] == 16
    snap = reg.snapshot()
    assert snap["counters"]["resil_ckpt_skipped_torn_total"] == 2
    assert snap["counters"]["resil_restore_total"] == 1
    assert snap["gauges"]["resil_restore_step"] == 4


def test_manager_latest_valid_empty(tmp_path):
    m = CheckpointManager(tmp_path / "ck", keep=3)
    assert m.latest_valid() is None
    assert m.latest_step() is None
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path / "bad", keep=-1)


@pytest.mark.parametrize("damage", ["deleted", "garbage"])
def test_manager_survives_lost_manifest(tmp_path, damage):
    """The manifest is an index, not the source of truth: losing it
    degrades to a directory scan over the verified sidecars."""
    m = CheckpointManager(tmp_path / "ck", keep=None)
    for step in (4, 8):
        m.save(_u() + step, step, _cfg())
    if damage == "deleted":
        os.remove(m.manifest_path)
    else:
        with open(m.manifest_path, "w") as f:
            f.write("{not json")
    assert m.steps() == [4, 8]
    assert m.latest_valid()[1] == 8


def test_is_manager_dir(tmp_path):
    assert is_manager_dir(tmp_path)
    assert not is_manager_dir(tmp_path / "ck.bin")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manager_directory_crosses_between_stacks(tmp_path, writer):
    """One layout: a directory either stack's manager writes lists the
    same steps and loads verified, bit for bit, in the other's; the
    manifest documents are identical."""
    u = _u(12)
    d = tmp_path / writer
    if writer == "jax":
        mk = JManager(d, keep=2)
        cfg = JConfig(nxprob=12, nyprob=12, steps=9)
    else:
        mk = CheckpointManager(d, keep=2)
        cfg = _cfg(nxprob=12, nyprob=12, steps=9)
    for step in (3, 6, 9):
        mk.save(u * step, step, cfg)
    readers = [JManager(d, keep=None), CheckpointManager(d, keep=None)]
    for rd in readers:
        assert rd.steps() == [6, 9]
        grid, step, cfg_dict = rd.latest_valid()
        assert step == 9 and grid.tobytes() == (u * 9).tobytes()
        assert cfg_dict["nxprob"] == 12
    manifest = json.loads((d / "MANIFEST.json").read_text())
    assert manifest["format"] == "heat2d-tpu-checkpoint-manifest-v1"
    # tear the newest: both fall back to step 6
    with open(d / "ckpt_00000009.bin", "r+b") as f:
        f.write(b"\xff" * 8)
    for rd in readers:
        grid, step, _ = rd.latest_valid()
        assert step == 6 and grid.tobytes() == (u * 6).tobytes()


# --------------------------------------------------------------------- #
# AsyncCheckpointer
# --------------------------------------------------------------------- #

def test_async_writer_overlaps_write_with_caller(tmp_path):
    """With an injected 0.3 s write latency, save_async returns well
    before the write completes (the I/O rides the worker thread); flush
    then makes it durable."""
    chaos.install(ChaosConfig(ckpt_latency_s=0.3))
    m = CheckpointManager(tmp_path / "ck", keep=None)
    u = _u(16)
    w = AsyncCheckpointer(m, _cfg(), shape=(16, 16))
    t0 = time.monotonic()
    w.save_async(torch.from_numpy(u), 4)
    returned_in = time.monotonic() - t0
    assert returned_in < 0.25, returned_in
    assert m.latest_valid() is None      # not yet committed
    w.flush()
    grid, step, _ = m.latest_valid()
    assert step == 4
    np.testing.assert_array_equal(grid, u)
    w.close()
    assert w.timings[0]["step"] == 4 and w.timings[0]["write_s"] >= 0.3


def test_async_writer_double_buffer_backpressure(tmp_path):
    """At most ONE write in flight: the second save_async waits out the
    first (slow) write instead of queueing snapshots."""
    chaos.install(ChaosConfig(ckpt_latency_s=0.2))
    m = CheckpointManager(tmp_path / "ck", keep=None)
    u = _u(16)
    with AsyncCheckpointer(m, _cfg(), shape=(16, 16)) as w:
        t0 = time.monotonic()
        w.save_async(u, 4)
        w.save_async(u * 2, 8)
        assert time.monotonic() - t0 >= 0.2   # waited for ckpt 4
    assert m.steps() == [4, 8]
    grid, step, _ = m.latest_valid()
    assert step == 8
    np.testing.assert_array_equal(grid, u * 2)


def test_async_writer_snapshot_owns_its_data(tmp_path):
    """The snapshot is taken before save_async returns: a tensor
    overwritten in place right after (a runner's reused buffer) does not
    reach the checkpoint."""
    chaos.install(ChaosConfig(ckpt_latency_s=0.1))
    m = CheckpointManager(tmp_path / "ck", keep=None)
    t = torch.from_numpy(_u(16).copy())
    want = t.numpy().tobytes()
    with AsyncCheckpointer(m, _cfg(), shape=(16, 16)) as w:
        w.save_async(t, 4)
        t.fill_(-1.0)
    assert m.latest_valid()[0].tobytes() == want


@pytest.mark.parametrize("target", ["file", "sharded"])
def test_async_writer_plain_path_and_sharded_targets(tmp_path, target):
    """A plain path target is replaced by each save; a one-process
    ShardedGrid (two row strips, the second padded) is written block by
    block, cropped to the domain."""
    from heat2d_tpu_torch.interop import sharded_from_numpy
    from heat2d_tpu_torch.parallel.mesh import host_devices, make_mesh
    u = np.arange(15 * 13, dtype=np.float32).reshape(15, 13)
    cfg = _cfg(nxprob=15, nyprob=13, mode="dist1d", numworkers=2)
    if target == "sharded":
        mesh = make_mesh(2, 1, host_devices(2, "cpu"))
        states = [sharded_from_numpy(u, cfg, mesh),
                  sharded_from_numpy(u * 3, cfg, mesh)]
    else:
        states = [u, torch.from_numpy(u * 3)]
    p = tmp_path / "ck.bin"
    with AsyncCheckpointer(str(p), cfg, shape=(15, 13)) as w:
        w.save_async(states[0], 4)
        w.save_async(states[1], 8)
    grid, step, _ = tbin.load_checkpoint(p)
    assert step == 8 and grid.tobytes() == (u * 3).tobytes()


def test_async_writer_concurrent_saves_stress(tmp_path):
    """More saving threads than cores, with a short switch interval: every
    save is counted once, every step is committed, and the newest
    snapshot is the one its step names (no lost update, no torn pair)."""
    import threading
    m = CheckpointManager(tmp_path / "ck", keep=None)
    base = _u(16)
    n_threads, per = 2 * (os.cpu_count() or 2), 3
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with AsyncCheckpointer(m, _cfg(), shape=(16, 16)) as w:
            def saver(t):
                for j in range(per):
                    step = 1 + t * per + j
                    w.save_async(base + step, step)
            threads = [threading.Thread(target=saver, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    total = n_threads * per
    assert w.saves == total and len(w.timings) == total
    assert m.steps() == list(range(1, total + 1))
    for step in (1, total):
        grid, got, _ = tbin.load_checkpoint(m.path_for(step))
        assert got == step and grid.tobytes() == (base + step).tobytes()


def test_async_writer_failed_write_never_commits(tmp_path):
    """A failed background block write ABANDONS its pending commit: a
    later flush/close must not promote the partial staging file into a
    'verified' checkpoint."""
    from concurrent.futures import Future

    from heat2d_tpu_torch.resil.writer import _PendingCommit

    m = CheckpointManager(tmp_path / "ck", keep=None)
    w = AsyncCheckpointer(m, _cfg(), shape=(16, 16))
    path = m.path_for(4)
    tmp = tbin.checkpoint_tmp_path(path)
    with open(tmp, "wb") as f:
        f.write(b"\x00" * 64)               # partial staging data
    fut = Future()
    fut.set_exception(OSError("disk full"))
    with w._lock:
        w._future = fut
        w._pending = _PendingCommit(step=4, tmp=tmp, path=path,
                                    config=_cfg(), out_shape=(16, 16))
    with pytest.raises(OSError):
        w.flush()
    w.close()                               # must not commit either
    assert m.latest_valid() is None
    assert not os.path.exists(path)
    with pytest.raises(RuntimeError, match="closed"):
        w.save_async(_u(16), 8)


def test_writer_lock_declarations_equal_jax():
    from heat2d_tpu.analysis import locks as jlocks
    from heat2d_tpu.resil.writer import AsyncCheckpointer as JWriter
    assert locks.GUARDS[AsyncCheckpointer] == jlocks._GUARDS[JWriter]


# --------------------------------------------------------------------- #
# chaos: the checkpoint kill points and the environment
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("env", [
    {},
    {"HEAT2D_CHAOS_FAIL_LAUNCHES": "", "HEAT2D_CHAOS_KILL_CKPT_AT": ""},
    {"HEAT2D_CHAOS_KILL_CKPT_PHASE": "pre_meta"},   # a phase arms nothing
    {"HEAT2D_CHAOS_KILL_CKPT_AT": "0", "HEAT2D_CHAOS_FAIL_LAUNCHES": "0",
     "HEAT2D_CHAOS_LAUNCH_LATENCY_S": "0",
     "HEAT2D_CHAOS_CKPT_LATENCY_S": "0"},
], ids=["unset", "empty", "phase_alone", "zero"])
def test_chaos_env_off(env):
    """Unset, empty and 0 mean off in both packages."""
    assert ChaosConfig.from_env(env) is None
    assert jchaos.ChaosConfig.from_env(env) is None
    assert ChaosConfig(kill_ckpt_at=0).kill_ckpt_at is None


@pytest.mark.parametrize("env,match", [
    ({"HEAT2D_CHAOS_FAIL_LAUNCHES": "lots"}, "FAIL_LAUNCHES"),
    ({"HEAT2D_CHAOS_CKPT_LATENCY_S": "fast"}, "CKPT_LATENCY_S"),
    ({"HEAT2D_CHAOS_KILL_CKPT_AT": "x"}, "KILL_CKPT_AT"),
    ({"HEAT2D_CHAOS_KILL_CKPT_AT": "1",
      "HEAT2D_CHAOS_KILL_CKPT_PHASE": "bogus"}, "kill_ckpt_phase"),
])
def test_chaos_env_garbage_raises_not_noops(env, match):
    """A typo'd variable refuses loudly in both packages: a campaign that
    silently does nothing lets the test it drives pass for nothing."""
    with pytest.raises(ValueError, match=match):
        ChaosConfig.from_env(env)
    with pytest.raises(ValueError, match=match):
        jchaos.ChaosConfig.from_env(env)


def test_chaos_env_arms_the_kill_point():
    env = {"HEAT2D_CHAOS_KILL_CKPT_AT": "3",
           "HEAT2D_CHAOS_KILL_CKPT_PHASE": "pre_meta",
           "HEAT2D_CHAOS_CKPT_LATENCY_S": "0.5"}
    got = ChaosConfig.from_env(env)
    want = jchaos.ChaosConfig.from_env(env)
    for f in ("kill_ckpt_at", "kill_ckpt_phase", "ckpt_latency_s"):
        assert getattr(got, f) == getattr(want, f)
    assert chaos.CKPT_PHASES == jchaos.CKPT_PHASES


def test_checkpoint_point_counts_and_sleeps_in_process():
    """The hook counts mid_write ordinals (the kill ordinal) and sleeps
    the latency there; with no campaign it is a no-op."""
    reg = MetricsRegistry()
    chaos.install(ChaosConfig(ckpt_latency_s=0.05), registry=reg)
    t0 = time.monotonic()
    chaos.checkpoint_point("mid_write")
    chaos.checkpoint_point("pre_meta")
    assert time.monotonic() - t0 >= 0.05
    assert chaos.controller().ckpt_count == 1
    assert reg.snapshot()["counters"][
        "resil_chaos_injected_total{point=ckpt_latency}"] == 1
    chaos.uninstall()
    chaos.install(None)
    chaos.checkpoint_point("mid_write")     # disarmed: nothing happens


def test_kill_flushes_the_flight_recorder_first(monkeypatch):
    """At the armed ordinal and phase the flight recorder is flushed,
    then the process exits 137; a broken recorder does not stop the
    kill."""
    from heat2d_tpu_torch.obs import flight
    calls = []

    def fake_exit(code):
        calls.append(("exit", code))
        raise SystemExit(code)

    def broken_flush(reason):
        calls.append(("flush", reason))
        raise RuntimeError("recorder broken")

    monkeypatch.setattr(os, "_exit", fake_exit)
    monkeypatch.setattr(flight, "crash_flush", broken_flush)
    chaos.install(ChaosConfig(kill_ckpt_at=2, kill_ckpt_phase="pre_meta"))
    chaos.checkpoint_point("mid_write")
    chaos.checkpoint_point("pre_meta")      # ordinal 1: not due
    chaos.checkpoint_point("mid_write")
    with pytest.raises(SystemExit):
        chaos.checkpoint_point("pre_meta")
    assert calls == [("flush", "chaos_kill_ckpt"), ("exit", 137)]


# --------------------------------------------------------------------- #
# the CLI: kill, resume, fallback; segmentation
# --------------------------------------------------------------------- #

GRID = ["--nxprob", "16", "--nyprob", "16", "--steps", "12"]
F64 = ["--accum-dtype", "float64", "--dat-layout", "none"]


def _port_cli(outdir, extra):
    assert tcli.main(["--device", "cpu"] + GRID + F64
                     + ["--outdir", str(outdir)] + extra) == 0


def _killed_port_cli(outdir, extra, env_extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HEAT2D_CHAOS_")}
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-m", "heat2d_tpu_torch.cli", "--device", "cpu"]
        + GRID + F64 + ["--outdir", str(outdir)] + extra,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 137, (r.returncode, r.stdout, r.stderr)
    assert "Exiting after" not in r.stdout
    return r


@pytest.fixture(scope="module")
def jax_final(tmp_path_factory):
    """The JAX CLI's uninterrupted 16x16 x 12 run in float64."""
    assert jax.default_backend() == "cpu" and jax.config.jax_enable_x64
    d = tmp_path_factory.mktemp("jax")
    assert jcli.main(GRID + F64 + ["--binary-dumps", "--outdir",
                                   str(d)]) == 0
    return (d / "final_binary.dat").read_bytes()


@pytest.mark.parametrize("phase,kill_at,durable,left", [
    ("mid_write", 2, [4], "ckpt_00000008.bin.tmp"),
    ("pre_meta", 3, [4, 8], "ckpt_00000012.bin"),
])
def test_kill_mid_checkpoint_then_resume_bitwise(tmp_path, jax_final,
                                                 phase, kill_at, durable,
                                                 left):
    """A run killed at a checkpoint's commit (a hard os._exit, no
    cleanup) leaves a manifest of the earlier steps only; --resume DIR
    finishes bitwise equal to an uninterrupted run and to the JAX CLI's
    bytes. At pre_meta the newest binary exists beside no sidecar: a
    torn pair the digest check skips."""
    ck = tmp_path / "ck"
    flight_dir = tmp_path / "flight"
    _killed_port_cli(tmp_path / "killed",
                     ["--checkpoint", str(ck) + os.sep,
                      "--checkpoint-every", "4"],
                     {"HEAT2D_CHAOS_KILL_CKPT_AT": str(kill_at),
                      "HEAT2D_CHAOS_KILL_CKPT_PHASE": phase,
                      "HEAT2D_FLIGHT_DIR": str(flight_dir)})
    m = CheckpointManager(ck, keep=None)
    assert m.steps() == durable
    assert (ck / left).exists()
    assert os.listdir(flight_dir), "no flight-recorder dump before the kill"
    ref, out = tmp_path / "ref", tmp_path / "out"
    _port_cli(ref, ["--binary-dumps"])
    rec = tmp_path / "rec.json"
    _port_cli(out, ["--resume", str(ck), "--binary-dumps",
                    "--run-record", str(rec)])
    final = (out / "final_binary.dat").read_bytes()
    assert final == (ref / "final_binary.dat").read_bytes() == jax_final
    r = json.loads(rec.read_text())
    assert r["resume_from_step"] == durable[-1]
    assert r["total_steps_including_resume"] == 12


def test_resume_directory_falls_back_past_torn(tmp_path, jax_final,
                                               capsys):
    """--resume DIR with the newest snapshot torn resumes from the one
    before and still ends on the full run's bytes; a torn single file
    names the directory fallback; a directory of torn entries only is
    refused with the JAX CLI's text."""
    ck = tmp_path / "ck"
    rec = tmp_path / "seed.json"
    _port_cli(tmp_path / "seed", ["--checkpoint", str(ck) + os.sep,
                                  "--checkpoint-every", "4",
                                  "--checkpoint-keep", "0",
                                  "--run-record", str(rec)])
    assert json.loads(rec.read_text())["checkpoints_written"] == 3
    m = CheckpointManager(ck, keep=None)
    assert m.steps() == [4, 8, 12]
    with open(m.path_for(12), "r+b") as f:    # tear the newest
        f.write(b"\xff" * 32)
    capsys.readouterr()
    _port_cli(tmp_path / "out", ["--resume", str(ck), "--binary-dumps"])
    assert "Resuming from step 8" in capsys.readouterr().out
    assert (tmp_path / "out" / "final_binary.dat").read_bytes() == jax_final
    assert tcli.main(["--device", "cpu"] + GRID + F64 + [
        "--outdir", str(tmp_path / "o2"), "--resume", m.path_for(12)]) == 1
    assert "pass a checkpoint DIRECTORY" in capsys.readouterr().err
    for step in (4, 8):
        with open(m.path_for(step), "r+b") as f:
            f.write(b"\xff" * 32)
    assert tcli.main(["--device", "cpu"] + GRID + F64 + [
        "--outdir", str(tmp_path / "o3"), "--resume", str(ck)]) == 1
    assert "no valid checkpoint in" in capsys.readouterr().err


SEGMENTED = {
    "serial": ["--mode", "serial"],
    "pallas": ["--mode", "pallas"],
    "pallas_convergence": ["--mode", "pallas", "--convergence",
                           "--interval", "4", "--sensitivity", "1e-3"],
    "dist2d": ["--mode", "dist2d", "--gridx", "2", "--gridy", "2",
               "--host-device-count", "4"],
    "hybrid_convergence": ["--mode", "hybrid", "--gridx", "2", "--gridy",
                           "2", "--host-device-count", "4", "--convergence",
                           "--interval", "4", "--sensitivity", "1e-3"],
}


@pytest.mark.parametrize("case", sorted(SEGMENTED))
def test_checkpoint_every_is_bitwise_the_unsegmented_run(tmp_path, case):
    """K-step segments through the CLI's segment driver end on the
    unsegmented run's bytes with its steps_done, route and residual
    reads; the newest snapshot is the final grid."""
    base = ["--device", "cpu", "--nxprob", "18", "--nyprob", "14",
            "--steps", "40", "--dat-layout", "none", "--binary-dumps"]
    base += SEGMENTED[case]
    recs = {}
    for name, extra in (("whole", []),
                        ("seg", ["--checkpoint", str(tmp_path / "ck") + "/",
                                 "--checkpoint-every", "8"])):
        rec = tmp_path / f"{name}.json"
        assert tcli.main(base + ["--outdir", str(tmp_path / name),
                                 "--run-record", str(rec)] + extra) == 0
        recs[name] = json.loads(rec.read_text())
    final = (tmp_path / "whole" / "final_binary.dat").read_bytes()
    assert (tmp_path / "seg" / "final_binary.dat").read_bytes() == final
    for key in ("steps_done", "route", "residual_reads"):
        assert recs["seg"][key] == recs["whole"][key], key
    assert recs["seg"]["checkpoints_written"] == -(
        -recs["whole"]["steps_done"] // 8)
    grid, step, _ = CheckpointManager(tmp_path / "ck").latest_valid()
    assert step == recs["whole"]["steps_done"]
    assert grid.tobytes() == final


@pytest.mark.parametrize("argv,message", [
    (["--convergence", "--interval", "5", "--checkpoint", "CK/",
      "--checkpoint-every", "8"], "must be a multiple of --interval"),
    (["--checkpoint-every", "4"], "--checkpoint-every requires "
                                  "--checkpoint"),
    (["--checkpoint", "CK/", "--checkpoint-every", "-2"],
     "--checkpoint-every must be >= 1"),
    (["--ensemble-cx", "0.1", "--ensemble-cy", "0.1",
      "--checkpoint-every", "4"], "--checkpoint-every"),
])
def test_checkpoint_every_refusals_match_jax(tmp_path, capsys, argv,
                                             message):
    """What the JAX CLI refuses, the port refuses with its words."""
    argv = [a.replace("CK", str(tmp_path / "ck")) for a in argv]
    common = ["--nxprob", "16", "--nyprob", "16", "--steps", "16",
              "--dat-layout", "none"]
    assert tcli.main(["--device", "cpu", "--outdir", str(tmp_path / "t")]
                     + common + argv) == 1
    assert message in capsys.readouterr().err
    assert jcli.main(["--outdir", str(tmp_path / "j")] + common + argv) == 1
    assert message in capsys.readouterr().err
