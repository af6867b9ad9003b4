"""The port's I/O against the JAX package's: .dat bytes in both layouts,
checkpoints that load across the stacks, and the CLI's output files."""

import json

import jax
import numpy as np
import pytest
import torch

from heat2d_tpu import cli as jcli
from heat2d_tpu.config import HeatConfig as JConfig
from heat2d_tpu.io import binary as jbin
from heat2d_tpu.io import writers as jw
from heat2d_tpu_torch import cli as tcli
from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.interop import config_from_dict, state_from_numpy
from heat2d_tpu_torch.io import binary as tbin
from heat2d_tpu_torch.io import writers as tw
from heat2d_tpu_torch.models import ensemble as tens


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rng, shape=(13, 7)):
    """Values that exercise %6.1f: wide magnitudes, negative zero, exact
    ties of the decimal rounding."""
    a = rng.standard_normal(shape) * 10.0 ** rng.integers(-2, 6, shape)
    a = a.astype(np.float32)
    a.flat[:4] = [-0.0, 0.05, 0.25, -1234567.0]
    return a


@pytest.mark.parametrize("layout", ["baseline", "rowmajor"])
def test_dat_bytes_equal(rng, layout):
    a = _grid(rng)
    tfmt = getattr(tw, f"format_grid_{layout}")
    jfmt = getattr(jw, f"format_grid_{layout}")
    assert tfmt(a) == jfmt(a)
    assert tfmt(torch.from_numpy(a)) == jfmt(a)


@pytest.mark.parametrize("layout", ["baseline", "rowmajor"])
def test_dat_files_round_trip(tmp_path, rng, layout):
    a = _grid(rng)
    getattr(tw, f"write_grid_{layout}")(a, tmp_path / "t.dat")
    getattr(jw, f"write_grid_{layout}")(a, tmp_path / "j.dat")
    assert (tmp_path / "t.dat").read_bytes() == \
        (tmp_path / "j.dat").read_bytes()
    np.testing.assert_array_equal(
        tw.read_grid_text(tmp_path / "t.dat", layout),
        jw.read_grid_text(tmp_path / "j.dat", layout))


def test_binary_dump_bytes_equal(tmp_path, rng):
    a = _grid(rng)
    tbin.write_binary(torch.from_numpy(a), tmp_path / "t.bin")
    jbin.write_binary(a, tmp_path / "j.bin")
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    np.testing.assert_array_equal(tbin.read_binary(tmp_path / "t.bin",
                                                   a.shape), a)


def test_jax_checkpoint_loads_in_port(tmp_path, rng):
    a = _grid(rng)
    cfg = JConfig(nxprob=13, nyprob=7, steps=60, accum_dtype="float64")
    jbin.save_checkpoint(a, 60, cfg, tmp_path / "ck.bin")
    grid, step, d = tbin.load_checkpoint(tmp_path / "ck.bin")
    np.testing.assert_array_equal(grid, a)
    assert step == 60
    assert config_from_dict(d).to_dict() == cfg.to_dict()


def test_port_checkpoint_loads_in_jax(tmp_path, rng):
    a = _grid(rng)
    cfg = HeatConfig(nxprob=13, nyprob=7, steps=60)
    tbin.save_checkpoint(state_from_numpy(a, "cpu"), 60, cfg,
                         tmp_path / "ck.bin")
    grid, step, d = jbin.load_checkpoint(tmp_path / "ck.bin")
    np.testing.assert_array_equal(grid, a)
    assert step == 60 and JConfig.from_dict(d) == JConfig(**cfg.to_dict())
    meta = json.loads((tmp_path / "ck.bin.meta.json").read_text())
    assert meta["format"] == "heat2d-tpu-checkpoint-v1"


def test_torn_checkpoint_rejected(tmp_path, rng):
    a = _grid(rng)
    tbin.save_checkpoint(a, 3, HeatConfig(), tmp_path / "ck.bin")
    raw = bytearray((tmp_path / "ck.bin").read_bytes())
    raw[0] ^= 0xFF
    (tmp_path / "ck.bin").write_bytes(bytes(raw))
    with pytest.raises(tbin.CheckpointCorruptError):
        tbin.load_checkpoint(tmp_path / "ck.bin")
    with pytest.raises(jbin.CheckpointCorruptError):
        jbin.load_checkpoint(tmp_path / "ck.bin")


def _jax_cli(argv):
    # conftest already runs JAX on the CPU with x64 enabled, which is
    # what --platform cpu --accum-dtype float64 set up in a fresh process
    # (--platform is left out: it would re-initialise the backend here).
    assert jax.default_backend() == "cpu" and jax.config.jax_enable_x64
    return jcli.main(argv)


@pytest.mark.parametrize("layout", ["rowmajor", "baseline"])
def test_cli_dat_files_byte_identical(tmp_path, layout):
    common = ["--accum-dtype", "float64", "--dat-layout", layout,
              "--binary-dumps"]
    assert tcli.main(common + ["--device", "cpu", "--outdir",
                               str(tmp_path / "t")]) == 0
    assert _jax_cli(common + ["--outdir", str(tmp_path / "j")]) == 0
    for name in ("initial.dat", "final.dat", "initial_binary.dat",
                 "final_binary.dat"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_jax_checkpoint_resumes_in_port_cli(tmp_path):
    """60 JAX steps, checkpoint, 40 more in the port CLI: final.dat equals
    an uninterrupted 100-step JAX run's, byte for byte (f64 accumulation,
    10x10)."""
    f64 = ["--accum-dtype", "float64"]
    ck = str(tmp_path / "ck.bin")
    assert _jax_cli(f64 + ["--steps", "60", "--checkpoint", ck,
                           "--outdir", str(tmp_path / "a")]) == 0
    assert tcli.main(f64 + ["--device", "cpu", "--steps", "100",
                            "--resume", ck,
                            "--run-record", str(tmp_path / "rec.json"),
                            "--outdir", str(tmp_path / "b")]) == 0
    assert _jax_cli(f64 + ["--steps", "100",
                           "--outdir", str(tmp_path / "c")]) == 0
    assert (tmp_path / "b" / "final.dat").read_bytes() == \
        (tmp_path / "c" / "final.dat").read_bytes()
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["steps_done"] == 40
    assert rec["total_steps_including_resume"] == 100


def test_cli_prints_the_reference_lines(tmp_path, capsys):
    assert tcli.main(["--device", "cpu", "--mode", "pallas",
                      "--convergence", "--outdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for line in ("Starting with 1 shards", "Problem size:10x10",
                 "Amount of iterations: 100",
                 "Check for convergence every 20 iterations",
                 "Writing initial.dat ...", "Exiting after 100 iterations",
                 "Writing final.dat ..."):
        assert line in out.splitlines()
    assert "Elapsed time: " in out and " sec" in out


def test_cli_device_info_prints_the_summary_and_runs_nothing(tmp_path,
                                                              capsys,
                                                              monkeypatch):
    """``--device-info`` (the JAX CLI's flag, ``print_device_summary``):
    the summary as ``key: value`` lines, the keys the JAX CLI prints for
    the platform, the device kind and the count, exit 0, no kernel
    launched and no file written."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    monkeypatch.chdir(tmp_path)
    cs.reset_launch_counts()
    assert tcli.main(["--device-info", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    got = dict(line.split(": ", 1) for line in lines)
    assert got["platform"] == "cpu" and got["device_kind"] == "cpu"
    assert got["n_devices"] == "1"
    assert set(cs.launch_counts().values()) == {0}
    assert list(tmp_path.iterdir()) == []
    from heat2d_tpu.utils.device import device_summary
    assert {"platform", "device_kind", "n_devices"} <= set(device_summary())


def test_cli_ensemble_refuses_bitwise_parity(tmp_path, capsys):
    """An ensemble run with ``--bitwise-parity`` is refused by the port
    (its ensemble kernels take the FMA form only, so the flag could not be
    honoured) where the JAX CLI runs it: a stated difference of the
    contract, not a silent one."""
    argv = ["--ensemble-cx", "0.1,0.2", "--ensemble-cy", "0.1,0.05",
            "--bitwise-parity", "--mode", "pallas"]
    assert tcli.main(argv + ["--device", "cpu", "--outdir",
                             str(tmp_path / "t")]) == 1
    err = capsys.readouterr().err
    assert "do not support --bitwise-parity" in err
    assert not (tmp_path / "t" / "final_m0.dat").exists()
    assert _jax_cli(argv + ["--outdir", str(tmp_path / "j")]) == 0
    assert (tmp_path / "j" / "final_m0.dat").exists()



@pytest.mark.parametrize("flags,msg", [
    (["--numworkers", "3"], "ensemble runs do not take --numworkers 3"),
    (["--mode", "dist1d", "--numworkers", "3"],
     "ensemble runs do not take --numworkers 3"),
    (["--gridx", "2"], "ensemble spatial decomposition (--gridx 2 "
                       "--gridy 1) is only supported with --mode dist2d"),
    (["--mode", "hybrid", "--gridx", "2", "--gridy", "2"],
     "ensemble spatial decomposition (--gridx 2 --gridy 2) is only "
     "supported with --mode dist2d"),
    (["--mode", "pallas", "--gridy", "2"],
     "ensemble spatial decomposition (--gridx 1 --gridy 2) is only "
     "supported with --mode dist2d")])
def test_cli_ensemble_refuses_numworkers_and_gridx(tmp_path, capsys, flags,
                                                   msg):
    """``--numworkers`` is refused for every ensemble, ``--gridx/--gridy``
    outside ``--mode dist2d``: the JAX CLI's two refusals, with its exit
    code and its messages, on 10x10 grids; nothing is written."""
    argv = ["--ensemble-cx", "0.1,0.05", "--ensemble-cy", "0.1,0.05",
            "--nxprob", "10", "--nyprob", "10", "--steps", "5"] + flags
    assert tcli.main(argv + ["--device", "cpu", "--outdir",
                             str(tmp_path / "t")]) == 1
    terr = capsys.readouterr().err
    assert _jax_cli(argv + ["--outdir", str(tmp_path / "j")]) == 1
    jerr = capsys.readouterr().err
    assert msg in terr
    assert terr.splitlines()[0] == jerr.splitlines()[0]
    assert not (tmp_path / "t").exists()


def _read_members(outdir, n):
    return [tw.read_grid_text(outdir / f"final_m{i}.dat", "rowmajor")
            for i in range(n)]


@pytest.mark.parametrize("flags,banner", [
    (["--mode", "dist1d"], "over 3 devices"),
    (["--mode", "hybrid", "--convergence", "--interval", "5",
      "--sensitivity", "50"], "over 3 devices"),
    (["--mode", "dist2d", "--gridx", "2", "--gridy", "2"],
     "2x2 spatial submesh"),
    (["--mode", "dist2d", "--gridx", "2", "--gridy", "1",
      "--halo", "fused", "--halo-depth", "2"], "2x1 spatial submesh")])
def test_cli_ensemble_sharded_and_spatial_runs(tmp_path, capsys, flags,
                                               banner):
    """The ensemble routes over device slots through the CLI: members
    shard over ``--host-device-count`` slots in dist1d/dist2d/hybrid, and
    ``--mode dist2d --gridx/--gridy`` is the spatial route. The members'
    dumps equal the single-device route's (mode serial, the jnp route)
    and the JAX CLI's to the dump's 0.1 resolution; the record's
    steps_done equal the JAX record's."""
    argv = ["--nxprob", "16", "--nyprob", "12", "--steps", "20",
            "--ensemble-cx", "0.1,0.2,0.05", "--ensemble-cy",
            "0.1,0.1,0.2"]
    slots = ["--host-device-count",
             "4" if "--gridx" in flags else "3"]
    rec = tmp_path / "t.json"
    assert tcli.main(argv + flags + slots + [
        "--device", "cpu", "--outdir", str(tmp_path / "t"),
        "--run-record", str(rec)]) == 0
    assert banner in capsys.readouterr().out
    # The single-device reference: the route the slots run (auto for the
    # sharded modes, the jnp route's golden step for the spatial one),
    # dumped by the same writer.
    cxs, cys = [0.1, 0.2, 0.05], [0.1, 0.1, 0.2]
    method = "jnp" if "--gridx" in flags else "auto"
    if "--convergence" in flags:
        ref, _ = tens.run_ensemble_convergence(16, 12, 20, 5, 50.0, cxs,
                                               cys, device="cpu")
    else:
        ref = tens.run_ensemble(16, 12, 20, cxs, cys, method=method,
                                device="cpu")
    (tmp_path / "s").mkdir()
    for i, m in enumerate(ref.numpy()):
        tw.write_grid_rowmajor(m, tmp_path / "s" / f"final_m{i}.dat")
    jrec = tmp_path / "j.json"
    assert _jax_cli(argv + flags + ["--outdir", str(tmp_path / "j"),
                                    "--run-record", str(jrec)]) == 0
    got = _read_members(tmp_path / "t", 3)
    for a, b in zip(got, _read_members(tmp_path / "s", 3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, _read_members(tmp_path / "j", 3)):
        assert np.abs(a - b).max() <= 0.1 + 1e-3
    t, j = json.loads(rec.read_text()), json.loads(jrec.read_text())
    assert t["summary"].get("steps_done") == j["summary"].get("steps_done")
    assert t["summary"]["members"] == 3
