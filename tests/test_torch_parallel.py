"""The port's multi-device modes on the CPU against the JAX package, under
conftest's 8 virtual JAX CPU devices; the port's meshes put every shard
on the CPU (``host_devices(n, "cpu")``).

Tolerances. The golden dist paths in float64 accumulation are bitwise
equal across the stacks (the cross-stack anchor); in float32, and for
hybrid's kernel forms, within ``n * 2**-21 * max|ref|`` after n steps
(XLA's CPU backend contracts multiply-adds, torch eager does not).
Within the port: dist1d, dist2d and hybrid ``bitwise_parity`` are
bitwise equal to serial, and ``--halo fused`` to the collective route.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from heat2d_tpu import cli as jcli
from heat2d_tpu.config import HeatConfig as JConfig
from heat2d_tpu.models.solver import Heat2DSolver as JSolver
from heat2d_tpu.parallel import halo as jhalo
from heat2d_tpu.parallel import mesh as jmesh
from heat2d_tpu.parallel import sharded as jsharded
from heat2d_tpu_torch import cli as tcli
from heat2d_tpu_torch.config import ConfigError, HeatConfig
from heat2d_tpu_torch.interop import sharded_from_numpy
from heat2d_tpu_torch.io.binary import write_binary, write_binary_sharded
from heat2d_tpu_torch.models.solver import Heat2DSolver
from heat2d_tpu_torch.parallel import halo, mesh, sharded
from heat2d_tpu_torch.parallel.multihost import gather_to_host


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(n=8):
    return mesh.host_devices(n, "cpu")


def _tol(n, ref):
    return max(1, n) * 2.0 ** -21 * float(np.abs(ref).max())


def _both(**kw):
    got = Heat2DSolver(HeatConfig(**kw), device="cpu",
                       devices=_cpu()).run(timed=False)
    want = JSolver(JConfig(**kw)).run(timed=False)
    return got, want


def _serial(**kw):
    kw = dict(kw, mode="serial", halo="collective", bitwise_parity=False)
    return Heat2DSolver(HeatConfig(**kw), device="cpu").run(timed=False)


# ------------------------------------------------------------------ #
# mesh and halo
# ------------------------------------------------------------------ #

def test_make_mesh_counts_devices_like_jax():
    with pytest.raises(ValueError) as port:
        mesh.make_mesh(2, 3, _cpu(4))
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(2, 3, jax.devices()[:4])
    assert str(port.value) == str(ref.value)
    m = mesh.make_mesh(2, 2, _cpu(5))
    assert m.shape == (2, 2) and len(m.flat()) == 4
    assert m.distinct() == [torch.device("cpu")]


@pytest.mark.parametrize("gx,gy", [(1, 1), (2, 3), (4, 2)])
def test_neighbor_table_matches_jax(gx, gy):
    assert mesh.neighbor_table(gx, gy) == jmesh.neighbor_table(gx, gy)


def test_host_devices_and_summary():
    assert mesh.host_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        mesh.host_devices(0, "cpu")
    info = mesh.mesh_devices_summary(mesh.make_mesh(2, 2, _cpu(4)))
    assert info["mesh_shape"] == {"x": 2, "y": 2}
    assert info["n_shards"] == 4 and info["n_devices"] == 1
    assert info["platform"] == "cpu"


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("gx,gy", [(4, 1), (1, 4), (2, 2), (2, 4)])
def test_exchange_halo_strips_vs_jax(gx, gy, t, rng):
    """Every shard's four strips equal the JAX exchange's in shard_map,
    bit for bit (the exchange only copies)."""
    bm, bn = 5, 6
    g = rng.random((gx * bm, gy * bn), dtype=np.float32)
    jm = jmesh.make_mesh(gx, gy)
    fn = jax.jit(jmesh.shard_map_compat(
        lambda u: jhalo.exchange_halo_strips(u, "x", "y", gx, gy, t), jm,
        in_specs=P("x", "y"), out_specs=(P("x", "y"),) * 4,
        check_vma=False))
    want = [np.asarray(a) for a in fn(g)]
    blocks = [[torch.from_numpy(g[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]
                                .copy()) for j in range(gy)]
              for i in range(gx)]
    got = halo.exchange_halo_strips(blocks, t)
    for i in range(gx):
        for j in range(gy):
            for k, s in enumerate(got[i][j]):
                h, w = s.shape
                np.testing.assert_array_equal(
                    s.numpy(), want[k][i * h:(i + 1) * h, j * w:(j + 1) * w])


def test_wide_exchange_and_shifts(rng):
    xs = [[torch.full((2, 2), float(i))] for i in range(3)]   # 3x1 mesh
    strips = halo.exchange_halo_strips(xs, 1)
    # north from the lower neighbour, south from the upper; zeros at the
    # mesh's edges
    assert [float(s[0][0, 0]) for (s,) in strips] == [0, 0, 1]
    assert [float(s[1][0, 0]) for (s,) in strips] == [1, 2, 0]
    blocks = [[torch.ones(4, 5), torch.ones(4, 5)]]
    ext = halo.exchange_halo_2d_wide(blocks, 2)
    assert tuple(ext[0][0].shape) == (8, 9)
    assert float(ext[0][0][:2].abs().sum()) == 0.0      # no north neighbour
    assert float(ext[0][0][2:6, -2:].min()) == 1.0      # the east shard
    assert halo.fused_halo_viable(6, 8, 3)
    assert not halo.fused_halo_viable(5, 8, 3)


# ------------------------------------------------------------------ #
# the sharded engine's pieces
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("kw,grid", [
    (dict(mode="dist1d", numworkers=3), (3, 1)),
    (dict(mode="dist2d", gridx=2, gridy=2, nxprob=12, nyprob=16), (2, 2)),
    (dict(mode="dist1d", numworkers=7, nxprob=10, nyprob=9), (7, 1)),
])
def test_sharded_inidat_vs_jax(kw, grid):
    cfg = HeatConfig(**kw)
    jcfg = JConfig(**kw)
    m = mesh.make_mesh(*grid, _cpu())
    got = gather_to_host(sharded.sharded_inidat(cfg, m))
    want = np.asarray(jsharded.sharded_inidat(
        jcfg, jmesh.make_mesh(*grid)))
    np.testing.assert_array_equal(got, want)
    assert sharded.padded_global_shape(cfg, m) == want.shape


@pytest.mark.parametrize("kw", [
    dict(mode="dist2d", gridx=2, gridy=2),
    dict(mode="dist2d", gridx=2, gridy=2, halo="fused"),
    dict(mode="dist2d", gridx=2, gridy=2, halo="fused", halo_depth=20),
    dict(mode="dist1d", numworkers=8, halo="fused"),
    dict(mode="dist2d", gridx=1, gridy=1, halo="fused"),
])
def test_resolve_halo_route_vs_jax(kw):
    cfg, jcfg = HeatConfig(nxprob=32, nyprob=48, **kw), JConfig(
        nxprob=32, nyprob=48, **kw)
    grid = (kw.get("numworkers") or kw["gridx"], kw.get("gridy", 1))
    got = sharded.resolve_halo_route(cfg, mesh.make_mesh(*grid, _cpu()))
    want = jsharded.resolve_halo_route(jcfg, jmesh.make_mesh(*grid))
    assert got == want


def test_hybrid_route_tiers():
    m = mesh.make_mesh(2, 2, _cpu(4))
    cfg = HeatConfig(nxprob=32, nyprob=48, mode="hybrid", gridx=2, gridy=2)
    assert sharded.resolve_halo_route(cfg, m, kernel=True)["tier"] == \
        "collective"
    fused = cfg.replace(halo="fused")
    r = sharded.resolve_halo_route(fused, m, kernel=True)
    assert (r["route"], r["tier"], r["depth"]) == ("fused", "ici", 8)
    one = mesh.make_mesh(1, 1, _cpu(1))
    assert sharded.resolve_halo_route(
        fused.replace(gridx=1, gridy=1), one, kernel=True)["tier"] == \
        "collective"


@pytest.mark.parametrize("depth,want", [(None, 8), (3, 3), (100, 16)])
def test_effective_halo_depth_clamps(depth, want):
    cfg = HeatConfig(nxprob=64, nyprob=64, mode="dist2d", gridx=4,
                     gridy=2, halo_depth=depth)
    m = mesh.make_mesh(4, 2, _cpu())
    assert sharded.effective_halo_depth(cfg, m) == want == \
        jsharded.effective_halo_depth(JConfig(**cfg.to_dict()),
                                      jmesh.make_mesh(4, 2))


# ------------------------------------------------------------------ #
# the solver
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("gx,gy", [(4, 1), (1, 4), (2, 2), (4, 2), (2, 4)])
def test_dist2d_bitwise_vs_jax(gx, gy):
    """float64 accumulation: the golden paths agree bit for bit."""
    got, want = _both(nxprob=32, nyprob=40, steps=23, mode="dist2d",
                      gridx=gx, gridy=gy, accum_dtype="float64")
    np.testing.assert_array_equal(got.u, want.u)
    assert got.steps_done == 23 and got.route == "sharded"
    assert got.halo["mesh"] == (gx, gy)


@pytest.mark.parametrize("gx,gy", [(2, 2), (4, 2)])
def test_dist2d_float32_vs_jax_and_serial(gx, gy):
    kw = dict(nxprob=32, nyprob=40, steps=23, mode="dist2d", gridx=gx,
              gridy=gy)
    got, want = _both(**kw)
    assert np.abs(got.u - want.u).max() <= _tol(23, want.u)
    np.testing.assert_array_equal(got.u, _serial(**kw).u)


@pytest.mark.parametrize("nw", [3, 6, 7])
def test_dist1d_reference_grid_bitwise_vs_jax(nw):
    """The reference's 10x10 over 3, 6 and 7 row strips (6 and 7 pad)."""
    got, want = _both(mode="dist1d", numworkers=nw, accum_dtype="float64")
    np.testing.assert_array_equal(got.u, want.u)
    assert got.u.shape == (10, 10)
    np.testing.assert_array_equal(
        Heat2DSolver(HeatConfig(mode="dist1d", numworkers=nw),
                     device="cpu", devices=_cpu()).run(timed=False).u,
        _serial().u)


@pytest.mark.parametrize("depth", [1, 2, 3, 5, 100])
def test_halo_depths_bitwise_vs_jax(depth):
    got, want = _both(nxprob=24, nyprob=20, steps=17, mode="dist2d",
                      gridx=2, gridy=2, halo_depth=depth,
                      accum_dtype="float64")
    np.testing.assert_array_equal(got.u, want.u)
    assert got.halo["depth"] == min(depth, 10)


def test_dist2d_convergence_vs_jax():
    kw = dict(nxprob=32, nyprob=40, steps=100000, mode="dist2d", gridx=2,
              gridy=2, convergence=True, interval=20, sensitivity=0.5,
              accum_dtype="float64")
    got, want = _both(**kw)
    assert got.steps_done == want.steps_done < 100000
    np.testing.assert_array_equal(got.u, want.u)
    assert got.residual_reads == got.steps_done // 20


@pytest.mark.parametrize("halo_route", ["collective", "fused"])
@pytest.mark.parametrize("parity", [False, True])
def test_hybrid_vs_jax(halo_route, parity):
    """Hybrid at 32x256 on 2x2 (H12, or H14 with --halo fused, by their
    plain versions) against JAX hybrid; parity runs bitwise to serial."""
    kw = dict(nxprob=32, nyprob=256, steps=21, mode="hybrid", gridx=2,
              gridy=2, halo=halo_route, bitwise_parity=parity)
    got, want = _both(**kw)
    assert got.steps_done == want.steps_done == 21
    assert np.abs(got.u - want.u).max() <= _tol(21, want.u)
    assert got.route == "sharded-kernel"
    assert got.halo["tier"] == ("ici" if halo_route == "fused"
                                else "collective")
    if parity:
        np.testing.assert_array_equal(got.u, _serial(**kw).u)


@pytest.mark.parametrize("parity", [False, True])
def test_hybrid_fused_bitwise_vs_collective(parity):
    kw = dict(nxprob=40, nyprob=36, steps=19, mode="hybrid", gridx=2,
              gridy=2, bitwise_parity=parity)
    cfg = HeatConfig(**kw)
    a = Heat2DSolver(cfg, device="cpu", devices=_cpu()).run(timed=False)
    b = Heat2DSolver(cfg.replace(halo="fused"), device="cpu",
                     devices=_cpu()).run(timed=False)
    np.testing.assert_array_equal(a.u, b.u)


def test_dist2d_fused_overlap_bitwise_vs_jax():
    got, want = _both(nxprob=32, nyprob=40, steps=21, mode="dist2d",
                      gridx=2, gridy=2, halo="fused", accum_dtype="float64")
    assert got.halo["tier"] == "overlap"
    np.testing.assert_array_equal(got.u, want.u)


def test_hybrid_convergence_vs_jax_and_serial():
    """The H13 route (fused residual, FMA form) exits where JAX hybrid
    and the port's serial mode do."""
    kw = dict(nxprob=32, nyprob=128, steps=100000, convergence=True,
              interval=20, sensitivity=0.5)
    got, want = _both(mode="hybrid", gridx=2, gridy=2, **kw)
    assert got.route == "sharded-kernel-resid"
    assert got.steps_done == want.steps_done == _serial(**kw).steps_done
    np.testing.assert_allclose(got.u, want.u, rtol=1e-3, atol=1e-3)
    assert got.residual_reads == got.steps_done // 20


def test_uneven_dist1d_pads_hold_zero():
    cfg = HeatConfig(nxprob=4099 // 64, nyprob=16, steps=30, mode="dist1d",
                     numworkers=4, halo_depth=3)
    s = Heat2DSolver(cfg, device="cpu", devices=_cpu(4))
    r = s.run(timed=False, gather=False)
    full = gather_to_host(r.u)
    assert full.shape == (64, 16)
    np.testing.assert_array_equal(full[cfg.nxprob:], 0.0)
    np.testing.assert_array_equal(full[:cfg.nxprob],
                                  _serial(**cfg.to_dict()).u)


def test_place_pads_like_jax(rng):
    cfg = HeatConfig(nxprob=10, nyprob=9, mode="dist1d", numworkers=4)
    u = rng.random((10, 9), dtype=np.float32)
    g = Heat2DSolver(cfg, device="cpu", devices=_cpu(4)).place(u)
    want = JSolver(JConfig(**cfg.to_dict())).place(u)
    np.testing.assert_array_equal(gather_to_host(g), np.asarray(want))
    assert g.block_shape == (3, 9)


def test_record_carries_the_halo_block():
    r = Heat2DSolver(HeatConfig(mode="hybrid", gridx=2, gridy=2,
                                halo="fused", halo_depth=3, nxprob=16,
                                nyprob=16, steps=3), device="cpu",
                     devices=_cpu(4)).run()
    rec = r.to_record()
    assert rec["halo"] == {"requested": "fused", "depth": 3,
                           "shard": [8, 8], "mesh": [2, 2],
                           "route": "fused", "tier": "ici",
                           "devices": ["cpu"] * 4}
    assert rec["mesh"]["mesh_shape"] == {"x": 2, "y": 2}
    json.dumps(rec)


def test_solver_refuses_a_mesh_without_devices():
    with pytest.raises(ValueError, match="at least 4"):
        Heat2DSolver(HeatConfig(mode="dist2d", gridx=2, gridy=2),
                     device="cpu")


def test_write_binary_sharded_equals_write_binary(tmp_path, rng):
    cfg = HeatConfig(nxprob=11, nyprob=13, mode="dist2d", gridx=1,
                     gridy=1).replace(mode="dist1d", numworkers=4)
    u = rng.random((11, 13), dtype=np.float32)
    g = sharded_from_numpy(u, cfg, mesh.make_mesh(4, 1, _cpu(4)))
    write_binary_sharded(g, tmp_path / "a.bin")
    write_binary(u, tmp_path / "b.bin")
    assert (tmp_path / "a.bin").read_bytes() == \
        (tmp_path / "b.bin").read_bytes()


# ------------------------------------------------------------------ #
# config and CLI
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("kw", [
    dict(mode="dist2d", nxprob=10, gridx=3),
    dict(mode="hybrid", nyprob=10, gridy=4),
    dict(mode="dist1d", numworkers=9, strict_baseline=True),
    dict(mode="dist1d", gridx=2, strict_baseline=True),
    dict(mode="dist2d", halo_depth=0),
    dict(mode="hybrid", halo="ici"),
    dict(mode="dist2d", method="adi", cx=8.0, cy=8.0),
])
def test_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ConfigError) as port:
        HeatConfig(**kw)
    with pytest.raises(Exception) as ref:
        JConfig(**kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    dict(mode="dist1d", numworkers=5, strict_baseline=True),
    dict(mode="dist1d", numworkers=11, nxprob=10),
    dict(mode="hybrid", gridx=5, gridy=2, halo="fused", halo_depth=2),
])
def test_config_accepts_what_jax_accepts(kw):
    assert HeatConfig(**kw).to_dict() == JConfig(**kw).to_dict()


def test_cli_dist2d_dat_and_binary_bytes_equal_jax(tmp_path):
    common = ["--mode", "dist2d", "--gridx", "2", "--gridy", "2",
              "--nxprob", "14", "--nyprob", "18", "--steps", "37",
              "--accum-dtype", "float64", "--host-device-count", "4",
              "--binary-dumps"]
    assert tcli.main(common + ["--device", "cpu", "--outdir",
                               str(tmp_path / "t"), "--run-record",
                               str(tmp_path / "rec.json")]) == 0
    assert jax.default_backend() == "cpu"
    assert jcli.main(common + ["--outdir", str(tmp_path / "j")]) == 0
    for name in ("initial.dat", "final.dat", "initial_binary.dat",
                 "final_binary.dat"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    final = np.fromfile(tmp_path / "t" / "final_binary.dat", np.float32)
    write_binary(final.reshape(14, 18), tmp_path / "w.bin")
    assert (tmp_path / "w.bin").read_bytes() == \
        (tmp_path / "t" / "final_binary.dat").read_bytes()
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["halo"]["mesh"] == [2, 2] and rec["halo"]["shard"] == [7, 9]


def test_cli_uneven_dist1d_binary_and_banner(tmp_path, capsys):
    assert tcli.main(["--mode", "dist1d", "--numworkers", "3", "--device",
                      "cpu", "--host-device-count", "3", "--binary-dumps",
                      "--debug", "--outdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Starting with 3 shards" in out
    assert "shard 1 at (1,0): N=0 S=2 W=-1 E=-1" in out
    final = np.fromfile(tmp_path / "final_binary.dat", np.float32)
    np.testing.assert_array_equal(final.reshape(10, 10), _serial().u)


def test_cli_hybrid_banner_and_refusals(tmp_path, capsys):
    assert tcli.main(["--mode", "hybrid", "--gridx", "2", "--gridy", "2",
                      "--device", "cpu", "--host-device-count", "4",
                      "--halo", "fused", "--outdir", str(tmp_path)]) == 0
    assert "Each shard will take: 5x5" in capsys.readouterr().out
    assert tcli.main(["--mode", "hybrid", "--gridx", "2", "--gridy", "2",
                      "--device", "cpu", "--outdir", str(tmp_path)]) == 1
    assert "at least 4" in capsys.readouterr().err
    # ensembles run over the mesh's slots now (one CPU slot here), and
    # refuse --gridx/--gridy outside dist2d as the JAX CLI does
    assert tcli.main(["--mode", "dist2d", "--ensemble-cx", "0.1",
                      "--ensemble-cy", "0.1", "--device", "cpu",
                      "--outdir", str(tmp_path / "e")]) == 0
    assert "over 1 devices" in capsys.readouterr().out
    assert tcli.main(["--mode", "hybrid", "--gridx", "2", "--gridy", "2",
                      "--ensemble-cx", "0.1", "--ensemble-cy", "0.1",
                      "--device", "cpu", "--host-device-count", "4",
                      "--outdir", str(tmp_path / "f")]) == 1
    assert "only supported with --mode dist2d" in capsys.readouterr().err


# --------------------------------------------------------------------- #
# per-member coefficients, and strong scaling (parallel/scaling.py)
# --------------------------------------------------------------------- #

def test_local_chunk_per_member_cxy_and_kernel_refusal():
    """``cxy=`` (per-member (B, 1, 1) coefficients on (B, bm, bn) blocks)
    advances each member as a scalar-coefficient run of its own (cx, cy)
    does, bit for bit, in both halo routes; with the kernel it raises the
    JAX package's error."""
    ShardedGrid = sharded.ShardedGrid
    grid_mesh = mesh.make_mesh(2, 2, _cpu(4))
    rng = np.random.default_rng(3)
    u = rng.random((3, 12, 16), dtype=np.float32) * 100
    cxs = torch.tensor([0.05, 0.1, 0.2]).reshape(-1, 1, 1)
    cys = torch.tensor([0.15, 0.1, 0.05]).reshape(-1, 1, 1)
    for route in ("collective", "fused"):
        cfg = HeatConfig(nxprob=12, nyprob=16, steps=5, mode="dist2d",
                         gridx=2, gridy=2, halo=route, halo_depth=3)
        blocks = [[torch.from_numpy(u[:, i * 6:(i + 1) * 6,
                                      j * 8:(j + 1) * 8].copy())
                   for j in range(2)] for i in range(2)]
        multi = sharded.make_local_multi(cfg, grid_mesh, cxy=(cxs, cys))
        step = sharded.make_local_step(cfg, grid_mesh, cxy=(cxs, cys))
        got = step(multi(ShardedGrid(blocks, 12, 16), 5))
        for m in range(3):
            one = cfg.replace(cx=float(cxs[m]), cy=float(cys[m]))
            grid = ShardedGrid([[b[m] for b in row] for row in blocks],
                               12, 16)
            ref = sharded.make_local_chunk(one, grid_mesh)(
                sharded.make_local_multi(one, grid_mesh)(grid, 5), 1)
            for a, b in zip(got.tensors(), ref.tensors()):
                assert torch.equal(a[m], b)
    with pytest.raises(ValueError) as t:
        sharded.make_local_chunk(cfg, grid_mesh, kernel=True, cxy=(cxs, cys))
    with pytest.raises(ValueError) as j:
        jsharded.make_local_chunk(JConfig(nxprob=12, nyprob=16, mode="hybrid",
                                     gridx=2, gridy=2),
                             jmesh.make_mesh(2, 2), chunk_kernel=object(),
                             cxy=(0.1, 0.1))
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 9, 12])
def test_square_mesh_equals_jax(n):
    from heat2d_tpu.parallel.scaling import square_mesh as jsq
    from heat2d_tpu_torch.parallel.scaling import square_mesh
    assert square_mesh(n) == jsq(n)


@pytest.mark.parametrize("mode,halo", [("dist2d", "collective"),
                                       ("dist2d", "fused"),
                                       ("hybrid", "collective"),
                                       ("hybrid", "fused")])
def test_strong_scaling_payload_equals_jax(mode, halo):
    """The ``kind="multichip"`` payload: JAX's keys, mesh, depth and
    (where the routes agree) route and tier; hybrid fused resolves
    against the kernel route (H14's tier ``ici`` in the port, where the
    JAX package's CPU build degrades to collective: a stated difference,
    ROADMAP.md section C)."""
    from heat2d_tpu.parallel.scaling import measure_strong_scaling as jm
    from heat2d_tpu_torch.parallel.scaling import (measure_strong_scaling,
                                                   scaling_record)
    got = measure_strong_scaling(4, 32, 32, 16, halo=halo, mode=mode,
                                 devices=_cpu(4))
    want = jm(4, 32, 32, 16, halo=halo, mode=mode)
    assert set(got) == set(want)
    for k in ("n_devices", "mesh", "grid", "steps", "mode", "halo",
              "halo_depth"):
        assert got[k] == want[k], k
    if (mode, halo) == ("hybrid", "fused"):
        assert (got["halo_route"], got["halo_tier"]) == ("fused", "ici")
    else:
        assert (got["halo_route"], got["halo_tier"]) == \
            (want["halo_route"], want["halo_tier"])
    assert got["mcells_per_s_1chip"] > 0 and got["mcells_per_s_nchip"] > 0
    assert got["strong_scaling_efficiency"] == pytest.approx(
        got["mcells_per_s_nchip"] / (4 * got["mcells_per_s_1chip"]))
    rec = scaling_record([got], device="cpu")
    assert rec["kind"] == "multichip" and rec["scaling"] == [got]


def test_strong_scaling_needs_the_slots():
    from heat2d_tpu_torch.parallel.scaling import measure_strong_scaling
    with pytest.raises(ValueError, match="needs 4 devices; have 2"):
        measure_strong_scaling(4, devices=_cpu(2))
