"""The port's mesh serving (``heat2d_tpu_torch/mesh``) against
``heat2d_tpu/mesh`` on the CPU: 8 slots of the CPU
(``host_devices(8, "cpu")``) against the JAX package's 8 virtual CPU
devices, the same requests on both.

Held equal across the stacks: capacities, routing decisions, halo plans,
reasons, admission verdicts, error texts and payload keys. Grids are
compared within ``n * 2**-21 * max|u|`` after n steps (XLA's CPU backend
contracts multiply-adds; the port rounds every operation), and
``steps_done`` equal. Within the port the mesh engine equals the
single-device engine bit for bit on every route and occupancy rung.
"""

import numpy as np
import pytest
import torch

import jax

from heat2d_tpu.mesh import MeshAdmission as JAdmission
from heat2d_tpu.mesh import MeshEnsembleEngine as JMeshEngine
from heat2d_tpu.mesh import MeshScheduler as JScheduler
from heat2d_tpu.mesh import runner as jrunner
from heat2d_tpu.models import ensemble as jens
from heat2d_tpu.serve.engine import EnsembleEngine as JEngine
from heat2d_tpu.serve.schema import SolveRequest as JRequest
from heat2d_tpu_torch.mesh import (MeshAdmission, MeshEnsembleEngine,
                                   MeshScheduler)
from heat2d_tpu_torch.mesh.runner import mesh_batch_runner, mesh_capacity
from heat2d_tpu_torch.models import ensemble
from heat2d_tpu_torch.obs.metrics import MetricsRegistry
from heat2d_tpu_torch.parallel.mesh import host_devices
from heat2d_tpu_torch.serve.engine import EnsembleEngine
from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest

ND = 8
SLOTS = tuple(host_devices(ND, "cpu"))
NX, NY, STEPS = 16, 20, 6

assert len(jax.devices()) == ND


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def req(cx=0.1, cy=0.1, cls=SolveRequest, **kw):
    kw.setdefault("nx", NX)
    kw.setdefault("ny", NY)
    kw.setdefault("steps", STEPS)
    kw.setdefault("method", "jnp")
    return cls(cx=cx, cy=cy, **kw)


def reqs(n, cls=SolveRequest, **kw):
    return [req(cx=0.1 + 0.01 * i, cls=cls, **kw) for i in range(n)]


def grids(pairs):
    return [np.asarray(u).tobytes() for u, _ in pairs]


def assert_close(got, want, steps):
    """Port pairs against JAX pairs: grids within the FMA bound, equal
    steps_done."""
    assert len(got) == len(want)
    for (tu, tk), (ju, jk) in zip(got, want):
        ju = np.asarray(ju)
        tol = max(1, steps) * 2.0 ** -21 * float(np.abs(ju).max())
        assert float(np.abs(np.asarray(tu, np.float64) - ju).max()) <= tol
        assert int(tk) == int(jk)


def engine(**kw):
    return MeshEnsembleEngine(devices=SLOTS, **kw)


def single():
    return EnsembleEngine(max_batch=8, device="cpu")


# --------------------------------------------------------------------- #
# capacity rule
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("nd", [1, 3, 4, 7, 8])
def test_mesh_capacity_equals_jax(nd):
    for max_batch in (1, 8, 10, 32, 64):
        for n in range(1, 40):
            assert mesh_capacity(n, max_batch, nd) == \
                jrunner.mesh_capacity(n, max_batch, nd)
    with pytest.raises(ValueError):
        mesh_capacity(1, 8, 0)


def test_mesh_capacity_ladder_is_log_bounded():
    caps = {mesh_capacity(n, 64, 8) for n in range(1, 65)}
    assert caps == {8, 16, 32, 64}


# --------------------------------------------------------------------- #
# the mesh runner
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("method", ["jnp", "pallas", "band"])
def test_mesh_runner_bitwise_parity_every_rung(method):
    """The mesh runner's cropped results equal the single-device
    batch_runner's bit for bit at every occupancy (different pad
    capacities on the two sides); the jnp route also within the bound of
    the JAX mesh runner's."""
    one = ensemble.batch_runner(NX, NY, STEPS, method, device="cpu")
    meshed = mesh_batch_runner(NX, NY, STEPS, method, devices=SLOTS)
    jmeshed = jrunner.mesh_batch_runner(NX, NY, STEPS, "jnp",
                                        n_devices=ND)
    assert meshed.method == method and meshed.n_devices == ND
    for n in (1, 2, 3, 5, 8):
        cxs = [0.1 + 0.01 * i for i in range(n)]
        cap_s = mesh_capacity(n, 8, 1)
        cap_m = mesh_capacity(n, 8 * ND, ND)
        pad_s = torch.tensor(cxs + [cxs[-1]] * (cap_s - n))
        pad_m = torch.tensor(cxs + [cxs[-1]] * (cap_m - n))
        a = one(torch.ones(cap_s, NX, NY), pad_s, pad_s)[:n]
        b = meshed(torch.ones(cap_m, NX, NY), pad_m, pad_m)[:n]
        assert torch.equal(a, b)
        if method == "jnp":
            j = np.asarray(jmeshed(np.ones((cap_m, NX, NY), np.float32),
                                   pad_m.numpy(), pad_m.numpy()))[:n]
            assert_close([(x, 0) for x in b.numpy()],
                         [(x, 0) for x in j], STEPS)


def test_mesh_runner_rejects_unshardable_batch():
    meshed = mesh_batch_runner(NX, NY, STEPS, "jnp", devices=SLOTS)
    bad = ND + 1
    with pytest.raises(ValueError, match="multiple"):
        meshed(torch.zeros(bad, NX, NY), torch.zeros(bad),
               torch.zeros(bad))


@pytest.mark.parametrize("problem", ["heat9", "advdiff", "reactdiff"])
def test_mesh_runner_families_equal_single(problem):
    """The other families per slot (H8/H9's plain versions on the CPU),
    bitwise the single-device runner, and the route JAX picks."""
    from heat2d_tpu.problems import runners as jprunners
    one = ensemble.batch_runner(NX, NY, STEPS, "auto", problem=problem,
                                device="cpu")
    meshed = mesh_batch_runner(NX, NY, STEPS, "auto", problem=problem,
                               devices=SLOTS[:4])
    cs = torch.linspace(0.05, 0.12, 4)
    u0 = torch.rand(4, NX, NY, generator=torch.Generator().manual_seed(3))
    assert torch.equal(one(u0, cs, cs), meshed(u0, cs, cs))
    assert meshed.method == jprunners.pick_route(problem, "auto", NX, NY)


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #

def test_engine_parity_every_rung_fixed_and_convergence():
    """MeshEnsembleEngine == EnsembleEngine bit for bit on every rung,
    fixed-step and convergence (steps_done included), and within the
    bound of the JAX mesh engine's answers."""
    meshed = engine()
    jmeshed = JMeshEngine(n_devices=ND)
    for n in (1, 2, 3, 5, 8):
        got = meshed.solve_batch(reqs(n))
        assert grids(got) == grids(single().solve_batch(reqs(n)))
        assert_close(got, jmeshed.solve_batch(reqs(n, cls=JRequest)),
                     STEPS)
    conv = dict(convergence=True, interval=5, sensitivity=1e3, steps=40)
    for n in (1, 4):
        a = meshed.solve_batch(reqs(n, **conv))
        b = single().solve_batch(reqs(n, **conv))
        assert grids(a) == grids(b)
        assert [s for _, s in a] == [s for _, s in b]
        assert_close(a, jmeshed.solve_batch(reqs(n, cls=JRequest, **conv)),
                     40)


def test_engine_routes_batch_on_mesh():
    meshed = engine()
    meshed.solve_batch(reqs(3))
    row = meshed.launch_log[-1]
    assert row["mesh"]["route"] == "batch"
    assert row["mesh"]["n_devices"] == ND
    assert row["capacity"] % ND == 0
    assert {"setup_s", "run_s", "readback_s"} <= set(row)
    j = JMeshEngine(n_devices=ND)
    j.solve_batch(reqs(3, cls=JRequest))
    assert j.launch_log[-1]["capacity"] == row["capacity"]


def test_engine_max_batch_per_chip_scales_with_mesh():
    e = engine(max_batch_per_chip=2)
    assert e.max_batch == 2 * ND
    e2 = engine(max_batch=3 * ND, max_batch_per_chip=2)
    assert e2.max_batch == 3 * ND
    assert engine(max_batch=10).max_batch == \
        JMeshEngine(n_devices=ND, max_batch=10).max_batch


def test_engine_needs_a_card_by_default():
    """Without ``devices=`` the mesh spans the visible cards; a build box
    has none, and the engine refuses to start rather than run on the
    CPU."""
    from heat2d_tpu_torch.utils.device import DeviceUnavailableError
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        MeshEnsembleEngine()


# --------------------------------------------------------------------- #
# the scheduler's split
# --------------------------------------------------------------------- #

def _decision_equal(t, j):
    keys = ("route", "reason", "n_devices", "member_bytes",
            "spatial_bytes_threshold", "demand", "tuned_mcells_per_s",
            "spatial_grid", "plan", "links")
    for k in keys:
        assert t.get(k) == j.get(k), k


@pytest.mark.parametrize("shape", [(NX, NY), (48, 64), (15, 18),
                                   (64, 64)])
@pytest.mark.parametrize("threshold", [1, 10 ** 9])
def test_scheduler_decisions_equal_jax(shape, threshold):
    reg = MetricsRegistry()
    s = MeshScheduler(registry=reg, spatial_bytes_threshold=threshold,
                      devices=SLOTS)
    j = JScheduler(n_devices=ND, spatial_bytes_threshold=threshold)
    nx, ny = shape
    d = s.decide(req(nx=nx, ny=ny))
    _decision_equal(d, j.decide(req(nx=nx, ny=ny, cls=JRequest)))
    assert s.decide(req(nx=nx, ny=ny, cx=0.9)) is d      # memoized
    assert reg.find_counters("mesh_route_total")


def test_scheduler_families_and_kinds_equal_jax():
    s = MeshScheduler(spatial_bytes_threshold=1, devices=SLOTS)
    j = JScheduler(n_devices=ND, spatial_bytes_threshold=1)
    for fam in ("heat9", "advdiff", "reactdiff"):
        _decision_equal(s.decide(req(problem=fam)),
                        j.decide(req(problem=fam, cls=JRequest)))

    class FakeInverse:
        nx, ny, steps = NX, NY, STEPS
        request_kind = "inverse"
        dtype = "float32"

        def signature(self):
            return ("inverse", NX, NY)
    assert s.decide(FakeInverse())["reason"] == "request_kind"
    assert MeshScheduler(devices=SLOTS[:1]).decide(req())["reason"] \
        == "one_device"


def test_scheduler_default_threshold_is_the_cards_on_chip_total():
    """The split threshold defaults to the card's shared memory across
    its SMs (the H100's figures answer for a CPU slot): a 640x1024
    member fits, a 4096^2 one does not."""
    from heat2d_tpu_torch.ops import _build
    s = MeshScheduler(devices=SLOTS[:4])
    assert s.spatial_bytes_threshold == \
        _build.H100_SM_COUNT * _build.smem_limit("cpu")
    assert s.decide(req(nx=640, ny=1024))["route"] == "batch"
    assert s.decide(req(nx=4096, ny=4096))["route"] == "spatial"


def test_scheduler_refuses_a_world():
    """world= takes a dist.runtime.DistWorld (the multi-process world,
    ported since slice 7) and refuses anything else."""
    from heat2d_tpu_torch.config import ConfigError
    from heat2d_tpu_torch.dist.runtime import DistWorld
    with pytest.raises(ConfigError, match="DistWorld"):
        MeshScheduler(devices=SLOTS, world=object())
    world = DistWorld(0, 2, device_process=(0, 0, 1, 1))
    assert MeshScheduler(devices=SLOTS, world=world).world is world


def test_unplannable_routes_single_chip_with_counter():
    """A shape the (2, 4) decomposition cannot take is served on one
    device (bitwise its answer) with mesh_fallback_total{unplannable};
    the plan carries JAX's error text."""
    reg = MetricsRegistry()
    sched = MeshScheduler(registry=reg, spatial_bytes_threshold=1,
                          devices=SLOTS)
    meshed = engine(scheduler=sched, registry=reg)
    rs = reqs(2, nx=15, ny=18)
    assert sched.decide(rs[0])["reason"] == "unplannable"
    assert grids(meshed.solve_batch(rs)) == grids(single().solve_batch(rs))
    fallbacks = reg.find_counters("mesh_fallback_total")
    assert {dict(k)["reason"]: v for k, v in fallbacks.items()} \
        == {"unplannable": 1}
    assert meshed.launch_log[-1]["mesh"]["route"] == "single"
    plan = meshed.halo_plans[rs[0].signature()]
    jplan = jens.spatial_halo_plan(15, 18, 2, 4, halo="fused")
    assert plan["tier"] == "unplannable"
    assert plan["error"] == jplan["error"]


# --------------------------------------------------------------------- #
# spatial route
# --------------------------------------------------------------------- #

def test_spatial_route_compiles_plan_and_matches_single_chip():
    reg = MetricsRegistry()
    sched = MeshScheduler(registry=reg, spatial_bytes_threshold=1,
                          devices=SLOTS)
    meshed = engine(scheduler=sched, registry=reg)
    rs = reqs(3, nx=48, ny=64)
    sig = rs[0].signature()
    meshed._preresolve_tuned(rs[0])
    assert meshed.halo_plans[sig]["compiled"] is False
    got = meshed.solve_batch(rs)
    assert grids(got) == grids(single().solve_batch(rs))
    plan = meshed.halo_plans[sig]
    assert plan["compiled"] is True
    assert plan["mesh"] == sched.spatial_grid()
    assert meshed.launch_log[-1]["mesh"]["route"] == "spatial"
    assert meshed.launch_log[-1]["halo_plan"]["compiled"] is True
    assert reg.find_counters("mesh_spatial_compiled_total")
    launches = meshed.launches
    meshed.solve_batch(reqs(2, nx=48, ny=64))
    assert meshed.launches == launches + 1
    # against the JAX engine's spatial route on the same requests
    jsched = JScheduler(n_devices=ND, spatial_bytes_threshold=1)
    jmeshed = JMeshEngine(n_devices=ND, scheduler=jsched)
    want = jmeshed.solve_batch(reqs(3, nx=48, ny=64, cls=JRequest))
    assert_close(got, want, STEPS)
    jplan = jmeshed.halo_plans[rs[0].signature()]
    for k in ("route", "tier", "depth", "shard", "mesh", "local_batch",
              "compiled"):
        assert plan[k] == jplan[k], k


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_spatial_runner_fused_equals_collective(grid):
    gx, gy = grid
    rc = ensemble.spatial_batch_runner(32, 32, 8, gx, gy,
                                       halo="collective",
                                       n_devices=gx * gy, devices=SLOTS)
    rf = ensemble.spatial_batch_runner(32, 32, 8, gx, gy, halo="fused",
                                       n_devices=gx * gy, devices=SLOTS)
    assert rf.meta.halo["tier"] == ("overlap" if gx * gy > 1
                                    else "collective")
    u0 = torch.arange(32 * 32, dtype=torch.float32).reshape(
        32, 32).expand(3, 32, 32)
    cx = torch.tensor([0.1, 0.12, 0.14])
    uc, kc = rc(u0, cx, cx)
    uf, kf = rf(u0, cx, cx)
    assert torch.equal(uc, uf) and torch.equal(kc, kf)
    ju, jk = jens.spatial_batch_runner(32, 32, 8, gx, gy, halo="fused",
                                       n_devices=gx * gy)(
        u0.numpy(), cx.numpy(), cx.numpy())
    assert_close(list(zip(uf.numpy(), kf.tolist())),
                 list(zip(np.asarray(ju), np.asarray(jk))), 8)


# --------------------------------------------------------------------- #
# admission control
# --------------------------------------------------------------------- #

def make_admission(cls=MeshAdmission, reg=None, **kw):
    clock = {"t": 0.0}
    kw.setdefault("window_s", 1.0)
    kw.setdefault("headroom", 1.0)
    kw.setdefault("per_chip_mcells_per_s",
                  2 * NX * NY * STEPS / 1e6 / kw["window_s"] / ND
                  / kw["headroom"])
    extra = {"devices": SLOTS} if cls is MeshAdmission else \
        {"n_devices": ND}
    adm = cls(registry=reg, clock=lambda: clock["t"], **extra, **kw)
    return adm, clock


def test_admission_sheds_like_jax():
    """The same clock and request sequence: the same verdicts, codes,
    messages and modeled rates."""
    reg = MetricsRegistry()
    adm, clock = make_admission(reg=reg)
    jadm, jclock = make_admission(JAdmission)
    seq = [(0.0, 0.1), (0.0, 0.2), (0.0, 0.3), (0.5, 0.35), (1.01, 0.4),
           (1.02, 0.45), (1.03, 0.5)]
    for t, cx in seq:
        clock["t"] = jclock["t"] = t
        got, want = adm.admit(req(cx=cx)), jadm.admit(req(cx=cx,
                                                          cls=JRequest))
        assert (got is None) == (want is None)
        if got is not None:
            assert got.code == want.code == "mesh_saturated"
            assert got.message == want.message
            assert got.fields == want.fields
    assert reg.find_counters("mesh_admission_shed_total")


def test_admission_through_the_server():
    """A saturated leader is shed with rejected_mesh_saturated while cache
    hits keep answering."""
    from heat2d_tpu_torch.serve.server import SolveServer

    reg = MetricsRegistry()
    adm, _clock = make_admission()
    server = SolveServer(registry=reg, max_delay=0.02, admission=adm,
                         device="cpu")
    with server:
        a = server.submit(req()).result(60)
        b = server.submit(req(cx=0.2)).result(60)
        assert not a.cache_hit and not b.cache_hit
        with pytest.raises(Rejected, match="mesh_saturated"):
            server.submit(req(cx=0.3)).result(60)
        assert server.submit(req()).result(60).cache_hit
    counts = reg.snapshot()["counters"]
    assert counts["serve_requests_total{outcome=rejected_"
                  "mesh_saturated}"] >= 1


def test_admission_exempts_non_solve_kinds():
    adm, _clock = make_admission()

    class FakeInverse:
        nx, ny, steps = 1_000_000, 1_000_000, 1_000_000
        request_kind = "inverse"
    assert adm.admit(FakeInverse()) is None
    assert adm.admit(req()) is None
    assert adm.admit(req(cx=0.2)) is None


def test_admission_validation():
    with pytest.raises(ValueError):
        MeshAdmission(devices=SLOTS, window_s=0)
    with pytest.raises(ValueError):
        MeshAdmission(devices=SLOTS, headroom=0)


# --------------------------------------------------------------------- #
# bench_serve and the serve CLI
# --------------------------------------------------------------------- #

def test_measure_serve_scaling_payload():
    from heat2d_tpu.mesh.bench import measure_serve_scaling as jmeasure
    from heat2d_tpu_torch.mesh.bench import measure_serve_scaling
    row = measure_serve_scaling(nx=24, ny=24, steps=4, wall=False,
                                devices=SLOTS)
    want = jmeasure(n_devices=ND, nx=24, ny=24, steps=4, wall=False)
    assert set(row) == set(want)
    assert row["parity"] is True and row["rate_source"] == "modeled"
    for k in ("modeled_rps_1chip", "modeled_rps_nchip",
              "modeled_scaling_efficiency", "max_batch_nchip",
              "parity_rungs", "model"):
        assert row[k] == want[k], k


def test_measure_spatial_serve_payload():
    from heat2d_tpu.mesh.bench import measure_spatial_serve as jmeasure
    from heat2d_tpu_torch.mesh.bench import measure_spatial_serve
    row = measure_spatial_serve(nx=24, ny=24, steps=4, devices=SLOTS)
    want = jmeasure(n_devices=ND, nx=24, ny=24, steps=4)
    assert set(row) == set(want)
    assert row["parity"] and row["compiled"] and row["route"] == "spatial"
    assert row["halo_plan"] == want["halo_plan"]


def test_mesh_bench_cli_exits_zero(tmp_path, capsys):
    from heat2d_tpu_torch.mesh import bench
    out = tmp_path / "rec.json"
    assert bench.main(["--device", "cpu", "--host-device-count", "4",
                       "--nx", "24", "--ny", "24", "--steps", "4",
                       "--no-wall", "--out", str(out)]) == 0
    import json
    rec = json.loads(out.read_text())
    assert rec["kind"] == "multichip" and len(rec["scaling"]) == 2
    assert "bench_serve passed" in capsys.readouterr().out


def test_serve_cli_mesh_answers_requests(tmp_path):
    """The slice end to end: ``heat2d-tpu-torch-serve --mesh`` on 4 CPU
    slots answers a request file (batch and spatial signatures, a
    convergence request, a family, a duplicate); every answer equals the
    port's single-device CLI's and is within the bound of the JAX serve
    CLI's ``--mesh`` answers (its 8 virtual devices)."""
    import json

    from heat2d_tpu.serve import cli as jcli
    from heat2d_tpu_torch.serve import cli as tcli

    rng = np.random.default_rng(1612)
    rows = []
    for i in range(6):
        rows.append({"nx": 24, "ny": 32, "steps": 8, "method": "jnp",
                     "cx": float(rng.uniform(0.05, 0.2)),
                     "cy": float(rng.uniform(0.05, 0.2))})
    rows.append({"nx": 24, "ny": 32, "steps": 40, "method": "jnp",
                 "convergence": True, "interval": 10,
                 "sensitivity": 1e3, "cx": 0.1, "cy": 0.2})
    rows.append({"nx": 16, "ny": 16, "steps": 5, "method": "jnp",
                 "problem": "heat9", "cx": 0.1, "cy": 0.1})
    rows.append(dict(rows[0]))
    path = tmp_path / "req.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))

    def serve(mod, extra, name):
        out = tmp_path / name
        assert mod.main(["--requests", str(path), "--results-out",
                         str(out)] + extra) == 0
        return [json.loads(x) for x in out.read_text().splitlines()]

    mesh = serve(tcli, ["--device", "cpu", "--mesh",
                        "--host-device-count", "4"], "mesh.jsonl")
    one = serve(tcli, ["--device", "cpu"], "one.jsonl")
    want = serve(jcli, ["--platform", "cpu", "--mesh"], "jax.jsonl")
    for m, o, w, r in zip(mesh, one, want, rows):
        for k in ("steps_done", "shape", "max_temperature", "total_heat"):
            assert m[k] == o[k], k
        assert m["steps_done"] == w["steps_done"]
        assert m["shape"] == w["shape"]
        tol = r["steps"] * 2.0 ** -21 * abs(w["max_temperature"])
        assert abs(m["max_temperature"] - w["max_temperature"]) <= tol
        assert abs(m["total_heat"] - w["total_heat"]) <= \
            tol * r["nx"] * r["ny"]
