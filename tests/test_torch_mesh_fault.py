"""The port's mesh fault tier against ``heat2d_tpu``'s on the CPU: ABFT
checksum recurrences (``ops/abft.py``) against the JAX package's, the
device chaos campaigns' strict env contract, the quarantine book and the
stall watchdog (``mesh/health.py``), shrink-and-requeue with bitwise
recovery (``mesh/degrade.py`` and the guarded engine), the
no-quarantined-serving invariant, and the chaos gate.

Slots are 8 CPU slots (``host_devices(8, "cpu")``). Predictions are
compared with the JAX package's within the ABFT tolerance
(``abft.tolerance``); recovered results must equal the single-device
engine's bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heat2d_tpu.ops import abft as jabft
from heat2d_tpu.resil import chaos as jchaos
from heat2d_tpu_torch.mesh import (FaultPolicy, HealthMonitor,
                                   MeshEnsembleEngine, MeshStallError,
                                   mesh_batch_runner, mesh_capacity)
from heat2d_tpu_torch.mesh import degrade, health
from heat2d_tpu_torch.obs.metrics import MetricsRegistry
from heat2d_tpu_torch.ops import abft
from heat2d_tpu_torch.ops.init import inidat
from heat2d_tpu_torch.ops.stencil import stencil_step
from heat2d_tpu_torch.parallel.mesh import host_devices
from heat2d_tpu_torch.resil import chaos
from heat2d_tpu_torch.resil.retry import wait_for
from heat2d_tpu_torch.serve.engine import EnsembleEngine
from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest

ND = 8
SLOTS = tuple(host_devices(ND, "cpu"))
NX, NY, STEPS = 16, 20, 6


@pytest.fixture(autouse=True)
def _no_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def req(cx=0.1, cy=0.1, **kw):
    kw.setdefault("nx", NX)
    kw.setdefault("ny", NY)
    kw.setdefault("steps", STEPS)
    kw.setdefault("method", "jnp")
    return SolveRequest(cx=cx, cy=cy, **kw)


def reqs(n, base=0.1, **kw):
    return [req(cx=base + 0.01 * i, **kw) for i in range(n)]


def grids(pairs):
    return [np.asarray(u).tobytes() for u, _ in pairs]


def counters(reg):
    return reg.snapshot()["counters"]


def engine(slots=SLOTS, **kw):
    return MeshEnsembleEngine(devices=slots, **kw)


def oracle(rs):
    return grids(EnsembleEngine(max_batch=8, device="cpu").solve_batch(rs))


# --------------------------------------------------------------------- #
# ABFT: the checksum recurrence, against the JAX package's
# --------------------------------------------------------------------- #

def _run_explicit(u0, cx, cy, steps):
    u = torch.from_numpy(u0.copy())
    for _ in range(steps):
        u = stencil_step(u, cx, cy)
    return u.numpy()


def _scale(u0):
    w = abft.mode_weights(*u0.shape)
    return float(np.einsum("ij,ij->", np.abs(u0), w)) + abs(
        float(abft.host_checksum(u0)))


@pytest.mark.parametrize("edges", ["noisy", "zero"])
def test_explicit_recurrence_equals_jax(edges):
    """Host algebra: the port's prediction, flux and weights equal the
    JAX package's exactly (both float64 numpy), and the port's f32 run is
    classified healthy against it."""
    rng = np.random.default_rng(7)
    u0 = (rng.uniform(0.0, 2.0, (NX, NY)).astype(np.float32)
          if edges == "noisy" else inidat(NX, NY).numpy())
    cx, cy, T = 0.22, 0.15, 40
    w = abft.mode_weights(NX, NY)
    np.testing.assert_array_equal(w, jabft.mode_weights(NX, NY))
    assert abft.host_predict(u0, cx, cy, T, method="jnp") == \
        jabft.host_predict(u0, cx, cy, T, method="jnp")
    beta = float(abft.boundary_flux(np.asarray(u0, np.float64), w, cx, cy))
    assert beta == float(jabft.boundary_flux(np.asarray(u0, np.float64),
                                             w, cx, cy))
    assert (beta != 0.0) == (edges == "noisy")
    uT = _run_explicit(u0, cx, cy, T)
    s_pred = abft.host_predict(u0, cx, cy, T, method="jnp")
    assert not abft.classify(abft.host_checksum(uT), s_pred, _scale(u0), T)
    if edges == "noisy":    # the flux term is load-bearing
        alpha = abft.step_factor("explicit", NX, NY, cx, cy)
        no_flux = (alpha ** T) * float(abft.host_checksum(u0))
        assert abft.classify(abft.host_checksum(uT), no_flux, _scale(u0),
                             T)


def test_adi_recurrence_zero_edges():
    from heat2d_tpu_torch.ops.tridiag import adi_multi_step
    u0 = inidat(NX, NY).numpy()
    T, cx, cy = 30, 0.4, 0.3
    uT = adi_multi_step(torch.from_numpy(u0), T, cx, cy).numpy()
    s_pred = abft.host_predict(u0, cx, cy, T, method="adi")
    assert s_pred == jabft.host_predict(u0, cx, cy, T, method="adi")
    assert not abft.classify(abft.host_checksum(uT), s_pred, _scale(u0), T)


def test_flip_detected_healthy_passes():
    u0 = inidat(NX, NY).numpy()
    T = 25
    uT = _run_explicit(u0, 0.2, 0.18, T)
    s_pred = abft.host_predict(u0, 0.2, 0.18, T, method="jnp")
    assert not abft.classify(abft.host_checksum(uT), s_pred, _scale(u0), T)
    bad = uT.copy()
    bad.view(np.uint32)[NX // 2, NY // 2] ^= np.uint32(1 << 30)
    assert abft.classify(abft.host_checksum(bad), s_pred, _scale(u0), T)
    assert (abft.classify(abft.host_checksum(bad), s_pred, _scale(u0), T)
            == jabft.classify(jabft.host_checksum(bad), s_pred,
                              _scale(u0), T))


def test_power_negative_base_equals_jax():
    alphas = [-0.5, 0.5, -1.0, 0.0, 1.0, 0.97]
    ks = [3, 4, 5, 2, 0, 240]
    got = abft._power(torch.tensor(alphas), torch.tensor(ks,
                                                         dtype=torch.int32))
    want = np.asarray(jax.jit(jabft._power)(
        jnp.asarray(alphas, jnp.float32), jnp.asarray(ks, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert float(abft._power(torch.tensor(0.0),
                             torch.tensor(0, dtype=torch.int32))) == 1.0


def test_supported_family_vocabulary():
    for m in ("jnp", "pallas", "band", "adi", "mg", "auto"):
        assert abft.supported_family(m) == jabft.supported_family(m)
    with pytest.raises(ValueError):
        abft.host_predict(np.zeros((4, 4)), 0.1, 0.1, 2, method="mg")


@pytest.mark.parametrize("family", ["explicit", "adi"])
def test_predict_batch_matches_jax_and_host_oracle(family):
    """The on-device prediction (f32 torch) against the JAX package's
    traced one and the float64 host oracle, within the ABFT tolerance;
    the observation likewise."""
    rng = np.random.default_rng(5)
    B = 3
    u0 = np.stack([inidat(NX, NY).numpy()] * B)
    if family == "explicit":
        u0[:, 0, :] = rng.uniform(0, 3, (B, NY))      # a flux term
    cxs = np.asarray([0.1, 0.2, 0.24], np.float32)
    cys = np.asarray([0.12, 0.15, 0.2], np.float32)
    k = np.asarray([STEPS, 0, 17], np.int32)
    w = np.asarray(abft.mode_weights(NX, NY), np.float32)
    sp, sc = abft.predict_batch(torch.from_numpy(u0), torch.from_numpy(cxs),
                                torch.from_numpy(cys), torch.from_numpy(k),
                                torch.from_numpy(w), family=family)
    jsp, jsc = jax.jit(lambda a, b, c, d: jabft.predict_batch(
        a, b, c, d, jnp.asarray(w), family=family))(u0, cxs, cys, k)
    obs = abft.observe_batch(torch.from_numpy(u0), torch.from_numpy(w))
    jobs = np.asarray(jabft.observe_batch(jnp.asarray(u0), jnp.asarray(w)))
    method = "jnp" if family == "explicit" else "adi"
    for i in range(B):
        tol = float(abft.tolerance(float(sc[i]), k[i]))
        assert abs(float(sp[i]) - float(jsp[i])) <= tol
        assert abs(float(sc[i]) - float(jsc[i])) <= tol
        assert abs(float(obs[i]) - float(jobs[i])) <= tol
        if family == "explicit" or not u0[i, 0].any():
            want = abft.host_predict(u0[i], float(cxs[i]), float(cys[i]),
                                     int(k[i]), method=method)
            assert abs(float(sp[i]) - want) <= tol


# --------------------------------------------------------------------- #
# chaos: the strict env contract of the three device campaigns
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("var", [
    "HEAT2D_CHAOS_DEVICE_FAIL_AT", "HEAT2D_CHAOS_DEVICE_FAIL_INDEX",
    "HEAT2D_CHAOS_HANG_COLLECTIVE", "HEAT2D_CHAOS_FLIP_BIT",
    "HEAT2D_CHAOS_HANG_COLLECTIVE_S"])
def test_chaos_env_garbage_raises_naming_the_var(var):
    env = {"HEAT2D_CHAOS_HANG_COLLECTIVE": "1", var: "lots"}
    with pytest.raises(ValueError, match=var):
        chaos.ChaosConfig.from_env(env)
    with pytest.raises(ValueError, match=var):
        jchaos.ChaosConfig.from_env(env)


def test_chaos_env_unset_empty_zero_are_off():
    env = {"HEAT2D_CHAOS_DEVICE_FAIL_AT": "",
           "HEAT2D_CHAOS_HANG_COLLECTIVE": "0",
           "HEAT2D_CHAOS_FLIP_BIT": "0"}
    assert chaos.ChaosConfig.from_env({}) is None
    assert chaos.ChaosConfig.from_env(env) is None
    assert jchaos.ChaosConfig.from_env(env) is None
    assert not chaos.ChaosConfig(device_fail_at=0, hang_collective=0,
                                 flip_bit=0).any_active()


def test_chaos_env_armed_parses_like_jax():
    env = {"HEAT2D_CHAOS_DEVICE_FAIL_AT": "2",
           "HEAT2D_CHAOS_DEVICE_FAIL_INDEX": "3",
           "HEAT2D_CHAOS_HANG_COLLECTIVE": "4",
           "HEAT2D_CHAOS_HANG_COLLECTIVE_S": "0.5",
           "HEAT2D_CHAOS_FLIP_BIT": "1"}
    cfg = chaos.ChaosConfig.from_env(env)
    jcfg = jchaos.ChaosConfig.from_env(env)
    for f in ("device_fail_at", "device_fail_index", "hang_collective",
              "hang_collective_s", "flip_bit"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_device_fail_fires_at_ordinal_and_kills_probes():
    chaos.install(chaos.ChaosConfig(device_fail_at=2, device_fail_index=1))
    chaos.mesh_launch_point()
    assert chaos.device_probe_point(1)
    with pytest.raises(chaos.DeviceLostError) as ei:
        chaos.mesh_launch_point()
    assert ei.value.device_index == 1
    assert isinstance(ei.value, chaos.ChaosError)
    assert not chaos.device_probe_point(1)
    assert chaos.device_probe_point(0)
    chaos.mesh_launch_point()


def test_hang_collective_blocks_and_marks_dead():
    chaos.install(chaos.ChaosConfig(hang_collective=1,
                                    hang_collective_s=0.2,
                                    device_fail_index=2))
    t0 = time.monotonic()
    chaos.mesh_launch_point()
    assert time.monotonic() - t0 >= 0.2
    assert not chaos.device_probe_point(2)


def test_flip_bit_point_only_at_armed_ordinal():
    chaos.install(chaos.ChaosConfig(flip_bit=2))
    chaos.mesh_launch_point()
    assert chaos.flip_bit_point() is None
    chaos.mesh_launch_point()
    assert chaos.flip_bit_point() == 30
    chaos.mesh_launch_point()
    assert chaos.flip_bit_point() is None


def test_chaos_idle_hooks_are_noops():
    assert chaos.flip_bit_point() is None
    assert chaos.device_probe_point(0)
    chaos.mesh_launch_point()


# --------------------------------------------------------------------- #
# the ABFT runner
# --------------------------------------------------------------------- #

def test_abft_runner_is_its_own_and_bitwise_equal_plain():
    plain = mesh_batch_runner(NX, NY, STEPS, "jnp", devices=SLOTS)
    armed = mesh_batch_runner(NX, NY, STEPS, "jnp", abft=True,
                              devices=SLOTS)
    assert plain is not armed and armed.abft
    u0 = inidat(NX, NY).expand(ND, NX, NY)
    cs = torch.linspace(0.1, 0.2, ND)
    u_armed, k, s_obs, s_pred, scale = armed(u0, cs, cs)
    assert torch.equal(u_armed, plain(u0, cs, cs))
    assert k.tolist() == [STEPS] * ND
    assert not np.any(abft.classify(s_obs.numpy(), s_pred.numpy(),
                                    scale.numpy(), STEPS))


def test_abft_runner_refuses_families_and_mg():
    with pytest.raises(ValueError, match="no ABFT recurrence"):
        mesh_batch_runner(NX, NY, STEPS, "auto", abft=True,
                          problem="heat9", devices=SLOTS)
    with pytest.raises(ValueError, match="no ABFT recurrence"):
        mesh_batch_runner(NX, NY, STEPS, "mg", abft=True, devices=SLOTS)


def test_mesh_runner_device_subset():
    sub = (0, 2, 5)
    run = mesh_batch_runner(NX, NY, STEPS, "jnp", device_indices=sub,
                            devices=SLOTS)
    assert run.n_devices == 3
    cs = torch.linspace(0.1, 0.2, 3)
    full = mesh_batch_runner(NX, NY, STEPS, "jnp", devices=SLOTS)(
        inidat(NX, NY).expand(ND, NX, NY),
        torch.cat([cs, cs[-1:].expand(ND - 3)]),
        torch.cat([cs, cs[-1:].expand(ND - 3)]))
    got = run(inidat(NX, NY).expand(3, NX, NY), cs, cs)
    assert torch.equal(got, full[:3])


# --------------------------------------------------------------------- #
# health: the quarantine book, probes, the stall guard
# --------------------------------------------------------------------- #

def test_health_monitor_book():
    reg = MetricsRegistry()
    m = HealthMonitor(registry=reg, devices=SLOTS[:4])
    assert m.survivors() == (0, 1, 2, 3)
    assert m.capacity_fraction() == 1.0
    assert m.quarantine(2, "device_fail")
    assert not m.quarantine(2, "device_fail")
    assert m.survivors() == (0, 1, 3) and m.capacity_fraction() == 0.75
    snap = m.snapshot()
    assert snap["quarantined"] == [2]
    assert snap["events"][0]["reason"] == "device_fail"
    assert counters(reg)["mesh_quarantine_total{reason=device_fail}"] \
        == 1.0
    assert reg.snapshot()["gauges"]["mesh_quarantined_devices"] == 1.0
    with pytest.raises(ValueError):
        m.quarantine(9, "device_fail")
    with pytest.raises(ValueError):
        m.quarantine(0, "bored")
    assert health.QUARANTINE_REASONS == \
        __import__("heat2d_tpu.mesh.health",
                   fromlist=["x"]).QUARANTINE_REASONS


def test_health_seq_orders_events_and_parole():
    m = HealthMonitor(devices=SLOTS[:3])
    fence = m.seq()
    m.quarantine(0, "probe_failure")
    assert m.seq() == fence + 1
    assert not m.parole(0, probe=lambda i: False)
    assert m.parole(0, passes=2, probe=lambda i: True)
    assert m.survivors() == (0, 1, 2)
    assert m.snapshot()["events"][-1]["kind"] == "readmit"


def test_probe_sweep_quarantines_chaos_dead_device():
    chaos.install(chaos.ChaosConfig(device_fail_at=1, device_fail_index=0))
    with pytest.raises(chaos.DeviceLostError):
        chaos.mesh_launch_point()
    reg = MetricsRegistry()
    m = HealthMonitor(registry=reg, devices=SLOTS[:2])
    out = m.probe()
    assert out == {0: False, 1: True}
    assert m.is_quarantined(0)
    assert counters(reg)["mesh_probe_failures_total"] >= 1.0


def test_probe_device_real_roundtrip():
    assert health.probe_device(0, SLOTS)


def test_is_device_loss_names():
    assert health.is_device_loss(chaos.DeviceLostError(0, "x"))
    assert health.is_device_loss(type("AcceleratorError",
                                      (RuntimeError,), {})("x"))
    assert not health.is_device_loss(RuntimeError("x"))


def test_guarded_call_passthrough_and_errors():
    assert health.guarded_call(lambda: 7, None) == 7
    assert health.guarded_call(lambda: 7, 5.0) == 7
    with pytest.raises(KeyError):
        health.guarded_call(lambda: {}["x"], 5.0)


def test_guarded_call_stall_discards_late_result():
    release = threading.Event()
    discards = []
    t = [0.0]

    def slow():
        release.wait(5.0)
        return "late"

    def run():
        with pytest.raises(MeshStallError):
            health.guarded_call(slow, 1.0, clock=lambda: t[0],
                                on_discard=lambda: discards.append(1))

    th = threading.Thread(target=run)
    th.start()
    time.sleep(0.05)
    assert th.is_alive()
    t[0] = 2.0
    th.join(5.0)
    assert not th.is_alive()
    assert discards == []
    release.set()
    deadline = time.monotonic() + 5.0
    while not discards and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(discards) == 1


def test_hung_probe_convicts_within_deadline(monkeypatch):
    m = HealthMonitor(devices=SLOTS[:1])
    monkeypatch.setattr(health, "PROBE_DEADLINE_S", 0.1)
    release = threading.Event()

    def hang(_index, _devices=None):
        release.wait(10.0)
        return True

    monkeypatch.setattr(health, "probe_device", hang)
    t0 = time.monotonic()
    out = m.probe()
    took = time.monotonic() - t0
    release.set()
    assert out[0] is False and m.is_quarantined(0)
    assert took < 5.0


def test_fault_policy_member_owner_invariant_wait_for():
    with pytest.raises(ValueError):
        FaultPolicy(max_requeues=-1)
    with pytest.raises(ValueError):
        FaultPolicy(stall_deadline_s=0.0)
    p = FaultPolicy()
    assert p.stall_deadline_s is None and not p.abft
    devs = (0, 2, 3, 5)
    assert [degrade.member_owner(m, 8, devs) for m in range(8)] \
        == [0, 0, 2, 2, 3, 3, 5, 5]
    m = HealthMonitor(devices=SLOTS[:4])
    m.quarantine(1, "device_fail")
    good = {"signature": "s", "mesh": {"devices": [0, 2, 3],
                                       "health_seq": m.seq()}}
    bad = {"signature": "s", "mesh": {"devices": [0, 1],
                                      "health_seq": m.seq()}}
    assert degrade.serving_invariant(m, [good])["ok"]
    res = degrade.serving_invariant(m, [good, bad])
    assert not res["ok"] and res["violations"][0]["device"] == 1
    assert wait_for(lambda: True, None)
    assert not wait_for(lambda: False, 0.05)
    ticks = iter(range(0, 10_000, 100))
    assert not wait_for(lambda: False, 50.0,
                        clock=lambda: float(next(ticks)), poll=0.001)


# --------------------------------------------------------------------- #
# the guarded engine
# --------------------------------------------------------------------- #

def _batch_decision(eng, r0):
    return {"route": "batch", "reason": "fits_chip",
            "signature": str(r0.signature()), "n_devices": eng.n_devices}


def test_engine_without_fault_has_no_fault_state():
    eng = engine(registry=MetricsRegistry())
    assert eng.health is None and eng.degrader is None
    assert eng.fault_snapshot() is None
    assert len(eng.solve_batch(reqs(3))) == 3
    assert "devices" not in eng.launch_log[-1].get("mesh", {})


def test_device_loss_with_no_survivors_propagates_and_quarantines():
    chaos.install(chaos.ChaosConfig(device_fail_at=1, device_fail_index=0))
    eng = engine(slots=SLOTS[:1], registry=MetricsRegistry(),
                 fault=FaultPolicy())
    rs = reqs(1)
    with pytest.raises(chaos.DeviceLostError):
        eng._solve_batch_mesh(rs, _batch_decision(eng, rs[0]))
    assert eng.health.quarantined() == (0,)
    assert all("devices" not in (r.get("mesh") or {})
               for r in eng.launch_log)
    with pytest.raises(Rejected) as ei:
        eng._solve_batch_mesh(rs, _batch_decision(eng, rs[0]))
    assert ei.value.code == "mesh_degraded"


def test_stall_budget_exhausted_is_rejected_mesh_stall():
    chaos.install(chaos.ChaosConfig(hang_collective=2,
                                    hang_collective_s=0.4,
                                    device_fail_index=0))
    reg = MetricsRegistry()
    eng = engine(slots=SLOTS[:1], registry=reg,
                 fault=FaultPolicy(stall_deadline_s=0.05))
    rs = reqs(1)
    eng._solve_batch_mesh(rs, _batch_decision(eng, rs[0]))   # warm
    with pytest.raises(Rejected) as ei:
        eng._solve_batch_mesh(rs, _batch_decision(eng, rs[0]))
    assert ei.value.code == "mesh_stall"
    assert eng.health.quarantined() == (0,)
    assert counters(reg)["mesh_stall_total"] >= 1.0


def test_runtime_error_without_conviction_propagates_unrequeued():
    """An accelerator error naming no slot whose probe sweep convicts
    nobody is not a device fault: propagated, not requeued."""
    AcceleratorError = type("AcceleratorError", (RuntimeError,), {})
    reg = MetricsRegistry()
    eng = engine(slots=SLOTS[:1], registry=reg, fault=FaultPolicy())
    calls = []

    def boom(requests, device_indices, abft):
        calls.append(1)
        raise AcceleratorError("deterministic launch failure")

    eng._launch_batch = boom
    rs = reqs(1)
    with pytest.raises(AcceleratorError):
        eng._solve_batch_mesh(rs, _batch_decision(eng, rs[0]))
    assert len(calls) == 1
    assert eng.health.quarantined() == ()
    assert "mesh_requeue_total{cause=device_fail}" not in counters(reg)


def test_poisoned_card_is_rejected_never_served():
    """A sticky card error: every slot of the card fails its probe, all
    are quarantined, the error propagates (no survivor), and the next
    bucket is ``Rejected("mesh_degraded")``; nothing was served from a
    poisoned slot."""
    AcceleratorError = type("AcceleratorError", (RuntimeError,), {})
    eng = engine(slots=SLOTS[:4], registry=MetricsRegistry(),
                 fault=FaultPolicy())
    eng._launch_batch = lambda *a: (_ for _ in ()).throw(
        AcceleratorError("an illegal memory access was encountered"))
    orig = health.probe_device
    health.probe_device = lambda i, d=None: False
    try:
        rs = reqs(2)
        with pytest.raises(AcceleratorError):
            eng._solve_batch_mesh(rs, _batch_decision(eng, rs[0]))
        assert eng.health.quarantined() == (0, 1, 2, 3)
        with pytest.raises(Rejected) as ei:
            eng.solve_batch(rs)
        assert ei.value.code == "mesh_degraded"
        assert eng.launch_log == []
    finally:
        health.probe_device = orig


def test_abft_unsupported_method_served_and_counted():
    reg = MetricsRegistry()
    eng = engine(slots=SLOTS[:1], registry=reg,
                 fault=FaultPolicy(abft=True))
    rs = reqs(1, method="mg", steps=4)
    assert len(eng._solve_batch_mesh(rs, _batch_decision(eng, rs[0]))) == 1
    assert counters(reg)["mesh_abft_unsupported_total{reason=mg}"] == 1.0


def test_device_loss_shrinks_and_recovers_bitwise():
    want = oracle(reqs(5))
    chaos.install(chaos.ChaosConfig(device_fail_at=1, device_fail_index=3))
    reg = MetricsRegistry()
    eng = engine(registry=reg, fault=FaultPolicy())
    assert grids(eng.solve_batch(reqs(5))) == want
    assert eng.health.quarantined() == (3,)
    row = eng.launch_log[-1]["mesh"]
    assert row["devices"] == [0, 1, 2, 4, 5, 6, 7]
    assert row["degraded"] is True
    rec = row["recovery"]
    assert rec["cause"] == "device_fail" and rec["recovery_s"] > 0
    assert eng.fault_snapshot()["invariant"]["ok"]
    assert counters(reg)["mesh_requeue_total{cause=device_fail}"] == 1.0


def test_flip_bit_abft_detects_quarantines_recovers_bitwise():
    want = oracle(reqs(5))
    chaos.install(chaos.ChaosConfig(flip_bit=1))
    reg = MetricsRegistry()
    eng = engine(registry=reg, fault=FaultPolicy(abft=True))
    assert grids(eng.solve_batch(reqs(5))) == want
    assert eng.health.quarantined() == (0,)
    assert eng.health.snapshot()["events"][0]["reason"] == \
        "silent_corruption"
    c = counters(reg)
    assert c["mesh_abft_mismatch_total"] >= 1.0
    assert c["mesh_requeue_total{cause=silent_corruption}"] == 1.0
    assert eng.fault_snapshot()["invariant"]["ok"]


def test_flip_bit_without_abft_is_served_corrupt():
    want = oracle(reqs(5))
    chaos.install(chaos.ChaosConfig(flip_bit=1))
    eng = engine(registry=MetricsRegistry(), fault=FaultPolicy(abft=False))
    assert grids(eng.solve_batch(reqs(5))) != want


def test_hang_stall_detected_shrinks_recovers_bitwise():
    hang_s = 2.0
    victims = reqs(5, base=0.3)
    want = oracle(victims)
    chaos.install(chaos.ChaosConfig(hang_collective=2,
                                    hang_collective_s=hang_s,
                                    device_fail_index=2))
    reg = MetricsRegistry()
    eng = engine(registry=reg, fault=FaultPolicy(stall_deadline_s=0.25,
                                                 max_requeues=3))
    eng.solve_batch(reqs(5))                  # warm (attempt 1)
    t0 = time.monotonic()
    out = eng.solve_batch(victims)
    recovered = time.monotonic() - t0
    assert grids(out) == want
    assert recovered < hang_s
    assert 2 in eng.health.quarantined()
    assert [e["reason"] for e in eng.health.snapshot()["events"]
            if e["device"] == 2] == ["mesh_stall"]
    assert eng.fault_snapshot()["invariant"]["ok"]
    deadline = time.monotonic() + hang_s + 3.0
    while time.monotonic() < deadline:
        c = counters(reg)
        if c.get("mesh_discarded_results_total{cause=mesh_stall}"):
            break
        time.sleep(0.05)
    assert c["mesh_discarded_results_total{cause=mesh_stall}"] >= 1.0
    assert c["mesh_stall_total"] >= 1.0


def test_spatial_signature_degrades_to_survivor_batch_bitwise():
    from heat2d_tpu_torch.mesh.scheduler import MeshScheduler
    reg = MetricsRegistry()
    sched = MeshScheduler(registry=reg, spatial_bytes_threshold=1,
                          devices=SLOTS)
    eng = engine(registry=reg, scheduler=sched, fault=FaultPolicy())
    rs = reqs(3)
    assert sched.decide(rs[0])["route"] == "spatial"
    eng.health.quarantine(4, "device_fail")
    assert grids(eng.solve_batch(rs)) == oracle(rs)
    row = eng.launch_log[-1]["mesh"]
    assert row["route"] == "batch" and row["reason"] == "quarantined"
    assert 4 not in row["devices"]
    assert counters(reg)["mesh_fallback_total{reason=quarantined}"] == 1.0


def test_spatial_route_device_loss_reroutes_to_survivors_bitwise():
    from heat2d_tpu_torch.mesh.scheduler import MeshScheduler
    rs = reqs(3)
    want = oracle(rs)
    chaos.install(chaos.ChaosConfig(device_fail_at=1, device_fail_index=2))
    reg = MetricsRegistry()
    sched = MeshScheduler(registry=reg, spatial_bytes_threshold=1,
                          devices=SLOTS)
    eng = engine(registry=reg, scheduler=sched, fault=FaultPolicy())
    assert grids(eng.solve_batch(rs)) == want
    assert eng.health.quarantined() == (2,)
    row = eng.launch_log[-1]["mesh"]
    assert row["route"] == "batch" and row["reason"] == "quarantined"
    assert counters(reg)["mesh_requeue_total{cause=device_fail}"] == 1.0
    assert eng.degrader.events[-1]["recovery_s"] > 0
    assert eng.fault_snapshot()["invariant"]["ok"]


def test_fault_clock_threads_into_health_monitor():
    eng = engine(slots=SLOTS[:1], registry=MetricsRegistry(),
                 fault=FaultPolicy(), fault_clock=lambda: 42.0)
    eng.health.quarantine(0, "device_fail")
    assert eng.health.snapshot()["events"][0]["t"] == 42.0
    assert eng.degrader.now() == 42.0


def test_serve_cli_mesh_flags_require_mesh():
    from heat2d_tpu.serve import cli as jcli
    from heat2d_tpu_torch.serve import cli
    for argv in (["--mesh-abft"], ["--mesh-stall-deadline", "5"],
                 ["--mesh-admission-mcells", "100"]):
        for mod in (cli, jcli):
            with pytest.raises(SystemExit) as ei:
                mod.main(argv + ["--selftest"])
            assert ei.value.code == 2


def test_single_route_pins_to_survivor_and_stamps_invariant():
    from heat2d_tpu_torch.mesh.scheduler import MeshScheduler
    reg = MetricsRegistry()
    sched = MeshScheduler(registry=reg, spatial_bytes_threshold=1,
                          devices=SLOTS)
    eng = engine(registry=reg, scheduler=sched, fault=FaultPolicy())
    eng.health.quarantine(0, "silent_corruption")
    rs = reqs(2, nx=15, ny=18)          # unplannable -> single route
    assert sched.decide(rs[0])["route"] == "single"
    assert grids(eng.solve_batch(rs)) == oracle(rs)
    row = eng.launch_log[-1]["mesh"]
    assert row["route"] == "single"
    assert row["devices"] == [1] and row["health_seq"] == 1
    assert eng.fault_snapshot()["invariant"]["ok"]
    row["devices"] = [0]
    assert not eng.fault_snapshot()["invariant"]["ok"]


def test_single_route_all_quarantined_is_rejected():
    eng = engine(slots=SLOTS[:1], registry=MetricsRegistry(),
                 fault=FaultPolicy())
    eng.health.quarantine(0, "device_fail")
    with pytest.raises(Rejected) as ei:
        eng.solve_batch(reqs(1))
    assert ei.value.code == "mesh_degraded"


def test_requeue_capacity_repads_to_survivor_multiple():
    chaos.install(chaos.ChaosConfig(device_fail_at=1, device_fail_index=6))
    eng = engine(registry=MetricsRegistry(), fault=FaultPolicy())
    eng.solve_batch(reqs(5))
    row = eng.launch_log[-1]
    assert len(row["mesh"]["devices"]) == 7
    assert row["capacity"] % 7 == 0
    assert row["capacity"] == mesh_capacity(5, eng.max_batch, 7)


def test_resize_shrinks_and_grows_bitwise():
    eng = engine(registry=MetricsRegistry())
    want = oracle(reqs(5))
    eng.resize(3)
    assert grids(eng.solve_batch(reqs(5))) == want
    assert eng.launch_log[-1]["mesh"]["devices"] == [0, 1, 2]
    eng.resize(ND)
    assert grids(eng.solve_batch(reqs(5))) == want
    assert [r["to"] for r in eng.resize_log] == [3, ND]
    with pytest.raises(ValueError):
        eng.resize(0)


def test_recovery_through_solve_server_single_flight():
    from heat2d_tpu_torch.serve.server import SolveServer
    victims = reqs(3, base=0.31)
    want = oracle(victims)
    chaos.install(chaos.ChaosConfig(device_fail_at=2, device_fail_index=5))
    reg = MetricsRegistry()
    eng = engine(registry=reg, fault=FaultPolicy())
    server = SolveServer(registry=reg, engine=eng, max_batch=eng.max_batch,
                         default_timeout=120.0)
    with server:
        for f in [server.submit(r) for r in reqs(8, base=0.05)]:
            f.result(120)
        futs = [server.submit(r) for r in victims]
        dup = server.submit(victims[0])
        got = [np.asarray(f.result(120).u).tobytes() for f in futs]
        dup_res = dup.result(120)
    assert got == want
    assert np.asarray(dup_res.u).tobytes() == want[0]
    assert dup_res.coalesced
    assert eng.health.quarantined() == (5,)
    assert eng.fault_snapshot()["invariant"]["ok"]


def test_chaos_gate_record_shape():
    from heat2d_tpu_torch.mesh import chaos_gate
    payload = chaos_gate.run_gate(host_devices(4, "cpu"))
    assert payload["passed"] is True
    assert [s["scenario"] for s in payload["scenarios"]] == \
        ["device_loss", "bit_flip", "hung_collective"]
    for s in payload["scenarios"]:
        assert s["bitwise"] and s["recovered"]
        assert s["recovery_s"] > 0 and s["invariant"]["ok"]
    assert payload["scenarios"][0]["quarantined"] == [3]
    assert payload["scenarios"][1]["quarantined"] == [0]
