"""The port's multi-process runtime (heat2d_tpu_torch/dist/) against the
JAX package's (heat2d_tpu/dist/), mirroring tests/test_dist.py.

The unit layers run against a fake store (TCPStore's methods) with an
injected clock, or against a real in-process ``TCPStore``: bounded
barriers and heartbeats, the store halo route's bitwise parity, the
no-overwrite KV rule and the two loss mappings (a deadline names the
silent host, a severed store names process 0), and the failure-domain
bridge's seq-fenced shrink+failover. Where the JAX package has the same
function, both get the same inputs and must agree: slab splits, the
recovery election, link kinds and censuses, pod arrangements and seam
profiles. The two real 2-process legs at the bottom (``--selftest`` and
``--soak --kill-host``) spawn worlds of the port's dist CLI on the CPU,
each with a 60 s timeout.

Tolerance against the JAX slab program: ``n * 2**-21 * max|ref|`` after n
steps (XLA's CPU jit contracts multiply-adds into FMAs; torch eager
rounds every operation). Within the port every comparison is bitwise.
"""

import datetime
import gc
import json
import threading

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from heat2d_tpu.dist import exchange as jexchange
from heat2d_tpu.dist import mesh as jdmesh
from heat2d_tpu.dist import runtime as jruntime
from heat2d_tpu_torch.dist.exchange import (DcnHaloExchanger,
                                            run_process_slab, segment_steps,
                                            slab_split)
from heat2d_tpu_torch.dist.harness import free_port
from heat2d_tpu_torch.dist.mesh import (arrange_pod, pod_device_order,
                                        seam_profile)
from heat2d_tpu_torch.dist.runtime import (KV_NS, DistWorld, Heartbeat,
                                           HostLostError, KeyExistsError,
                                           KVBarrier, KVStore,
                                           elect_recovery_owner,
                                           kv_get_bytes)
from heat2d_tpu_torch.dist.topology import (FailureDomainBridge,
                                            PodTopology, pod_monitor)
from heat2d_tpu_torch.obs.metrics import MetricsRegistry


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeStore:
    """TCPStore's semantics as probed under torch 2.13: ``set``
    overwrites, ``compare_set(key, "", v)`` writes only an absent key and
    returns what the key then holds, ``wait`` past its timeout raises the
    store's timeout error, ``add(key, 0)`` reads a counter (creating it
    at 0)."""

    def __init__(self):
        self.data = {}
        self.lock = threading.Lock()

    def set(self, key, value):
        with self.lock:
            self.data[key] = value.encode() if isinstance(value, str) \
                else bytes(value)

    def get(self, key):
        with self.lock:
            return self.data[key]

    def check(self, keys):
        with self.lock:
            return all(k in self.data for k in keys)

    def compare_set(self, key, expected, desired):
        with self.lock:
            if key not in self.data and expected == "":
                self.data[key] = bytes(desired)
            return self.data.get(key, b"")

    def add(self, key, n):
        with self.lock:
            v = int(self.data.get(key, b"0")) + n
            self.data[key] = str(v).encode()
            return v

    def delete_key(self, key):
        with self.lock:
            return self.data.pop(key, None) is not None

    def wait(self, keys, timeout):
        if not self.check(keys):
            raise tdist.DistStoreError(
                f"wait timeout after "
                f"{int(timeout.total_seconds() * 1000)}ms, keys: {keys}")


@pytest.fixture
def tcp_store():
    """A real TCPStore served in this process, and a factory of clients
    of it (one per thread, as one per process)."""
    port = free_port()
    master = tdist.TCPStore("127.0.0.1", port, 1, True,
                            timeout=datetime.timedelta(seconds=30),
                            wait_for_workers=False)

    def client():
        return tdist.TCPStore("127.0.0.1", port, 1, False,
                              timeout=datetime.timedelta(seconds=30))

    yield master, client
    del master


def _world(pid, count, device_process=None, device_slice=None):
    if device_process is None:
        device_process = tuple(range(count))
    return DistWorld(process_index=pid, process_count=count,
                     device_process=tuple(device_process),
                     device_slice=device_slice)


def _jworld(pid, count, device_process=None, device_slice=None):
    if device_process is None:
        device_process = tuple(range(count))
    return jruntime.DistWorld(process_index=pid, process_count=count,
                              device_process=tuple(device_process),
                              device_slice=device_slice)


def _tol(n, ref):
    return max(1, n) * 2.0 ** -21 * float(np.abs(ref).max())


# ------------------------------------------------------------------ #
# slabs and the store halo route
# ------------------------------------------------------------------ #

def test_slab_split_partitions_exactly():
    for nx, p in ((48, 2), (17, 3), (5, 5), (64, 1)):
        slabs = slab_split(nx, p)
        assert slabs == jexchange.slab_split(nx, p)
        assert slabs[0][0] == 0 and slabs[-1][1] == nx
        for (lo, hi), (lo2, _) in zip(slabs, slabs[1:]):
            assert hi == lo2 and hi > lo
    for nx, p in ((2, 3), (8, 0)):
        with pytest.raises(ValueError) as port:
            slab_split(nx, p)
        with pytest.raises(ValueError) as ref:
            jexchange.slab_split(nx, p)
        assert str(port.value) == str(ref.value)


def test_single_process_slab_is_the_golden_loop():
    """P = 1 ``run_process_slab`` is one golden step per step, bit for
    bit (the selftest's bitwise_vs_plain_loop anchor), and the JAX
    package's slab program within the FMA bound."""
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.ops.stencil import stencil_step

    got, step = run_process_slab(24, 16, 10, depth=4, device="cpu")
    assert step == 10
    u = inidat(24, 16)
    for _ in range(10):
        u = stencil_step(u, 0.1, 0.1)
    assert got.tobytes() == u.numpy().tobytes()
    assert segment_steps(inidat(24, 16), 10, 0.1, 0.1).numpy().tobytes() \
        == got.tobytes()
    ref, jstep = jexchange.run_process_slab(24, 16, 10, depth=4)
    assert jstep == step
    assert float(np.abs(got - np.asarray(ref)).max()) <= _tol(10, ref)


def test_two_thread_dcn_halo_bitwise_and_bounded_store(tcp_store):
    """Two in-process 'hosts' over a real TCPStore, each with its own
    client: the owned slabs concatenate BITWISE to the one-process grid,
    every halo key is consumed (the store stays bounded), and the bytes
    moved are counted."""
    master, client = tcp_store
    reg = MetricsRegistry()
    nx, ny, steps, depth = 32, 24, 12, 4
    out, errs = {}, []

    def run(pid):
        try:
            ex = DcnHaloExchanger(_world(pid, 2), depth, client=client(),
                                  timeout_s=30, registry=reg)
            out[pid], _ = run_process_slab(
                nx, ny, steps, depth=depth, process_index=pid,
                process_count=2, exchanger=ex, device="cpu")
        except Exception as e:      # noqa: BLE001 (reported below)
            errs.append(e)

    ts = [threading.Thread(target=run, args=(p,)) for p in range(2)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts) and errs == []
    ref, _ = run_process_slab(nx, ny, steps, depth=depth, device="cpu")
    got = np.concatenate([out[0], out[1]], axis=0)
    assert got.tobytes() == ref.tobytes()
    keys = [f"{KV_NS}halo/s{s}/{a}-{b}{piece}" for s in (0, 4, 8)
            for a, b in ((0, 1), (1, 0)) for piece in ("", "#0")]
    assert not any(master.check([k]) for k in keys)
    moved = sum(reg.find_counters("dist_halo_bytes_total").values())
    # 3 exchanges (steps 0, 4, 8) x 2 processes, each sending one
    # (depth, ny) f32 strip and receiving one
    assert moved == 3 * 2 * 2 * depth * ny * 4


def test_halo_timeout_names_the_silent_host(tcp_store):
    """A neighbour that never publishes is a HostLostError naming THAT
    host and the halo phase, on the real store's timeout."""
    _, client = tcp_store
    ex = DcnHaloExchanger(_world(0, 2), 2, client=client(), timeout_s=0.05)
    strip = np.zeros((2, 8), np.float32)
    with pytest.raises(HostLostError) as ei:
        ex.exchange("s0", strip, strip)
    assert ei.value.hosts == (1,)
    assert ei.value.phase == "halo:s0"
    assert isinstance(ei.value.__cause__, tdist.DistStoreError)


def test_severed_store_names_the_coordinator():
    """The store's server (process 0) gone: every wait is a HostLostError
    naming host 0, whatever host was to publish the key."""
    port = free_port()
    master = tdist.TCPStore("127.0.0.1", port, 1, True,
                            timeout=datetime.timedelta(seconds=10),
                            wait_for_workers=False)
    c = tdist.TCPStore("127.0.0.1", port, 1, False,
                       timeout=datetime.timedelta(seconds=10))
    c.set("x", "1")
    del master
    gc.collect()
    with pytest.raises(HostLostError) as ei:
        kv_get_bytes(c, f"{KV_NS}halo/s4/1-0", 5.0, lost_host=1,
                     phase="halo:s4")
    assert ei.value.hosts == (0,) and ei.value.phase == "halo:s4"
    assert isinstance(ei.value.__cause__, tdist.DistNetworkError)


def test_kv_store_refuses_overwrite(tcp_store):
    """The JAX store's no-overwrite rule over TCPStore, which overwrites
    silently: a second set of the same key raises, the first value
    stays, and a deleted key may be written again."""
    master, client = tcp_store
    master.set("raw", "a")
    master.set("raw", "b")                  # TCPStore itself overwrites
    assert master.get("raw") == b"b"
    kv = KVStore(client())
    kv.set(f"{KV_NS}k", b"first")
    with pytest.raises(KeyExistsError, match="ALREADY_EXISTS"):
        kv.set(f"{KV_NS}k", b"second")
    assert master.get(f"{KV_NS}k") == b"first"
    kv.delete(f"{KV_NS}k")
    assert not kv.has(f"{KV_NS}k")
    kv.set(f"{KV_NS}k", "again")
    assert kv.get(f"{KV_NS}k", 1.0, lost_host=1, phase="t") == b"again"


def test_kv_blobs_cross_the_store_value_limit(tcp_store):
    """A value past ``MAX_VALUE_BYTES`` (the real store resets the
    connection on large ones) is refused by ``set`` and travels as a blob
    of pieces, bit for bit; deleting the blob removes every piece."""
    from heat2d_tpu_torch.dist.runtime import MAX_VALUE_BYTES
    master, client = tcp_store
    kv = KVStore(client())
    data = np.random.default_rng(5).bytes(2 * MAX_VALUE_BYTES + 123)
    with pytest.raises(ValueError, match="set_blob"):
        kv.set(f"{KV_NS}big", data)
    kv.set_blob(f"{KV_NS}big", data)
    assert master.get(f"{KV_NS}big") == b"3"
    assert kv.get_blob(f"{KV_NS}big", 5.0, lost_host=1, phase="t") == data
    kv.delete_blob(f"{KV_NS}big")
    assert not any(master.check([k]) for k in
                   [f"{KV_NS}big"] + [f"{KV_NS}big#{i}" for i in range(3)])


def test_run_process_slab_guards():
    with pytest.raises(ValueError, match="exchanger"):
        run_process_slab(32, 16, 4, process_index=0, process_count=2,
                         device="cpu")
    with pytest.raises(ValueError, match="halo"):
        run_process_slab(6, 16, 4, depth=4, process_index=0,
                         process_count=2, device="cpu",
                         exchanger=DcnHaloExchanger(_world(0, 2), 4,
                                                    client=FakeStore()))
    with pytest.raises(ValueError, match="shape"):
        run_process_slab(8, 8, 2, u0=np.zeros((4, 4), np.float32),
                         device="cpu")


# ------------------------------------------------------------------ #
# bounded liveness: barrier and heartbeat
# ------------------------------------------------------------------ #

def _fake_clock():
    state = {"t": 0.0}

    def clock():
        return state["t"]

    def sleep(dt):
        state["t"] += dt

    return state, clock, sleep


def test_kv_barrier_names_missing_peers():
    state, clock, sleep = _fake_clock()
    bar = KVBarrier(_world(0, 3), client=FakeStore(), clock=clock,
                    sleep=sleep)
    with pytest.raises(HostLostError) as ei:
        bar.wait("go", timeout_s=5.0)
    assert ei.value.hosts == (1, 2)
    assert ei.value.phase == "barrier:go"
    assert state["t"] >= 5.0


def test_kv_barrier_completes_and_gcs_old_rounds():
    state, clock, sleep = _fake_clock()
    kv = FakeStore()
    reg = MetricsRegistry()
    bar = KVBarrier(_world(0, 2), client=kv, clock=clock, sleep=sleep,
                    registry=reg)
    for n in range(3):
        kv.set(f"{KV_NS}bar/go/{n}/1", "1")        # the peer arrives
        assert bar.wait("go", timeout_s=5.0) == 0.0
    # round 0 GC'd once round 2 completed; rounds 1 and 2 still present
    assert not any(k.startswith(f"{KV_NS}bar/go/0/") for k in kv.data)
    assert any(k.startswith(f"{KV_NS}bar/go/2/") for k in kv.data)
    # one-process worlds never touch the store
    assert KVBarrier(_world(0, 1), client=None).wait("solo") == 0.0


def test_heartbeat_ages_by_local_clock_and_convicts_stale():
    state, clock, _ = _fake_clock()
    kv = FakeStore()
    reg = MetricsRegistry()
    hb = Heartbeat(_world(0, 2), client=kv, clock=clock, registry=reg)
    kv.add(f"{KV_NS}hb/1", 1)                     # the peer's first beat
    assert hb.ages() == {1: 0.0}
    state["t"] = 4.0                              # no new beat
    assert hb.ages() == {1: 4.0}
    assert hb.stale(3.0) == (1,)
    with pytest.raises(HostLostError) as ei:
        hb.require_live(3.0, phase="soak")
    assert ei.value.hosts == (1,) and ei.value.phase == "soak"
    kv.add(f"{KV_NS}hb/1", 1)                     # the counter advances
    assert hb.ages() == {1: 0.0}
    assert hb.stale(3.0) == ()
    assert reg.find_gauges("dist_heartbeat_age_s"), \
        "ages() must gauge dist_heartbeat_age_s"


def test_heartbeat_is_one_counter_per_process():
    """Beats advance one counter (no key per beat, so nothing to GC): the
    store holds one heartbeat key per process however long it beats."""
    kv = FakeStore()
    hb = Heartbeat(_world(0, 2), client=kv)
    assert [hb.beat() for _ in range(5)] == [1, 2, 3, 4, 5]
    assert sorted(k for k in kv.data if k.startswith(f"{KV_NS}hb/")) == [
        f"{KV_NS}hb/0"]


def test_elect_recovery_owner():
    for survivors in ([2, 0, 3], (3, 2), [5]):
        assert elect_recovery_owner(survivors) == \
            jruntime.elect_recovery_owner(survivors)
    assert elect_recovery_owner([2, 0, 3]) == 0
    with pytest.raises(ValueError):
        elect_recovery_owner([])


# ------------------------------------------------------------------ #
# topology: links, arrangement, seam pricing
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("procs,slices", [
    ((0, 0, 1, 1), None), ((0, 0, 1, 1), (0, 0, 0, 0)),
    ((0, 1, 2, 3), (0, 0, 1, 1)), ((0, 0, 0, 1, 1, 1), None)])
def test_world_link_kind_by_process_and_slice(procs, slices):
    """Link kinds, census, ownership and peers equal the JAX package's
    on the same maps (slice identity, the cards of one host for the
    port, overrides process identity)."""
    count = max(procs) + 1
    w, jw = _world(0, count, procs, slices), _jworld(0, count, procs, slices)
    n = len(procs)
    assert [[w.link_kind(a, b) for b in range(n)] for a in range(n)] == \
        [[jw.link_kind(a, b) for b in range(n)] for a in range(n)]
    assert w.link_census() == jw.link_census()
    assert [w.devices_of(p) for p in range(count)] == \
        [jw.devices_of(p) for p in range(count)]
    assert w.peers() == jw.peers()
    assert w.summary() == jw.summary()
    if procs == (0, 0, 1, 1) and slices is None:
        assert w.link_kind(0, 0) == "local"
        assert w.link_kind(0, 1) == "ici" and w.link_kind(1, 2) == "dcn"
        assert w.link_census() == {"ici": 2, "dcn": 4}


def test_arrange_pod_keeps_xy_intra_host():
    procs = (0, 0, 1, 1)
    w, jw = _world(0, 2, procs), _jworld(0, 2, procs)
    assert pod_device_order(w) == jdmesh.pod_device_order(jw) == \
        [0, 1, 2, 3]
    rows = arrange_pod(w, 2, 2)
    assert rows == jdmesh.arrange_pod(jw, 2, 2) == [[0, 1], [2, 3]]
    for arrangement in (rows, [[0, 2], [1, 3]], [[0, 1, 2, 3]]):
        for ny in (64, 17):
            assert seam_profile(w, arrangement, ny) == \
                jdmesh.seam_profile(jw, arrangement, ny)
    prof = seam_profile(w, rows, ny=64)
    assert prof["dcn_seams"] == 0 and prof["ici_seams"] == 4
    assert prof["seam_bytes_per_step"] == 4 * 2 * 64 * 4
    bad = seam_profile(w, [[0, 2], [1, 3]], ny=64)
    assert bad["dcn_seams"] == 4
    assert bad["dcn_bytes_per_step"] == 4 * 2 * 64 * 4
    with pytest.raises(ValueError):
        arrange_pod(w, 3, 2)


def test_pod_mesh_is_the_ports_mesh_over_the_arrangement():
    """``pod_mesh`` builds a ``parallel.mesh.Mesh`` (not a JAX mesh) over
    the host-major arrangement: the slots of process 1 are remote to
    process 0, which holds its own two."""
    from heat2d_tpu_torch.dist.mesh import pod_mesh
    w = _world(0, 2, (0, 0, 1, 1))
    m = pod_mesh(w, 2, 2, device="cpu")
    assert m.shape == (2, 2) and m.owners == ((0, 0), (1, 1))
    assert m.spans_processes and m.is_local(0, 1) and not m.is_local(1, 0)
    assert m.local_devices() == [torch.device("cpu")] * 2
    assert pod_mesh(w, device="cpu").shape == (4, 1)


def test_scheduler_prices_cross_host_seams():
    """``MeshScheduler(world=)``: the seam census and bytes equal the JAX
    scheduler's on the same world; the seconds are the port's own: the
    H100's link figures between slots of one process, the host-staged
    rate measured on the H100 between processes."""
    from heat2d_tpu.mesh.scheduler import MeshScheduler as JScheduler
    from heat2d_tpu_torch.mesh.scheduler import MeshScheduler
    from heat2d_tpu_torch.parallel.mesh import host_devices
    from heat2d_tpu_torch.tune.measure import (HOST_STAGED_BYTES_PER_S,
                                               link_bytes_per_s)

    slots = host_devices(4, "cpu")
    # (slot owners, peer domains, seams that cross processes): the 2x2
    # arrangement has 4 seams (each row's pair, the ring wrap included),
    # each 2 * 64 * 4 bytes a step; host-major order keeps the first two
    # worlds' seams inside a process; one slot a process puts every seam
    # across processes, 'dcn' apart and 'ici' on one host, and either is
    # priced at the host-staged rate
    for procs, slices, n_cross in (((0, 0, 1, 1), None, 0),
                                   ((0, 1, 0, 1), None, 0),
                                   ((0, 1, 2, 3), None, 4),
                                   ((0, 1, 2, 3), (0, 0, 0, 0), 4)):
        n = max(procs) + 1
        w, jw = _world(0, n, procs, slices), _jworld(0, n, procs, slices)
        sched = MeshScheduler(devices=slots, world=w)
        links = sched._seam_links(2, 2, ny=64)
        want = JScheduler(n_devices=1, world=jw)._seam_links(2, 2, ny=64)
        census = ("ici_seams", "dcn_seams", "seam_bytes_per_step",
                  "dcn_bytes_per_step")
        assert {k: links[k] for k in census} == {k: want[k] for k in census}
        cross = n_cross * 2 * 64 * 4
        assert links["cross_process_bytes_per_step"] == cross
        one = links["seam_bytes_per_step"] - cross
        assert links["seam_s_per_step"] == pytest.approx(
            one / link_bytes_per_s("ici") + cross / HOST_STAGED_BYTES_PER_S)
    assert HOST_STAGED_BYTES_PER_S < link_bytes_per_s("dcn")
    # a submesh that does not cover the world has no arrangement
    assert sched._seam_links(1, 2, ny=64) is None
    # and without a world nothing is priced (one-process behaviour)
    assert MeshScheduler(devices=slots)._seam_links(2, 2, 64) is None


def test_scheduler_decision_rows_carry_the_links():
    """A spatial decision row over a world carries its seam pricing; the
    batch row, and every row without a world, carries none."""
    from heat2d_tpu_torch.mesh.scheduler import MeshScheduler
    from heat2d_tpu_torch.parallel.mesh import host_devices
    from heat2d_tpu_torch.serve.schema import SolveRequest

    w = _world(0, 2, (0, 0, 1, 1))
    sched = MeshScheduler(devices=host_devices(4, "cpu"), world=w,
                          spatial_bytes_threshold=1024)
    big = sched.decide(SolveRequest(nx=64, ny=64, steps=4, cx=0.1, cy=0.1))
    assert big["route"] == "spatial" and big["spatial_grid"] == (2, 2)
    assert big["links"] == sched._seam_links(2, 2, 64)
    assert big["links"]["dcn_seams"] == 0
    small = sched.decide(SolveRequest(nx=8, ny=8, steps=4, cx=0.1, cy=0.1))
    assert small["route"] == "batch" and "links" not in small


def test_measure_link_model_prices_the_asymmetry():
    """The H100's link figures (NVLink 4 and PCIe Gen5 per direction, HBM
    for 'local'), not the JAX package's TPU constants; a seam between
    processes is priced at the host-staged rate whatever its class."""
    from heat2d_tpu.tune import measure as jmeasure
    from heat2d_tpu_torch.tune.measure import (HBM_BYTES_PER_S,
                                               HOST_STAGED_BYTES_PER_S,
                                               LINK_BYTES_PER_S,
                                               link_bytes_per_s,
                                               route_bytes_per_s)

    assert link_bytes_per_s("ici") == LINK_BYTES_PER_S["ici"] == 450e9
    assert link_bytes_per_s("dcn") == LINK_BYTES_PER_S["dcn"] == 64e9
    assert link_bytes_per_s("dcn") < link_bytes_per_s("ici")
    assert link_bytes_per_s("local") == HBM_BYTES_PER_S == 3.35e12
    assert route_bytes_per_s("ici", True) == 450e9
    assert route_bytes_per_s("ici", False) == route_bytes_per_s(
        "dcn", False) == HOST_STAGED_BYTES_PER_S
    assert set(LINK_BYTES_PER_S) == set(jmeasure.LINK_BYTES_PER_S)
    assert not set(LINK_BYTES_PER_S.values()) & set(
        jmeasure.LINK_BYTES_PER_S.values())
    with pytest.raises(ValueError) as port:
        link_bytes_per_s("carrier_pigeon")
    with pytest.raises(ValueError) as ref:
        jmeasure.link_bytes_per_s("carrier_pigeon")
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------------------ #
# failure domains: one host loss, one transaction
# ------------------------------------------------------------------ #

def _pod4():
    topo = PodTopology({0: 0, 1: 0, 2: 1, 3: 1})
    reg = MetricsRegistry()
    return topo, pod_monitor(4, registry=reg), reg


def test_pod_topology_maps_failure_domains():
    topo, monitor, _ = _pod4()
    assert topo.n_devices == 4 and topo.hosts == (0, 1)
    assert topo.devices_of(1) == (2, 3)
    assert topo.host_of(0) == 0
    assert monitor.n_devices == 4    # the world's ordinals
    w = _world(0, 2, device_process=(0, 0, 1, 1))
    assert PodTopology.from_world(w).devices_of(1) == (2, 3)
    with pytest.raises(ValueError):
        PodTopology({})


def test_bridge_rejects_a_monitor_too_small_for_the_pod():
    topo, _, _ = _pod4()
    with pytest.raises(ValueError, match="outside the book"):
        FailureDomainBridge(topo, pod_monitor(2))


def test_host_loss_is_one_seq_fenced_transaction():
    """Quarantines land BEFORE the transaction's fence, the failover runs
    under it, and serving_invariant proves launches on both sides."""
    from heat2d_tpu_torch.mesh.degrade import serving_invariant

    topo, monitor, reg = _pod4()
    bridge = FailureDomainBridge(topo, monitor, registry=reg)
    log = [{"signature": "pre",
            "mesh": {"devices": [0, 1, 2, 3],
                     "health_seq": monitor.seq()}}]
    called = {}

    def failover():
        called["fence"] = monitor.seq()
        called["survivors"] = monitor.survivors()
        return {"resumed": True}

    txn = bridge.on_host_lost(1, failover=failover)
    assert txn["devices"] == [2, 3] and txn["quarantined"] == [2, 3]
    assert txn["survivors"] == [0, 1]
    assert txn["failover"] == {"resumed": True}
    assert txn["health_seq"] > txn["seq_before"]
    assert called == {"fence": txn["health_seq"], "survivors": (0, 1)}
    assert monitor.quarantined() == (2, 3)

    log.append({"signature": "post",
                "mesh": {"devices": [0, 1],
                         "health_seq": txn["health_seq"]}})
    inv = serving_invariant(monitor, log)
    assert inv["ok"] and inv["checked"] == 2
    bad = log + [{"signature": "bad",
                  "mesh": {"devices": [2],
                           "health_seq": txn["health_seq"]}}]
    inv2 = serving_invariant(monitor, bad)
    assert not inv2["ok"]
    assert inv2["violations"][0]["device"] == 2
    assert inv2["violations"][0]["event"]["reason"] == "host_lost"

    assert sum(reg.find_counters("dist_host_lost_total").values()) == 1
    assert bridge.snapshot()["transactions"] == [txn]
    # re-reporting re-quarantines nothing (idempotent per device)
    assert bridge.on_host_lost(1)["quarantined"] == []


def test_host_lost_is_a_documented_quarantine_reason():
    from heat2d_tpu.mesh.health import QUARANTINE_REASONS as jreasons
    from heat2d_tpu_torch.mesh.health import QUARANTINE_REASONS
    assert "host_lost" in QUARANTINE_REASONS and "host_lost" in jreasons


def test_dist_is_a_record_kind():
    from heat2d_tpu.obs.record import RECORD_KINDS as jkinds
    from heat2d_tpu_torch.obs.record import RECORD_KINDS, build_record
    assert "dist" in RECORD_KINDS and "dist" in jkinds
    rec = build_record("dist", extra={"leg": "selftest"}, device="cpu")
    assert rec["kind"] == "dist" and rec["leg"] == "selftest"
    assert rec["world"] == {"process_index": 0, "process_count": 1}


# ------------------------------------------------------------------ #
# harness and the real 2-process legs
# ------------------------------------------------------------------ #

def test_harness_helpers(monkeypatch):
    from heat2d_tpu_torch.dist.harness import clean_env, first_error_line

    assert 0 < free_port() < 65536
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "3")
    env = clean_env({"EXTRA": "1"})
    assert env["EXTRA"] == "1"
    assert "MASTER_PORT" not in env and "RANK" not in env
    assert env["TORCH_CPP_LOG_LEVEL"] == "ERROR"
    line = first_error_line(["all fine", "x\nValueError: boom\ny"])
    assert line == "ValueError: boom"
    assert first_error_line(["nothing here"]) is None


def test_real_two_process_selftest_bitwise(tmp_path):
    """A REAL 2-process world of the worker CLI on the CPU: the gathered
    final grid is bitwise the one-process program's and the plain loop's,
    and the worker's kind='dist' record carries serving_invariant ok and
    the dist_* metric totals."""
    from heat2d_tpu_torch.dist import cli as dcli

    rc = dcli.main(["--selftest", "--device", "cpu", "--nx", "32", "--ny",
                    "24", "--steps", "12", "--segment", "4", "--timeout",
                    "60", "--outdir", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "selftest_record.json").read_text())
    assert rec["kind"] == "dist" and rec["leg"] == "selftest"
    assert rec["bitwise_equal"] and rec["bitwise_vs_plain_loop"]
    # process 0's: 3 exchanges x (one strip out, one in) of (4, 24) f32
    assert rec["halo_bytes"] == 3 * 2 * 4 * 24 * 4
    worker = json.loads((tmp_path / "worker_record.json").read_text())
    assert worker["leg"] == "run" and worker["serving_invariant"]["ok"]
    assert worker["world"]["process_count"] == 2
    assert worker["world"]["device_process"] == [0, 1]
    assert worker["metrics"]["dist_halo_bytes_total"] > 0


def test_real_soak_kill_host(tmp_path):
    """SIGKILL one host mid-run: the survivor elects itself, recovers
    from the last collective checkpoint through the unified
    shrink+failover, and finishes bitwise, serving_invariant ok."""
    from heat2d_tpu_torch.dist import cli as dcli

    rc = dcli.main(["--soak", "--kill-host", "--device", "cpu", "--nx",
                    "48", "--ny", "32", "--steps", "32", "--segment", "4",
                    "--checkpoint-every", "8", "--pace", "0.3",
                    "--halo-timeout", "3", "--timeout", "60",
                    "--outdir", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "soak_record.json").read_text())
    assert rec["leg"] == "soak_kill_host" and rec["verdict_ok"]
    assert rec["bitwise_equal"]
    w = rec["worker_record"]
    assert w["leg"] == "host_loss_recovery" and w["lost_hosts"] == [1]
    assert w["serving_invariant"]["ok"]
    assert w["transaction"]["quarantined"] == [1]
    assert w["transaction"]["failover"]["resume_step"] >= 8
    assert w["transaction"]["failover"]["steps_done"] == 32
