"""Multi-process bring-up: rendezvous, topology, bounded liveness. The port
of ``heat2d_tpu/dist/runtime.py``.

``parallel/multihost.py`` (the MPI_Init analogue) owns the raw
``torch.distributed`` bring-up; everything a world of processes needs on
top of it lives here:

- ``bring_up``: rendezvous and a ``DistWorld``, the process topology, the
  slots each process owns and the link class of every slot pair, which
  every other dist layer consults.
- ``KVBarrier``: a BOUNDED barrier over the store: a peer that never
  arrives is a ``HostLostError`` naming the missing process(es), not an
  eternal hang. Clock and sleep are injectable, so the timeout
  arithmetic is testable against a fake store.
- ``Heartbeat``: a per-process beacon counter; age is measured by the
  LOCAL clock since a peer's counter last advanced (no cross-host clock
  comparison).

The store is torch's ``TCPStore`` (process 0 serves it at the
coordinator). Three of its semantics differ from the XLA coordination
service the JAX package runs over, and the port keeps the JAX discipline
on top:

- **No overwrite.** ``TCPStore.set`` overwrites silently; the JAX store
  refuses (ALREADY_EXISTS). ``KVStore.set`` refuses too
  (``KeyExistsError``), so every writer uses unique sequence-numbered
  keys and deletes what it consumed (``delete_key``).
- **Timeouts.** ``TCPStore.wait([key], timeout)`` raises
  ``DistStoreError`` ("wait timeout after ...ms, keys: ..."); that maps
  to a ``HostLostError`` naming the host that should have published the
  key. A severed store (process 0, its server, gone) raises
  ``DistNetworkError`` ("Broken pipe", "Connection was likely closed",
  "Connection reset"); that maps to ``HostLostError((0,), ...)``.
- **No prefix listing.** There is no ``key_value_dir_get``: a barrier
  round names one key per process index and tests them with
  ``check([...])``; a heartbeat is one counter per process
  (``add(key, 1)`` to beat, ``add(key, 0)`` to read).

A fourth limit has no JAX counterpart: the store resets the connection
on a large value (under torch 2.13 a 4 MiB value passed and a 16 MiB one
was refused; under torch 2.11 a 32 MiB one was). Bulk values (a
slab for a checkpoint or the final gather) go as blobs
(``KVStore.set_blob``): pieces of at most ``MAX_VALUE_BYTES`` under
``<key>#<i>``, then ``<key>`` holding their count, so a reader that sees
the key finds every piece.
"""

from __future__ import annotations

import datetime
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

from heat2d_tpu_torch.parallel.multihost import (   # noqa: F401
    gather_to_host, initialize_distributed, shutdown_distributed,
    world_summary)

#: every store key this package writes lives under one namespace, apart
#: from torch.distributed's own
KV_NS = "heat2d/"

#: the largest value one store key carries (module docstring)
MAX_VALUE_BYTES = 4 << 20

#: link classes ``DistWorld.link_kind`` hands out: the vocabulary the
#: link model (``tune/measure.py``) and the scheduler's seam pricing
#: (``mesh/scheduler.py``) price against
LINK_KINDS = ("local", "ici", "dcn")


class HostLostError(RuntimeError):
    """A peer process (= host) failed to show up inside a bounded wait:
    it missed a barrier, stopped beating, or never published its strip
    or checkpoint shard. Carries WHICH hosts and during WHAT phase, so
    recovery quarantines the right failure domain."""

    def __init__(self, hosts, phase: str, detail: str = ""):
        self.hosts = tuple(sorted(int(h) for h in hosts))
        self.phase = phase
        msg = (f"host(s) {list(self.hosts)} lost during {phase}"
               + (f": {detail}" if detail else ""))
        super().__init__(msg)


class KeyExistsError(RuntimeError):
    """A write to a store key that already holds a value (the JAX store's
    ALREADY_EXISTS)."""


def elect_recovery_owner(survivors) -> int:
    """The deterministic post-loss election: the LOWEST surviving process
    index owns recovery; every survivor computes the same answer from the
    same ``HostLostError``, no extra round trip."""
    survivors = sorted(int(s) for s in survivors)
    if not survivors:
        raise ValueError("no survivors to elect from")
    return survivors[0]


def _is_deadline(exc: BaseException) -> bool:
    """The timeout verdicts of the real store (``DistStoreError``, "wait
    timeout") and of test fakes (``TimeoutError``)."""
    return isinstance(exc, TimeoutError) or "timeout" in str(exc).lower()


def _is_severed(exc: BaseException) -> bool:
    """The store itself became unreachable: its server, process 0, is the
    casualty, whatever key was awaited."""
    import torch.distributed as dist
    s = str(exc)
    return isinstance(exc, (dist.DistNetworkError, ConnectionError)) or any(
        tag in s for tag in ("Broken pipe", "Connection was likely closed",
                             "Connection reset", "Failed to recv",
                             "failed to connect"))


def kv_get_bytes(store, key: str, timeout_s: float, *, lost_host: int,
                 phase: str) -> bytes:
    """Blocking get with the one loss mapping every dist layer shares: a
    timeout is a ``HostLostError`` naming the host that was to publish
    ``key``; a severed store names the coordinator (host 0)."""
    try:
        store.wait([key], datetime.timedelta(seconds=timeout_s))
        return store.get(key)
    except Exception as e:                   # noqa: BLE001 (re-raised)
        if _is_severed(e):
            raise HostLostError(
                (0,), phase,
                f"coordination store unreachable waiting on {key!r}") from e
        if _is_deadline(e):
            raise HostLostError(
                (lost_host,), phase,
                f"no value at {key!r} within {timeout_s}s") from e
        raise


class KVStore:
    """The store with the JAX package's KV discipline (module docstring):
    write-once keys, bounded gets that name the lost host, deletion of
    consumed keys. ``store`` is a ``TCPStore`` or anything with its
    methods (``set``, ``get``, ``wait``, ``check``, ``compare_set``,
    ``add``, ``delete_key``)."""

    def __init__(self, store):
        self.store = store

    def set(self, key: str, value) -> None:
        """Write ``value`` (bytes or str, at most ``MAX_VALUE_BYTES``)
        under a key that must be new."""
        data = value.encode() if isinstance(value, str) else bytes(value)
        if len(data) > MAX_VALUE_BYTES:
            raise ValueError(
                f"{key}: a value of {len(data)} bytes exceeds the store's "
                f"{MAX_VALUE_BYTES}; use set_blob")
        if self.store.check([key]):
            raise KeyExistsError(f"ALREADY_EXISTS: {key}")
        # compare_set against "" writes only where the key is absent and
        # returns what the key then holds: another writer won if it is
        # not our value
        if bytes(self.store.compare_set(key, "", data)) != data:
            raise KeyExistsError(f"ALREADY_EXISTS: {key}")

    def get(self, key: str, timeout_s: float, *, lost_host: int,
            phase: str) -> bytes:
        return kv_get_bytes(self.store, key, timeout_s, lost_host=lost_host,
                            phase=phase)

    def set_blob(self, key: str, data: bytes) -> None:
        """Write bytes of any length: the pieces first, then ``key`` with
        their count (write-once, like ``set``)."""
        n = max(1, -(-len(data) // MAX_VALUE_BYTES))
        for i in range(n):
            self.set(f"{key}#{i}",
                     data[i * MAX_VALUE_BYTES:(i + 1) * MAX_VALUE_BYTES])
        self.set(key, str(n))

    def get_blob(self, key: str, timeout_s: float, *, lost_host: int,
                 phase: str) -> bytes:
        """The bytes ``set_blob`` wrote, waiting (bounded) for ``key``."""
        n = int(self.get(key, timeout_s, lost_host=lost_host, phase=phase))
        return b"".join(self.get(f"{key}#{i}", timeout_s,
                                 lost_host=lost_host, phase=phase)
                        for i in range(n))

    def delete_blob(self, key: str) -> None:
        if self.has(key):
            for i in range(int(self.store.get(key))):
                self.delete(f"{key}#{i}")
            self.delete(key)

    def has(self, key: str) -> bool:
        return bool(self.store.check([key]))

    def delete(self, key: str) -> None:
        self.store.delete_key(key)

    def add(self, key: str, n: int) -> int:
        return int(self.store.add(key, n))


def kv_client() -> KVStore:
    """The world's store (the rendezvous already holds one) with the KV
    discipline. Raises RuntimeError when the process never rendezvoused:
    single-process callers must not get here."""
    from heat2d_tpu_torch.parallel.multihost import store
    return KVStore(store())


def _kv(client) -> KVStore:
    """A ``KVStore`` over ``client`` (a raw store or a ``KVStore``), or
    over the world's store when None."""
    if client is None:
        return kv_client()
    return client if isinstance(client, KVStore) else KVStore(client)


@dataclass(frozen=True)
class DistWorld:
    """The topology every dist layer consults: who am I, who else exists,
    which slots live where, and what class of link joins any slot pair.

    ``device_process[g]`` is the owning process of global slot ``g``;
    ``device_slice`` (optional) is the peer-access domain per slot: on
    cards, the host, since the cards of one host reach each other over
    NVLink whatever process drives them (the JAX package's ICI slice).
    Constructable directly with injected maps for simulation tests;
    ``from_env`` reads the live world."""

    process_index: int
    process_count: int
    coordinator: Optional[str] = None
    device_process: Tuple[int, ...] = field(default_factory=tuple)
    device_slice: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_env(cls, coordinator: Optional[str] = None,
                 local_slots: int = 1, device=None) -> "DistWorld":
        """The live world: ``local_slots`` slots per process. On the card
        the peer-access domain of a slot is its process's host; on the
        CPU, cross-process transport is a socket (DCN class), so process
        identity decides, as the JAX package decides for CPU devices."""
        import torch.distributed as dist

        from heat2d_tpu_torch.parallel import multihost as mh
        from heat2d_tpu_torch.utils.device import resolve_device
        n = mh.process_count()
        mine = (int(local_slots), socket.gethostname())
        rows = [mine]
        if n > 1:
            rows = [None] * n
            dist.all_gather_object(rows, mine)
        procs = tuple(p for p, (k, _) in enumerate(rows) for _ in range(k))
        slices = None
        if resolve_device(device).type == "cuda":
            hosts = list(dict.fromkeys(h for _, h in rows))
            slices = tuple(hosts.index(h) for k, h in rows
                           for _ in range(k))
        return cls(process_index=mh.process_index(), process_count=n,
                   coordinator=coordinator or mh.coordinator(),
                   device_process=procs, device_slice=slices)

    # -- identity ------------------------------------------------------ #

    @property
    def is_coordinator(self) -> bool:
        """Process 0 serves the store at the coordinator address."""
        return self.process_index == 0

    @property
    def n_devices(self) -> int:
        return len(self.device_process)

    def devices_of(self, process: int) -> Tuple[int, ...]:
        """Global slot ordinals owned by ``process``: the failure domain a
        host loss takes out in one piece."""
        return tuple(g for g, p in enumerate(self.device_process)
                     if p == process)

    def local_devices(self) -> Tuple[int, ...]:
        return self.devices_of(self.process_index)

    def peers(self) -> Tuple[int, ...]:
        return tuple(p for p in range(self.process_count)
                     if p != self.process_index)

    # -- links --------------------------------------------------------- #

    def link_kind(self, a: int, b: int) -> str:
        """'local' (same slot), 'ici' (same peer-access domain: same host
        where known, same process otherwise), 'dcn' (everything across).
        The asymmetry the link model and the seam pricing consume."""
        if a == b:
            return "local"
        if self.device_slice is not None:
            return ("ici" if self.device_slice[a] == self.device_slice[b]
                    else "dcn")
        return ("ici" if self.device_process[a] == self.device_process[b]
                else "dcn")

    def link_census(self) -> dict:
        """Unordered slot-pair counts per link class: the run record's
        one-glance topology shape."""
        out = {k: 0 for k in LINK_KINDS if k != "local"}
        n = self.n_devices
        for a in range(n):
            for b in range(a + 1, n):
                out[self.link_kind(a, b)] += 1
        return out

    def summary(self) -> dict:
        return {
            "process_index": self.process_index,
            "process_count": self.process_count,
            "coordinator": self.coordinator,
            "n_devices": self.n_devices,
            "device_process": list(self.device_process),
            "links": self.link_census(),
        }


def bring_up(coordinator: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None, *,
             registry=None, device=None, local_slots: int = 1,
             clock: Callable[[], float] = time.monotonic) -> DistWorld:
    """Rendezvous (when the launch line asks for a world of several
    processes) and return the ``DistWorld``. One process degrades to a
    1-process world without touching torch.distributed: the same code
    path runs under mpiexec-style launches and plain invocations.

    Records ``dist_rendezvous_s`` (wall time from call to connected
    world) when a registry rides along."""
    t0 = clock()
    if (num_processes or 1) > 1 or coordinator is not None:
        initialize_distributed(coordinator, num_processes, process_id)
    world = DistWorld.from_env(coordinator, local_slots, device)
    if registry is not None:
        registry.gauge("dist_rendezvous_s", clock() - t0)
    return world


class KVBarrier:
    """A named, BOUNDED barrier over the store.

    Each ``wait(name)`` publishes a per-invocation key
    (``heat2d/bar/<name>/<n>/<pid>``; the per-process invocation counter
    ``n`` must agree across processes, the call-ordering contract MPI
    barriers carry) and polls ``check`` over every process's key until
    all are present or the deadline passes, when the MISSING peers are
    named in a ``HostLostError``. Keys from two rounds back are deleted
    (a straggler may still be polling the previous round's).

    Why not the store's own barrier: its timeout says only that time ran
    out, not WHO was missing; this barrier exists to name the corpse."""

    def __init__(self, world: DistWorld, client=None, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 poll: float = 0.02, registry=None):
        self.world = world
        self._client = client
        self.clock = clock
        self.sleep = sleep
        self.poll = poll
        self.registry = registry
        self._counts: dict = {}

    def _key(self, name: str, n: int, pid: int) -> str:
        return f"{KV_NS}bar/{name}/{n}/{pid}"

    def wait(self, name: str, timeout_s: float = 60.0) -> float:
        """Block until every process arrives; returns seconds waited.
        Single-process worlds return at once."""
        if self.world.process_count <= 1:
            return 0.0
        n = self._counts[name] = self._counts.get(name, -1) + 1
        kv = self._client = _kv(self._client)
        t0 = self.clock()
        kv.set(self._key(name, n, self.world.process_index), "1")
        keys = [self._key(name, n, p)
                for p in range(self.world.process_count)]
        while not kv.store.check(keys):
            if self.clock() - t0 >= timeout_s:
                missing = [p for p, k in enumerate(keys) if not kv.has(k)]
                raise HostLostError(
                    missing, f"barrier:{name}",
                    f"{len(keys) - len(missing)}/{len(keys)} arrived in "
                    f"{timeout_s}s")
            self.sleep(self.poll)
        waited = self.clock() - t0
        if self.registry is not None:
            self.registry.observe("dist_barrier_wait_s", waited,
                                  barrier=name)
        if n >= 2:
            # GC the round a straggler can no longer be reading
            for p in range(self.world.process_count):
                kv.delete(self._key(name, n - 2, p))
        return waited


class Heartbeat:
    """Per-process liveness beacons with local-clock aging.

    ``beat()`` advances this process's counter (``heat2d/hb/<pid>``);
    ``start()`` beats on a daemon thread every ``interval_s``. ``ages()``
    reads every peer's counter and reports seconds since it LAST
    ADVANCED, measured entirely by this process's clock, so no
    cross-host clock agreement is assumed. ``require_live`` turns a stale
    peer into a named ``HostLostError``. One counter a process keeps the
    store bounded without deletes.

    The clock is injectable (and ``beat``/``ages`` are callable without
    the thread) so the staleness arithmetic is deterministic in tests."""

    def __init__(self, world: DistWorld, client=None, *,
                 interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.world = world
        self._client = client
        self.interval_s = interval_s
        self.clock = clock
        self.registry = registry
        self._last: dict = {}   # peer -> (last counter, local time)
        self._t0 = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def key(pid: int) -> str:
        return f"{KV_NS}hb/{pid}"

    # -- writer -------------------------------------------------------- #

    def beat(self) -> int:
        """Publish one beacon; returns its sequence number."""
        kv = self._client = _kv(self._client)
        return kv.add(self.key(self.world.process_index), 1)

    def start(self) -> None:
        if self.world.process_count <= 1 or self._thread is not None:
            return
        self.beat()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.beat()
                except Exception:      # noqa: BLE001 (beacon only; a
                    return             # dead store ends the loop)

        self._thread = threading.Thread(
            target=loop, name="heat2d-dist-heartbeat", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)
            self._thread = None

    # -- monitor ------------------------------------------------------- #

    def ages(self) -> dict:
        """{peer process -> seconds since its counter last advanced}. A
        peer that never beat ages from this monitor's birth."""
        if self.world.process_count <= 1:
            return {}
        kv = self._client = _kv(self._client)
        now = self.clock()
        out = {}
        for peer in self.world.peers():
            cur = kv.add(self.key(peer), 0)
            last_n, last_t = self._last.get(peer, (0, self._t0))
            if cur > last_n:
                last_n, last_t = cur, now
                self._last[peer] = (last_n, last_t)
            age = now - last_t
            out[peer] = age
            if self.registry is not None:
                self.registry.gauge("dist_heartbeat_age_s", age,
                                    process=str(peer))
        return out

    def stale(self, max_age_s: float) -> Tuple[int, ...]:
        return tuple(sorted(p for p, age in self.ages().items()
                            if age > max_age_s))

    def require_live(self, max_age_s: float,
                     phase: str = "heartbeat") -> None:
        dead = self.stale(max_age_s)
        if dead:
            raise HostLostError(
                dead, phase, f"no beacon advance within {max_age_s}s")
