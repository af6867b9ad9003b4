"""Worker-pool supervisor: spawn, watch, fence, restart. The port's copy
of ``heat2d_tpu/fleet/supervisor.py``.

Owns N worker subprocesses (``fleet/worker.py``) and nothing about
requests: the router above it keeps the in-flight bookkeeping, the
supervisor keeps the PROCESSES — spawn with per-slot env (chaos
campaigns aim at individual workers), read their stdout on a thread
per worker, and run one monitor loop that declares a worker dead on
either signal:

- **process exit** (``poll()`` — a crash, an injected
  ``os._exit(137)``);
- **heartbeat age** (no line from the worker within
  ``heartbeat_timeout`` — catches the gray failure where the process
  is alive but silent: a dropped-heartbeat campaign, a wedged
  runtime, a stop-the-world hang).

Declaring death FENCES first: the process is killed before the router
hears ``on_worker_lost``, so a half-dead worker cannot race its
replacement with late answers (the wire's per-dispatch ids make such
lines harmless anyway — fencing just keeps the property structural).

Restarts are automatic with FULL-JITTERED capped exponential backoff
(``resil.retry.RetryPolicy(jitter=True)``): N workers killed by the
same fault come back decorrelated instead of thundering-herding the
same signature. The attempt counter resets when a replacement reports
ready, so a stable worker earns back a fast restart.

The supervisor's shutdown is graceful end to end: each worker gets a
``shutdown`` line (drain: in-flight answers flush before exit 0), then
an escalating terminate/kill for stragglers. ``stop()`` returns True
iff every CURRENT worker exited cleanly — the chaos soak's "clean
supervisor exit" assertion.

Devices: every worker is started with ``--device`` (``cuda`` unless the
caller asks for ``cpu``), and all of them share what the parent sees:
the supervisor leaves ``CUDA_VISIBLE_DEVICES`` as it finds it, so N
workers on one card are N CUDA contexts on it, time-sliced by the
driver. A worker that cannot reach its device exits nonzero with the
error on stderr: at the pool's start that stops the pool
(``WorkerStartError``); later the monitor restarts it like any other
death.

Beyond the JAX supervisor, each generation row also carries when the
slot's process was spawned and reported ready (``spawned_at``,
``ready_at``, the host's monotonic clock, which a worker's ``startup``
stamps share), and ``kernel_launches()`` sums the hand kernels' launch
counts that every generation reported on its heartbeats.
"""

from __future__ import annotations

import json
import logging
import os
import random
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock, guarded_by
from heat2d_tpu_torch.resil.retry import RetryPolicy, wait_for

log = logging.getLogger("heat2d_tpu_torch.fleet")

#: characters the reader takes from a worker's pipe at a time; each read
#: counts as a sign of life
READ_CHUNK = 1 << 20

#: default jittered backoff for worker restarts (docstring above)
DEFAULT_RESTART_POLICY = RetryPolicy(max_attempts=1000, base_delay=0.2,
                                     backoff=2.0, max_delay=5.0,
                                     jitter=True)


class WorkerGone(RuntimeError):
    """Raised by ``send`` when the target worker's pipe is gone; the
    router treats it like a death it just hasn't been told about yet."""


class WorkerStartError(RuntimeError):
    """Raised by ``start`` when a first-spawn worker exits before it
    reports ready (a worker that cannot reach its device exits nonzero,
    its error on stderr): the pool stops instead of restarting a worker
    that cannot come up."""


class WorkerHandle:
    """One live worker process + its liveness state."""

    def __init__(self, slot: int, proc: subprocess.Popen):
        self.slot = slot
        self.proc = proc
        self.spawned = time.monotonic()
        self.last_seen = self.spawned
        self.ready = False
        self.dead = False
        #: a deliberate drain (restart/retire) is in progress: the
        #: shutdown line is — or is about to be — in the pipe. Checked
        #: UNDER ``write_lock`` by ``_write``, which closes the
        #: admission race structurally: stdin is FIFO, so any request
        #: line that won the lock before the drain fence was processed
        #: before the worker exits, and no line can land after the
        #: shutdown line (it would be silently dropped by the exiting
        #: worker and sit un-replayed until its deadline).
        self.draining = False
        self.restarted = False      # a replacement, not a first spawn
        self.via = "start"          # start | restart | rollout | scale_up
        self.overlay = None         # one-generation env overlay, if any
        self.info = None            # the worker's ready line (tune
        #                             stamp etc.), once it reports
        self.launches: Dict[str, int] = {}  # its last heartbeat's counts
        self.tuned: List[list] = []         # and its launches' tuned plans
        self.reader: Optional[threading.Thread] = None  # its stdout's
        self.write_lock = AuditedLock(f"fleet.worker{slot}.pipe")

    def pid(self) -> int:
        return self.proc.pid


@guarded_by("_lock", "_handles", "_generations", "_spawned")
class Supervisor:
    """Spawn/watch/restart N fleet workers. See the module docstring
    for the failure model; the router wires the three callbacks."""

    def __init__(self, workers: int, *,
                 device: str = "cuda",
                 worker_args: Optional[List[str]] = None,
                 env: Optional[dict] = None,
                 per_worker_env: Optional[Dict[int, dict]] = None,
                 heartbeat_interval: float = 0.25,
                 heartbeat_timeout: float = 2.0,
                 ready_timeout: float = 60.0,
                 restart_policy: Optional[RetryPolicy] = None,
                 restart_rng: Optional[random.Random] = None,
                 max_restarts: Optional[int] = None,
                 registry=None,
                 on_response: Optional[Callable[[int, dict], None]] = None,
                 on_worker_lost: Optional[Callable[[int], None]] = None,
                 on_worker_ready: Optional[Callable[[int], None]] = None,
                 on_worker_retiring: Optional[Callable[[int], None]] = None,
                 on_tick: Optional[Callable[[], None]] = None,
                 clock: Optional[Callable[[], float]] = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.n = workers
        self.device = device
        self.worker_args = list(worker_args or [])
        self.env = dict(env or {})
        self.per_worker_env = {int(k): dict(v) for k, v in
                               (per_worker_env or {}).items()}
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.ready_timeout = ready_timeout
        self.restart_policy = (DEFAULT_RESTART_POLICY
                               if restart_policy is None
                               else restart_policy)
        self.restart_rng = restart_rng
        self.max_restarts = max_restarts
        self.registry = registry
        self.on_response = on_response
        self.on_worker_lost = on_worker_lost
        self.on_worker_ready = on_worker_ready
        #: fires when a retirement is ADMITTED, strictly before the
        #: drain begins — the router takes the slot out of its routing
        #: set here, so no request admitted mid-retire can target the
        #: draining worker (the ordering the autoscaler's scale-down
        #: correctness rests on)
        self.on_worker_retiring = on_worker_retiring
        self.on_tick = on_tick
        #: the dispatch-guarding deadline clock (resil.retry.wait_for
        #: convention): injectable so ready-wait scenarios are
        #: deterministic on any host speed; None = wall monotonic
        self.clock = clock

        self._lock = AuditedLock("fleet.supervisor")
        self._handles: List[Optional[WorkerHandle]] = [None] * workers
        self._attempts = [0] * workers       # consecutive failed spawns
        self._restart_at = [None] * workers  # due time while slot dead
        self._spawn_counts = [0] * workers   # generations per slot
        #: slots permanently removed by ``retire_worker`` — never
        #: respawned (slot indices are not reused; a later
        #: ``add_worker`` appends a FRESH slot instead)
        self._retired: set = set()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.restarts = 0
        self.deaths = 0
        #: one row per worker GENERATION that reported ready: slot,
        #: pid, how it was spawned (start | restart | rollout), any
        #: one-generation env overlay it ran under, and the tune-db
        #: stamp it reported — the audit trail the control plane's
        #: no-unvalidated-serving invariant is asserted on
        #: (``heat2d_tpu/control``). Appended under ``_lock``; read through
        #: ``generations_snapshot()``.
        self._generations: List[dict] = []
        #: every handle ever spawned, for ``kernel_launches``
        self._spawned: List[WorkerHandle] = []
        #: (slot, rc) of first-spawn workers that died before ready
        self._start_failures: List[tuple] = []

    # -- lifecycle ----------------------------------------------------- #

    def start(self, wait_ready: bool = True) -> "Supervisor":
        self._stop.clear()      # stop()/start() cycles must re-arm
        #                         the monitor, not leave it stillborn
        self._start_failures = []
        for slot in range(self.n):
            self._spawn(slot)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="heat2d-fleet-monitor",
                                         daemon=True)
        self._monitor.start()
        if wait_ready:
            # the ONE hand-rolled-timer-free deadline convention
            # (resil.retry.wait_for on Watchdog(clock=)): a frozen
            # injected clock waits forever, an advanced one times out
            # deterministically — no wall-clock flakes on slow hosts
            wait_for(lambda: self._start_failures or all(
                h is not None and h.ready for h in self._handles),
                self.ready_timeout, clock=self.clock)
            if self._start_failures:
                failed = list(self._start_failures)
                self.stop()
                raise WorkerStartError(
                    "fleet worker(s) exited before reporting ready "
                    + ", ".join(f"(slot {s}, rc {rc})" for s, rc in failed)
                    + "; the worker's stderr says why")
        return self

    def stop(self, timeout: float = 30.0) -> bool:
        """Drain-shutdown every worker; True iff all exited 0."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10)
        clean = True
        with self._lock:
            # dead handles awaiting restart were already reaped by the
            # death path; cleanliness is about the CURRENT workers
            handles = [h for h in self._handles
                       if h is not None and not h.dead]
            self._handles = [None] * self.n
        for h in handles:
            with h.write_lock:
                h.draining = True
            try:
                self._write(h, {"event": "shutdown"},
                            during_drain=True)
            except WorkerGone:
                pass
        deadline = time.monotonic() + timeout
        for h in handles:
            left = max(0.1, deadline - time.monotonic())
            try:
                rc = h.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                log.warning("worker %d did not drain in time; killing",
                            h.slot)
                h.proc.kill()
                h.proc.wait(timeout=10)
                rc = None
            if rc != 0:
                clean = False
            elif h.reader is not None:
                # a clean drain emitted its last lines before exit: let
                # the reader take them before the pipes close
                h.reader.join(timeout=5)
            self._close_pipes(h)
        self._gauge_alive()
        return clean

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the router's surface ------------------------------------------ #

    def alive_slots(self) -> List[int]:
        with self._lock:
            return [h.slot for h in self._handles
                    if h is not None and h.ready and not h.dead]

    def send(self, slot: int, obj: dict) -> None:
        with self._lock:
            h = self._handles[slot]
        if h is None or h.dead or h.draining:
            raise WorkerGone(f"worker {slot} is not running")
        self._write(h, obj)

    def kill_worker(self, slot: int) -> None:
        """Hard-kill a worker (the chaos soak's mid-load kill). The
        monitor detects the exit and runs the normal death path."""
        with self._lock:
            h = self._handles[slot]
        if h is not None:
            log.warning("chaos: hard-killing worker %d (pid %d)",
                        slot, h.pid())
            h.proc.kill()

    # -- the control plane's surface -------------------------------------- #

    def worker_info(self, slot: int) -> Optional[dict]:
        """The CURRENT worker's ready line (pid, protocol, tune-db
        stamp), or None while the slot has no ready worker."""
        with self._lock:
            h = self._handles[slot]
        if h is None or h.dead or not h.ready:
            return None
        return dict(h.info or {})

    def kernel_launches(self) -> Dict[str, int]:
        """The hand kernels' launches summed over every worker generation
        (each one's counts as of its last heartbeat; a worker sends one
        more after its drain, so a clean stop leaves them complete)."""
        with self._lock:
            handles = list(self._spawned)
        total: Dict[str, int] = {}
        for h in handles:
            for k, v in dict(h.launches).items():
                total[k] = total.get(k, 0) + int(v)
        return total

    def tuned_launches(self) -> List[dict]:
        """Per worker generation ever spawned (in spawn order): its slot,
        pid, how it was spawned, its one-generation overlay, and its
        launch rows' tuning-db plans as of its last heartbeat
        (``worker.TunedTally``: [signature, capacity, tuned_config,
        launches] rows). What a rollout's canary actually ran."""
        with self._lock:
            handles = list(self._spawned)
        return [{"slot": h.slot, "pid": h.pid(), "via": h.via,
                 "overlay": h.overlay, "tuned": list(h.tuned)}
                for h in handles]

    def generations_snapshot(self) -> List[dict]:
        """Every worker generation that reported ready, in order — the
        control plane's audit trail for the no-unvalidated-serving
        invariant."""
        with self._lock:
            return [dict(g) for g in self._generations]

    def update_slot_env(self, slot: int, env: dict) -> None:
        """DURABLY merge ``env`` into one slot's per-worker env: every
        future spawn of the slot (crash restarts included) carries it.
        Contrast ``restart_worker``'s overlay, which lives for exactly
        one generation."""
        with self._lock:
            self.per_worker_env.setdefault(int(slot), {}).update(env)

    def restart_worker(self, slot: int,
                       env_overlay: Optional[dict] = None,
                       timeout: float = 30.0) -> None:
        """Deliberate in-place restart of one slot — the control
        plane's rollout actuator. The old worker drains (shutdown
        line, then escalating kill); the replacement spawns with
        ``env_overlay`` applied on top of the durable env **for this
        generation only**: any LATER restart of the slot — including
        a crash restart mid-kill-storm — rebuilds the env from the
        durable config alone, so an overlay (candidate) config can
        never be resurrected by the failure path. Blocks until the
        old process exited and the replacement was spawned (not until
        it is ready — poll ``worker_info``/``alive_slots``)."""
        with self._lock:
            h = self._handles[slot]
            self._restart_at[slot] = None
            if h is not None:
                # hand the slot from the monitor to us: no death path,
                # no competing backoff restart
                h.dead = True
        unclean = False
        if h is not None:
            with h.write_lock:
                # flip the drain fence under the pipe lock: any send
                # that already won the lock wrote BEFORE this point
                # (FIFO — the worker processes it before exiting), any
                # later one is refused by _write's draining check
                h.draining = True
            try:
                self._write(h, {"event": "shutdown"},
                            during_drain=True)
            except WorkerGone:
                pass
            try:
                h.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                log.warning("worker %d did not drain for a deliberate "
                            "restart; killing", slot)
                h.proc.kill()
                try:
                    h.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            unclean = h.proc.returncode != 0
            if unclean:
                self._close_pipes(h)
            else:
                # clean drain: every answer was emitted before exit,
                # but the reader thread may still be pulling buffered
                # lines — close only our write end and let the reader
                # run to EOF (closing stdout under it drops answers)
                try:
                    if h.proc.stdin is not None:
                        h.proc.stdin.close()
                except OSError:
                    pass
        if unclean and self.on_worker_lost is not None:
            # exit != 0 covers both the forced kill above AND a worker
            # that was already dead/crashed when the restart began
            # (h.dead=True fenced the monitor's death path out): the
            # router must get the same worker-lost sweep the crash
            # path runs, or its in-flight records for this slot sit
            # until their deadline instead of replaying
            self.on_worker_lost(slot)
        self.restarts += 1
        if self.registry is not None:
            self.registry.counter("fleet_worker_restarts_total")
        log.info("deliberate restart of worker %d%s", slot,
                 " (env overlay)" if env_overlay else "")
        self._spawn(slot, overlay=env_overlay, via="rollout")

    # -- the autoscaler's surface ------------------------------------------ #

    def pool_size(self) -> int:
        """Provisioned (non-retired) slots — the unit count the
        capacity model sizes against. Includes slots whose worker is
        momentarily dead-awaiting-restart or still warming up: those
        chips are still PAID FOR, which is what sizing is about."""
        with self._lock:
            return self.n - len(self._retired)

    def provisioned_slots(self) -> List[int]:
        """The non-retired slot indices, ascending — the autoscaler
        picks its scale-down victims from the top of this list."""
        with self._lock:
            return [s for s in range(self.n) if s not in self._retired]

    def add_worker(self) -> int:
        """Scale-up actuation: append ONE fresh slot to the pool and
        spawn its worker (``via="scale_up"``). Returns the new slot
        index; the caller learns readiness the usual way
        (``on_worker_ready`` / ``alive_slots``). Slot indices grow
        monotonically — retired indices are never reused, so a slot
        number stays an unambiguous identity across the generations
        audit trail."""
        with self._lock:
            slot = self.n
            self.n += 1
            self._handles.append(None)
            self._attempts.append(0)
            self._restart_at.append(None)
            self._spawn_counts.append(0)
        log.info("scale-up: adding worker slot %d", slot)
        self._spawn(slot, via="scale_up")
        if self.registry is not None:
            self.registry.gauge("fleet_pool_size",
                                float(self.pool_size()))
        return slot

    def retire_worker(self, slot: int, timeout: float = 30.0) -> bool:
        """Scale-down actuation: drain-to-retire one slot, permanently.

        Ordering contract (the satellite fix this path exists for):
        the slot is FENCED before the drain begins —

        1. under ``_lock``: the slot joins ``_retired`` (no respawn,
           ever), its backoff timer clears, and its handle goes dead
           (``alive_slots`` stops listing it, ``send`` refuses it,
           the monitor's death path is disarmed);
        2. ``on_worker_retiring`` tells the router to drop the slot
           from its routing table;
        3. only THEN does the drain start: ``draining`` flips under
           the pipe's ``write_lock`` and the shutdown line goes out —
           so a request admitted mid-retire either wrote before the
           fence (FIFO: the worker answers it before exiting) or is
           refused with ``WorkerGone`` and re-dispatched. It can
           never land behind the shutdown line.

        In-flight work the worker already holds finishes during the
        drain (answers flush before exit 0). A drain that outlives
        ``timeout`` (on the supervisor's injectable ``clock``) is
        killed and ``on_worker_lost`` replays its in-flight requests.
        A worker that never reported ready was never routed to, so it
        holds nothing to drain: its start is stopped at once (a clean
        retirement), where waiting it out would hold the caller for the
        rest of the start (~9 s on the card; the JAX package drains).
        Returns True iff the drain was clean. Idempotent."""
        with self._lock:
            if slot in self._retired:
                return True
            if not 0 <= slot < self.n:
                raise ValueError(f"no such slot {slot}")
            h = self._handles[slot]
            self._retired.add(slot)
            self._restart_at[slot] = None
            if h is not None:
                h.dead = True   # fence: monitor, alive_slots, send
                starting = not h.ready
        if self.on_worker_retiring is not None:
            self.on_worker_retiring(slot)
        clean = True
        if h is not None and starting:
            h.proc.kill()
            try:
                h.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            self._close_pipes(h)
            h = None
        if h is not None:
            with h.write_lock:
                h.draining = True
            try:
                self._write(h, {"event": "shutdown"},
                            during_drain=True)
            except WorkerGone:
                pass
            drained = wait_for(lambda: h.proc.poll() is not None,
                               timeout, clock=self.clock)
            if not drained:
                log.warning("worker %d did not drain for retirement; "
                            "killing", slot)
                h.proc.kill()
                try:
                    h.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            clean = h.proc.returncode == 0
            if clean:
                # clean drain: answers were emitted before exit, but
                # the reader may still be pulling buffered lines —
                # close only stdin and let it run to EOF
                try:
                    if h.proc.stdin is not None:
                        h.proc.stdin.close()
                except OSError:
                    pass
            else:
                self._close_pipes(h)
        if not clean and self.on_worker_lost is not None:
            # same rationale as restart_worker: an unclean exit may
            # have dropped in-flight answers — the router must replay
            self.on_worker_lost(slot)
        log.info("worker %d retired (%s drain)", slot,
                 "clean" if clean else "unclean")
        if self.registry is not None:
            self.registry.counter("fleet_worker_retirements_total",
                                  outcome=("clean" if clean
                                           else "unclean"))
            self.registry.gauge("fleet_pool_size",
                                float(self.pool_size()))
        self._gauge_alive()
        return clean

    # -- spawn / death / restart --------------------------------------- #

    def _worker_cmd(self, slot: int) -> List[str]:
        return [sys.executable, "-m", "heat2d_tpu_torch.fleet.worker",
                "--worker-id", str(slot),
                "--heartbeat", str(self.heartbeat_interval),
                "--device", self.device,
                *self.worker_args]

    def _worker_env(self, slot: int) -> dict:
        import heat2d_tpu_torch
        env = dict(os.environ)
        # the worker must import this heat2d_tpu_torch regardless of cwd
        # or whether the package is pip-installed in the child's env
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(heat2d_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
            else "")
        env.update(self.env)
        env.update(self.per_worker_env.get(slot, {}))
        return env

    def _spawn(self, slot: int, overlay: Optional[dict] = None,
               via: Optional[str] = None) -> None:
        env = self._worker_env(slot)
        if overlay:
            # ONE-generation overlay (restart_worker): applied to this
            # spawn only — never persisted, so a later crash restart
            # rebuilds from the durable env alone
            env.update(overlay)
        proc = subprocess.Popen(
            self._worker_cmd(slot), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=None,  # stderr passes through
            env=env, text=True, bufsize=1)
        h = WorkerHandle(slot, proc)
        h.overlay = dict(overlay) if overlay else None
        with self._lock:
            self._handles[slot] = h
            self._spawned.append(h)
            self._restart_at[slot] = None
            self._spawn_counts[slot] += 1
            h.restarted = self._spawn_counts[slot] > 1
            h.via = via or ("restart" if h.restarted else "start")
        h.reader = threading.Thread(target=self._read_loop, args=(h,),
                                    name=f"heat2d-fleet-reader-{slot}",
                                    daemon=True)
        h.reader.start()
        log.info("spawned worker %d (pid %d)", slot, proc.pid)

    def _read_loop(self, h: WorkerHandle) -> None:
        # Liveness is bytes, not whole lines: a 4096^2 answer is one ~89 MB
        # line, and a worker streaming it is alive for as long as it takes
        # the pipe to carry it (the JAX supervisor updates ``last_seen``
        # per line).
        part: List[str] = []
        try:
            while True:
                chunk = h.proc.stdout.readline(READ_CHUNK)
                if not chunk:
                    break
                h.last_seen = time.monotonic()
                if not chunk.endswith("\n"):
                    part.append(chunk)
                    continue
                line = "".join(part) + chunk
                part = []
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue        # torn line from a killed worker
                ev = msg.get("event")
                if ev == "ready":
                    h.info = msg
                    h.ready = True
                    with self._lock:
                        self._attempts[h.slot] = 0
                        self._generations.append({
                            "slot": h.slot, "pid": h.pid(),
                            "via": h.via, "restarted": h.restarted,
                            "overlay": h.overlay,
                            "tune": msg.get("tune"),
                            "spawned_at": h.spawned,
                            "ready_at": h.last_seen,
                            "startup": msg.get("startup")})
                    self._gauge_alive()
                    log.info("worker %d ready (pid %d%s)", h.slot,
                             h.pid(),
                             ", restart" if h.restarted else "")
                    if self.on_worker_ready is not None:
                        self.on_worker_ready(h.slot,
                                             restarted=h.restarted,
                                             via=h.via)
                elif ev == "hb":
                    # last_seen above is the point; the counts ride along
                    if isinstance(msg.get("launches"), dict):
                        h.launches = msg["launches"]
                    if isinstance(msg.get("tuned"), list):
                        h.tuned = msg["tuned"]
                elif "id" in msg and self.on_response is not None:
                    self.on_response(h.slot, msg)
        except (OSError, ValueError):
            pass                    # pipe torn down under the reader
        # EOF: the process is exiting; the monitor loop reaps it.

    def _write(self, h: WorkerHandle, obj: dict,
               during_drain: bool = False) -> None:
        """One request/control line into the worker's stdin.

        The ``draining`` re-check happens UNDER ``write_lock`` — the
        fence that makes deliberate drains race-free: ``send`` may
        have read ``draining=False`` an instant before the drain
        began, but it cannot WRITE after the shutdown line, because
        the drain path flips the flag and emits the shutdown while
        holding this same lock (``during_drain=True`` is that path's
        own pass). A line refused here raises ``WorkerGone`` and the
        router re-dispatches — instead of the old failure mode where
        the line landed behind the shutdown, was dropped by the
        exiting worker, and its request hung to deadline."""
        try:
            with h.write_lock:
                if h.draining and not during_drain:
                    raise WorkerGone(
                        f"worker {h.slot} is draining for a deliberate "
                        f"restart/retire")
                h.proc.stdin.write(json.dumps(obj) + "\n")
                h.proc.stdin.flush()
        except WorkerGone:
            raise
        except (BrokenPipeError, OSError, ValueError) as e:
            raise WorkerGone(f"worker {h.slot}: {e!r}") from None

    def _close_pipes(self, h: WorkerHandle) -> None:
        for f in (h.proc.stdin, h.proc.stdout):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass

    def _monitor_loop(self) -> None:
        poll = max(0.02, min(self.heartbeat_timeout / 4, 0.2))
        while not self._stop.wait(poll):
            now = time.monotonic()
            for slot in range(self.n):
                try:
                    self._monitor_slot(slot, now)
                except Exception:
                    # the monitor IS the fleet's failure detector: a
                    # transient here (Popen EAGAIN, a broken callback)
                    # must not kill supervision for every worker
                    log.exception("monitor pass failed for slot %d",
                                  slot)
            if self.on_tick is not None:
                try:
                    self.on_tick()
                except Exception:
                    log.exception("on_tick callback failed")

    def _monitor_slot(self, slot: int, now: float) -> None:
        with self._lock:
            h = self._handles[slot]
            due = self._restart_at[slot]
        if h is None or h.dead:
            if (due is not None and now >= due
                    and not self._stop.is_set()):
                self._restart(slot)
            return
        if h.proc.poll() is not None:
            self._declare_dead(h, "exit")
        elif (h.ready
              and now - h.last_seen > self.heartbeat_timeout):
            self._declare_dead(h, "heartbeat")
        elif (not h.ready
              and now - h.spawned > self.ready_timeout):
            self._declare_dead(h, "spawn_timeout")

    def _declare_dead(self, h: WorkerHandle, cause: str) -> None:
        rc = h.proc.poll()
        log.warning("worker %d declared dead (%s, rc=%s)", h.slot,
                    cause, rc)
        h.dead = True
        if not h.ready and h.via == "start":
            self._start_failures.append((h.slot, rc))
        self.deaths += 1
        # FENCE before failover: a heartbeat-silent worker is still
        # serving — kill it so it cannot answer after its in-flight
        # work is replayed elsewhere.
        try:
            h.proc.kill()
            h.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass
        self._close_pipes(h)
        if self.registry is not None:
            self.registry.counter("fleet_worker_deaths_total",
                                  cause=cause)
        self._gauge_alive()
        with self._lock:
            attempt = self._attempts[h.slot]
            self._attempts[h.slot] += 1
            exhausted = (self.max_restarts is not None
                         and self._attempts[h.slot] > self.max_restarts)
            self._restart_at[h.slot] = (
                None if exhausted
                else time.monotonic() + self.restart_policy.delay(
                    attempt, rng=self.restart_rng))
        if exhausted:
            log.error("worker %d: restart budget exhausted (%d); "
                      "slot stays down", h.slot, self.max_restarts)
        if self.on_worker_lost is not None:
            self.on_worker_lost(h.slot)

    def _restart(self, slot: int) -> None:
        self.restarts += 1
        if self.registry is not None:
            self.registry.counter("fleet_worker_restarts_total")
        log.info("restarting worker %d (restart #%d)", slot,
                 self.restarts)
        try:
            self._spawn(slot)
        except Exception:
            # Popen can fail transiently (fork EAGAIN, fd exhaustion);
            # back off instead of hot-looping a failing spawn
            with self._lock:
                attempt = self._attempts[slot]
                self._attempts[slot] += 1
                self._restart_at[slot] = (
                    time.monotonic() + self.restart_policy.delay(
                        attempt, rng=self.restart_rng))
            log.exception("respawn of worker %d failed; retrying "
                          "with backoff", slot)

    def _gauge_alive(self) -> None:
        if self.registry is not None:
            self.registry.gauge("fleet_workers_alive",
                                len(self.alive_slots()))
