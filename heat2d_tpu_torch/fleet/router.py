"""Fleet router: signature-affine distribution with chaos-proven
failover, a shared content-addressed cache, and tenant quotas. The
port's copy of ``heat2d_tpu/fleet/router.py``.

``FleetServer`` is the fleet's front door: the same ``submit() ->
Future`` contract as a single ``SolveServer``, served by N worker
subprocesses behind a ``Supervisor``, each on ``device`` (``cuda``
unless the caller asks for ``cpu``). The layers, outermost first:

1. **Shared cache + fleet single-flight.** The sha256 content hash is
   already the distribution key, so one bounded LRU in the router
   process covers ALL workers: any worker's answer warms every future
   caller, and the cache survives worker restarts. Identical in-flight
   requests coalesce fleet-wide onto one dispatch.
2. **Admission: quotas, capacity, breaker.** Per-tenant
   ``TenantPolicy`` (max in-flight + priority class: standard tenants
   shed at the high watermark, ``priority=0`` tenants may use the
   reserved headroom), a global in-flight cap, and the resil
   ``DegradedMode`` breaker: worker deaths are its failure signal, so a
   fleet in a crash loop sheds fresh compute while cache hits keep
   answering. Cache hits and coalesced followers bypass quota/capacity
   entirely: they cost no launch.
3. **Routing.** Rendezvous (highest-random-weight) hashing of the
   signature over the ALIVE workers: each signature sticks to one worker
   (its batcher buckets fill, its runner and kernel plans stay warm) and
   a death remaps ONLY the dead worker's share.
4. **Failover.** Every dispatch is tracked in flight. When the
   supervisor declares a worker dead, its in-flight requests REPLAY to a
   survivor under a fresh wire id (at most ``max_replays`` hops, then a
   structured ``Rejected("worker_lost")``). Solves are deterministic, so
   a replayed answer is bitwise the answer the dead worker would have
   given; the single-flight future resolves exactly once, so a client
   sees at most a latency blip, never a lost or duplicated answer. With
   no workers alive, requests PARK and flush the moment a restarted
   worker reports ready; fleet-level deadlines expire both parked and
   in-flight stragglers into ``Rejected("timeout")``.
5. **Warm restart.** A RESTARTED worker (never a first spawn) rejoins
   in two phases: on ``ready`` the router replays the fleet's HOT
   SIGNATURES to it as warmup events (off the client path), and the slot
   stays out of routing until the worker reports warm: one launch per
   hot signature at capacity 1 builds its runner and plans and grows the
   allocator before client requests can stall behind it. When every
   alive worker is still cold (a full-fleet restart), routing falls back
   to cold workers: a slow answer beats a parked one.

Metric families (the JAX package's): ``fleet_requests_total
{outcome}``, ``fleet_e2e_latency_s``, ``fleet_cache_*``,
``fleet_coalesced_total``, ``fleet_inflight`` / ``fleet_parked``
gauges, ``fleet_quota_rejected_total{tenant}``,
``fleet_failover_replays_total``, ``fleet_workers_alive``,
``fleet_worker_deaths_total{cause}``, ``fleet_worker_restarts_total``,
``fleet_degraded`` / ``fleet_breaker_trips_total``,
``fleet_shed_watermark`` (the control plane's pre-emptive-shed
actuator), ``fleet_signature_latency_s`` and
``fleet_signature_requests_total`` (``obs/slo.py``'s sources).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import random
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock, guarded_by
from heat2d_tpu_torch.fleet import wire
from heat2d_tpu_torch.fleet.supervisor import Supervisor, WorkerGone
from heat2d_tpu_torch.obs import tracing
from heat2d_tpu_torch.resil.retry import DegradedMode, RetryPolicy
from heat2d_tpu_torch.serve.cache import ResultCache, SingleFlight
from heat2d_tpu_torch.serve.schema import (Rejected, SolveRequest,
                                           SolveResult)
from heat2d_tpu_torch.serve.server import _outcome_of, coalesced_future
from heat2d_tpu_torch.serve.server import failed_future as _failed

log = logging.getLogger("heat2d_tpu_torch.fleet")

#: fraction of global capacity standard-priority tenants may fill; the
#: headroom above it is reserved for priority-0 (critical) tenants
HIGH_WATERMARK = 0.8

#: most-recent signatures replayed to a restarted worker as warmup
#: launches before it takes client traffic
MAX_HOT_SIGNATURES = 32


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission policy for one tenant. ``priority`` 0 is critical —
    admitted up to the full global capacity; standard tenants (>= 1)
    shed once the high watermark is reached, so a burst from a batch
    tenant cannot starve interactive traffic."""

    max_inflight: int = 64
    priority: int = 1

    def __post_init__(self):
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        if self.priority < 0:
            raise ValueError(
                f"priority must be >= 0, got {self.priority}")


def _end_wire(rec, **attrs) -> None:
    """Close the record's open wire span, if any (idempotent)."""
    ws, rec.wire_span = rec.wire_span, None
    if ws is not None:
        ws.end(**attrs)


def route_signature(sig: str, alive: List[int]) -> int:
    """Rendezvous hashing: the alive worker with the highest
    hash(sig, worker) wins. Deterministic, coordination-free, and
    minimally disruptive — removing a worker remaps only the
    signatures it owned."""
    if not alive:
        raise ValueError("no alive workers to route to")
    return max(alive, key=lambda w: hashlib.sha256(
        f"{sig}|{w}".encode()).digest())


@dataclasses.dataclass
class _Inflight:
    """One dispatched request: everything needed to answer it — or to
    replay it somewhere else. ``warmup`` records belong to a restarted
    worker's rejoin phase: no client future waits on them, they are
    never replayed, and their answers are discarded. ``probe`` records
    are the control plane's targeted dispatches (``FleetServer.
    probe``): pinned to ONE slot, bypassing cache/single-flight/
    quotas, never replayed — their answer (or structured failure)
    resolves ``fut`` directly."""
    key: Optional[str]          # content hash (cache / flight key)
    sig: str                    # signature string (routing key)
    tenant: str
    req_dict: dict
    t0: float
    deadline: Optional[float]
    slot: Optional[int] = None
    rid: Optional[int] = None
    replays: int = 0
    warmup: bool = False
    probe: bool = False
    fut: "object" = None        # probe-only: the caller's future
    #: tracing (obs/tracing.py): the request's root span, and the
    #: OPEN wire span of the current dispatch (a replay closes the old
    #: one and opens a fresh one — one wire span per hop). Warmup
    #: records never trace: they are the router's own business, not a
    #: request's causal chain.
    span: "object" = None
    wire_span: "object" = None


@guarded_by("_lock", "_parked", "_next_rid", "_total_inflight",
            "_stopped", "_shed_watermark")
class FleetServer:
    """N supervised workers behind one ``submit()``. See the module
    docstring for the layer map."""

    def __init__(self, workers: int = 2, *,
                 max_batch: int = 8, max_delay: float = 0.005,
                 queue_depth: int = 256, worker_cache_size: int = 256,
                 worker_timeout: float = 30.0,
                 cache_size: int = 512,
                 default_timeout: Optional[float] = 30.0,
                 max_inflight: int = 256,
                 quotas: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 max_replays: int = 2,
                 heartbeat_interval: float = 0.25,
                 heartbeat_timeout: float = 2.0,
                 restart_policy: Optional[RetryPolicy] = None,
                 restart_rng: Optional[random.Random] = None,
                 max_restarts: Optional[int] = None,
                 breaker: Optional[DegradedMode] = None,
                 registry=None, env: Optional[dict] = None,
                 per_worker_env: Optional[Dict[int, dict]] = None,
                 device: str = "cuda"):
        if registry is None:
            from heat2d_tpu_torch.obs import get_registry
            registry = get_registry()
        self.registry = registry
        self.default_timeout = default_timeout
        self.max_inflight = max_inflight
        self.quotas = dict(quotas or {})
        #: the unnamed tenant is critical by default: reservations are
        #: something operators opt INTO by naming lower-priority tenants
        self.default_policy = (TenantPolicy(max_inflight=max_inflight,
                                            priority=0)
                               if default_policy is None
                               else default_policy)
        self.max_replays = max_replays
        self.cache = ResultCache(cache_size, registry=registry,
                                 prefix="fleet_cache")
        self.flight = SingleFlight(registry=registry,
                                   counter="fleet_coalesced_total")
        self.breaker = (DegradedMode(registry=registry,
                                     metric_prefix="fleet")
                        if breaker is None else breaker)
        self.sup = Supervisor(
            workers, device=device,
            worker_args=["--max-batch", str(max_batch),
                         "--max-delay", str(max_delay),
                         "--queue-depth", str(queue_depth),
                         "--cache-size", str(worker_cache_size),
                         "--timeout", str(worker_timeout)],
            env=env, per_worker_env=per_worker_env,
            heartbeat_interval=heartbeat_interval,
            heartbeat_timeout=heartbeat_timeout,
            restart_policy=restart_policy, restart_rng=restart_rng,
            max_restarts=max_restarts, registry=registry,
            on_response=self._on_response,
            on_worker_lost=self._on_worker_lost,
            on_worker_ready=self._on_worker_ready,
            on_worker_retiring=self._on_worker_retiring,
            on_tick=self._expire_overdue)
        self._lock = AuditedLock("fleet.router")
        self._records: Dict[int, _Inflight] = {}
        self._parked: List[_Inflight] = []
        self._next_rid = 0
        self._tenant_inflight: Dict[str, int] = {}
        self._total_inflight = 0
        #: sig -> an example spec dict (the fleet's hot-signature set,
        #: replayed to restarted workers as warmup launches)
        self._hot: Dict[str, dict] = {}
        #: slots that are ready but still warming (not routable unless
        #: every alive slot is cold)
        self._cold: set = set()
        #: slot -> outstanding warmup rids
        self._warming: Dict[int, set] = {}
        #: slots fenced for retirement (``_on_worker_retiring`` — fired
        #: by the supervisor BEFORE the drain begins): never routable
        #: again, not even under the all-cold fallback. Retired slot
        #: indices are never reused, so the set only grows.
        self._retiring: set = set()
        #: control-plane override of HIGH_WATERMARK (pre-emptive
        #: shedding under sustained SLO burn); None
        #: means the static default
        self._shed_watermark: Optional[float] = None
        self._stopped = False
        self.replays = 0
        #: (slot, monotonic time) each time a warming slot rejoined the
        #: routing set: the last part of a restart's recovery
        self.warmed: List[tuple] = []

    # -- lifecycle ----------------------------------------------------- #

    def start(self, wait_ready: bool = True) -> "FleetServer":
        with self._lock:    # _stopped is read under the lock by the
            #                 dispatch park path; write it there too
            self._stopped = False
        self.sup.start(wait_ready=wait_ready)
        return self

    def stop(self, timeout: float = 30.0) -> bool:
        """Drain-stop the fleet; True iff every worker exited cleanly.
        Anything still unanswered afterwards fails with a structured
        ``Rejected("shutdown")`` — nobody hangs on a dead fleet."""
        with self._lock:
            # under the lock: _dispatch's park path checks this flag
            # under the same lock, so a request either parks before the
            # sweep below (and is swept) or fails at the park site
            self._stopped = True
        clean = self.sup.stop(timeout=timeout)
        with self._lock:
            leftovers = [r for r in (list(self._records.values())
                                     + self._parked) if not r.warmup]
            self._records.clear()
            self._parked.clear()
        for rec in leftovers:
            _end_wire(rec, outcome="shutdown")
            if rec.probe:
                rec.fut.set_exception(Rejected(
                    "shutdown", "fleet stopping",
                    content_hash=rec.key))
                continue
            self.flight.fail(rec.key, Rejected(
                "shutdown", "fleet stopping", content_hash=rec.key))
            self._count("rejected_shutdown")
        return clean

    def __enter__(self) -> "FleetServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- serving ------------------------------------------------------- #

    def submit(self, req: SolveRequest, tenant: str = "default",
               timeout: Optional[float] = None) -> Future:
        """Admit one request; the future resolves to a ``SolveResult``
        or fails with a structured ``Rejected`` (never raises)."""
        t0 = time.monotonic()
        timeout = self.default_timeout if timeout is None else timeout
        try:
            req.validate()
        except Rejected as e:
            self._count("rejected_invalid")
            return _failed(e)
        key = req.content_hash()

        # Tracing: the fleet-level root span — every dispatch/replay
        # wire span and (cross-process) every worker-side span in this
        # request's causal tree descends from it.
        span = tracing.NULL_SPAN
        if tracing.enabled():
            span = tracing.begin(
                "fleet.request", kind="request", content_hash=key,
                signature=str(req.signature()), tenant=tenant)

        hit = self.cache.get(key)
        if hit is not None:
            # Served no matter what state the fleet is in: quota,
            # capacity and the breaker all gate COMPUTE, not answers
            # the fleet already holds.
            self._count("cache_hit")
            self._latency(t0)
            span.end(outcome="cache_hit")
            fut = Future()
            fut.set_result(dataclasses.replace(
                hit, cache_hit=True, coalesced=False))
            return fut

        if self._stopped:
            # a stopped fleet must answer, not park a request no
            # worker will ever pick up (cache hits above still serve —
            # answers the router holds cost nothing)
            self._count("rejected_shutdown")
            span.end(outcome="rejected_shutdown")
            return _failed(Rejected("shutdown", "fleet is stopped"))

        fut, leader = self.flight.claim(key)
        if span is not tracing.NULL_SPAN:
            if not leader:
                span.set(coalesced=True)
            fut.add_done_callback(
                lambda f: span.end(outcome=_outcome_of(f)))
        if not leader:
            self._count("coalesced")
            out = coalesced_future(fut)
            out.add_done_callback(lambda _f: self._latency(t0))
            return out

        rej = self._admit(tenant, key)
        if rej is not None:
            self.flight.fail(key, rej)
            fut.add_done_callback(lambda _f: self._latency(t0))
            return fut

        rec = _Inflight(
            key=key, sig=str(req.signature()), tenant=tenant,
            req_dict=req.spec(), t0=t0,
            deadline=None if timeout is None else t0 + timeout,
            span=span)
        fut.add_done_callback(lambda _f: self._release(tenant, t0))
        self._dispatch(rec)
        return fut

    def solve(self, req: SolveRequest, tenant: str = "default",
              timeout: Optional[float] = None) -> SolveResult:
        """Synchronous convenience: submit + wait. Raises ``Rejected``."""
        wait = self.default_timeout if timeout is None else timeout
        return self.submit(req, tenant=tenant, timeout=timeout).result(
            None if wait is None else wait + 60)

    def probe(self, slot: int, req: SolveRequest,
              timeout: Optional[float] = None) -> Future:
        """Targeted dispatch to ONE worker — the control plane's
        parity/latency probe. Bypasses the shared
        cache, single-flight, quotas and the breaker on purpose: a
        probe exists to measure THAT worker's answer and latency, and
        a cache hit or a coalesce onto another worker's launch would
        measure nothing. The future resolves to the worker's own
        ``SolveResult`` or fails with a structured ``Rejected``; a
        probe is never replayed to a survivor (an answer from a
        different worker proves nothing about the probed one) and
        never enters the hot-signature warmup set."""
        t0 = time.monotonic()
        timeout = self.default_timeout if timeout is None else timeout
        fut: Future = Future()
        try:
            req.validate()
        except Rejected as e:
            fut.set_exception(e)
            return fut
        rec = _Inflight(
            key=req.content_hash(), sig=str(req.signature()),
            tenant="_control", req_dict=req.spec(), t0=t0,
            deadline=None if timeout is None else t0 + timeout,
            slot=slot, probe=True, fut=fut)
        self._dispatch(rec)
        return fut

    # -- elastic capacity (the autoscaler's actuators) ------------------ #

    def add_worker(self) -> int:
        """Scale-up actuation: grow the pool by one worker. The new
        worker rejoins through the warm-restart machinery — its
        ``via="scale_up"`` ready event warm-gates it
        (``_on_worker_ready``), so until its hot-signature warmups
        land it is unroutable and scale-up can never put client
        traffic on a cold worker."""
        return self.sup.add_worker()

    def retire_worker(self, slot: int, timeout: float = 30.0) -> bool:
        """Scale-down actuation: drain-to-retire one worker. The
        supervisor fences the routing table first
        (``_on_worker_retiring``), then drains; see
        ``Supervisor.retire_worker`` for the ordering contract.
        Returns True iff the drain was clean."""
        return self.sup.retire_worker(slot, timeout=timeout)

    # -- admission ----------------------------------------------------- #

    def _policy(self, tenant: str) -> TenantPolicy:
        return self.quotas.get(tenant, self.default_policy)

    def _admit(self, tenant: str, key: str) -> Optional[Rejected]:
        """Reserve capacity for a fresh leader, or explain why not."""
        pol = self._policy(tenant)
        with self._lock:
            shed = self._shed_watermark
            watermark = int(math.ceil(
                (HIGH_WATERMARK if shed is None else shed)
                * self.max_inflight))
            mine = self._tenant_inflight.get(tenant, 0)
            if mine >= pol.max_inflight:
                if self.registry is not None:
                    self.registry.counter("fleet_quota_rejected_total",
                                          tenant=tenant)
                self._count("rejected_quota")
                return Rejected(
                    "quota", f"tenant {tenant!r} at its in-flight "
                    f"limit {pol.max_inflight}", tenant=tenant,
                    content_hash=key)
            cap = (self.max_inflight if pol.priority == 0
                   else watermark)
            if self._total_inflight >= cap:
                self._count("rejected_overloaded")
                return Rejected(
                    "overloaded",
                    f"fleet at capacity ({self._total_inflight}/"
                    f"{self.max_inflight}"
                    + ("" if pol.priority == 0
                       else f"; standard-priority watermark "
                            f"{watermark}"
                            + (" (pre-emptive shed)"
                               if shed is not None else "")) + ")",
                    tenant=tenant, content_hash=key,
                    preemptive_shed=shed is not None)
            if not self.breaker.allow():
                self._count("rejected_degraded")
                return Rejected(
                    "degraded", "fleet is in degraded mode after "
                    "repeated worker failures: uncached load is shed "
                    "while workers recover", content_hash=key,
                    breaker_state=self.breaker.state)
            self._tenant_inflight[tenant] = mine + 1
            self._total_inflight += 1
            self._gauge_inflight_locked()
        return None

    def set_preemptive_shed(self, watermark: Optional[float]) -> None:
        """Control-plane actuator: temporarily lower
        the standard-priority admission watermark below
        ``HIGH_WATERMARK`` — sustained SLO burn sheds low-priority
        tenants BEFORE the breaker trips. ``None`` restores the
        default. Priority-0 tenants, cache hits and coalesced
        followers are untouched: they never consult the watermark."""
        if watermark is not None and not (0 <= watermark <= 1):
            raise ValueError(
                f"watermark must be in [0, 1], got {watermark}")
        with self._lock:
            self._shed_watermark = watermark
        if self.registry is not None:
            self.registry.gauge(
                "fleet_shed_watermark",
                HIGH_WATERMARK if watermark is None else watermark)

    def _release(self, tenant: str, t0: float) -> None:
        with self._lock:
            self._tenant_inflight[tenant] = max(
                0, self._tenant_inflight.get(tenant, 0) - 1)
            self._total_inflight = max(0, self._total_inflight - 1)
            self._gauge_inflight_locked()
        self._latency(t0)

    # -- dispatch / failover ------------------------------------------- #

    def _routable(self) -> List[int]:
        """Alive slots minus the still-warming and the retiring ones —
        unless ALL alive slots are cold (full-fleet restart): then a
        cold worker beats parking. A retiring slot never routes, even
        under that fallback: its drain is already under way."""
        slots = self.sup.alive_slots()
        with self._lock:
            alive = [s for s in slots if s not in self._retiring]
            warm = [s for s in alive if s not in self._cold]
        return warm or alive

    def _dispatch(self, rec: _Inflight) -> None:
        """Route ``rec`` to an alive worker, parking when none exist.
        A fresh wire id per dispatch: a late answer from a fenced
        worker can never alias a replay's."""
        tried = set()
        while True:
            with self._lock:
                retiring = set(self._retiring)
            alive = set(self.sup.alive_slots()) - retiring
            pool = ([rec.slot] if rec.warmup or rec.probe
                    else [s for s in self._routable()
                          if s not in tried])
            pool = [s for s in pool if s in alive]
            if not pool:
                if rec.warmup:
                    return      # its worker died; nothing to warm
                if rec.probe:
                    # a probe never parks or retargets: its whole point
                    # is THAT worker, and that worker is gone
                    rec.fut.set_exception(Rejected(
                        "worker_lost",
                        f"probe target slot {rec.slot} is not alive",
                        content_hash=rec.key))
                    return
                with self._lock:
                    stopped = self._stopped
                    if not stopped:
                        self._parked.append(rec)
                        if self.registry is not None:
                            self.registry.gauge("fleet_parked",
                                                len(self._parked))
                if stopped:
                    # stop()'s sweep may already have run: parking now
                    # would strand the caller's future forever
                    self.flight.fail(rec.key, Rejected(
                        "shutdown", "fleet stopping",
                        content_hash=rec.key))
                    self._count("rejected_shutdown")
                    return
                log.info("no alive workers: parked request %s…",
                         rec.key[:12])
                return
            slot = route_signature(rec.sig, pool)
            with self._lock:
                self._next_rid += 1
                rid = self._next_rid
                rec.rid, rec.slot = rid, slot
                self._records[rid] = rec
                if rec.warmup:
                    self._warming.setdefault(slot, set()).add(rid)
                elif not rec.probe:
                    # hot-signature set: recency-ordered, bounded
                    # (probes are control traffic, not client demand —
                    # they must not shape the warmup set)
                    self._hot.pop(rec.sig, None)
                    self._hot[rec.sig] = rec.req_dict
                    while len(self._hot) > MAX_HOT_SIGNATURES:
                        self._hot.pop(next(iter(self._hot)))
            msg = {"id": rid, "req": rec.req_dict}
            if rec.warmup:
                msg["event"] = "warmup"
            elif getattr(rec.span, "ctx", None) is not None:
                # one wire span per HOP: begun at send, closed by the
                # response / death / deadline — its context rides the
                # DISPATCH line so the worker's spans nest under it
                rec.wire_span = tracing.begin(
                    "fleet.dispatch", kind="wire", parent=rec.span.ctx,
                    slot=slot, rid=rid, replay=rec.replays)
                msg["trace"] = rec.wire_span.ctx.to_wire()
            try:
                self.sup.send(slot, msg)
                return
            except WorkerGone:
                _end_wire(rec, outcome="worker_gone_at_send")
                with self._lock:
                    owned = self._records.pop(rid, None) is not None
                    if rec.warmup:
                        self._warming.get(slot, set()).discard(rid)
                if rec.warmup:
                    return
                if rec.probe:
                    if owned:
                        rec.fut.set_exception(Rejected(
                            "worker_lost",
                            f"probe target slot {rec.slot} died at "
                            f"send", content_hash=rec.key))
                    return
                if not owned:
                    # a concurrent _on_worker_lost sweep already popped
                    # this rid and owns the replay — retrying here
                    # would double-dispatch the request
                    return
                tried.add(slot)

    def _on_response(self, slot: int, msg: dict) -> None:
        with self._lock:
            rec = self._records.pop(msg.get("id"), None)
        if rec is None:
            return      # late line from a fenced worker, or a replayed
            #             request already answered — dropped by design:
            #             no record, no span — a fenced worker's lines
            #             can never attach spans to a replay's trace
        if rec.warmup:
            self._warmup_done(rec)
            return
        if rec.probe:
            # a probe's answer goes straight to its caller: no cache
            # write, no single-flight, no per-signature SLO counters —
            # control traffic must not dress up as client outcomes
            if msg.get("ok"):
                try:
                    rec.fut.set_result(wire.decode_result(msg))
                except (KeyError, ValueError) as e:
                    rec.fut.set_exception(Rejected(
                        "error", f"undecodable probe response: {e!r}",
                        content_hash=rec.key))
            else:
                rec.fut.set_exception(wire.decode_rejection(msg))
            return
        _end_wire(rec, outcome="ok" if msg.get("ok") else "rejected")
        if msg.get("ok"):
            try:
                res = wire.decode_result(msg)
            except (KeyError, ValueError) as e:
                self.flight.fail(rec.key, Rejected(
                    "error", f"undecodable worker response: {e!r}",
                    content_hash=rec.key))
                self._count("error")
                return
            self.cache.put(rec.key, res)
            self.flight.resolve(rec.key, res)
            self.breaker.record_success()
            self._count("completed")
            if self.registry is not None:
                # per-signature latency/outcome: obs/slo.py's sources
                self.registry.observe(
                    "fleet_signature_latency_s",
                    time.monotonic() - rec.t0, signature=rec.sig)
                self.registry.counter(
                    "fleet_signature_requests_total",
                    signature=rec.sig, outcome="completed")
        else:
            # A structured worker-side rejection is an ANSWER (queue
            # full, watchdog timeout...), not a fleet fault: it must
            # not feed the breaker.
            exc = wire.decode_rejection(msg)
            self.flight.fail(rec.key, exc)
            self._count("rejected_" + exc.code)
            if self.registry is not None:
                self.registry.counter(
                    "fleet_signature_requests_total",
                    signature=rec.sig, outcome="rejected_" + exc.code)

    def _on_worker_lost(self, slot: int) -> None:
        with self._lock:
            lost = [r for r in self._records.values()
                    if r.slot == slot]
            for r in lost:
                self._records.pop(r.rid, None)
            # a dying warmup is moot — the replacement re-warms
            self._warming.pop(slot, None)
            self._cold.discard(slot)
            lost = [r for r in lost if not r.warmup]
        self.breaker.record_failure()
        probes = [r for r in lost if r.probe]
        lost = [r for r in lost if not r.probe]
        for rec in probes:
            # never replayed: an answer from a survivor would prove
            # nothing about the worker the probe was aimed at
            rec.fut.set_exception(Rejected(
                "worker_lost", "probed worker died mid-probe",
                content_hash=rec.key))
        if not lost:
            return
        log.warning("worker %d died with %d request(s) in flight; "
                    "replaying to survivors", slot, len(lost))
        for rec in lost:
            rec.replays += 1
            self.replays += 1
            _end_wire(rec, outcome="worker_lost")
            if self.registry is not None:
                self.registry.counter("fleet_failover_replays_total")
            if rec.replays > self.max_replays:
                self.flight.fail(rec.key, Rejected(
                    "worker_lost",
                    f"request lost {rec.replays} workers (limit "
                    f"{self.max_replays} replays)",
                    content_hash=rec.key))
                self._count("rejected_worker_lost")
            else:
                if getattr(rec.span, "ctx", None) is not None:
                    # the failover decision as an instant marker in the
                    # request's trace — the "replay" critical-path
                    # segment is the gap this event sits in
                    tracing.event("fleet.replay", parent=rec.span.ctx,
                                  from_slot=slot, replay=rec.replays)
                self._dispatch(rec)

    def _on_worker_retiring(self, slot: int) -> None:
        """The retire fence — fired by the supervisor BEFORE the drain
        begins (the satellite ordering fix): the slot leaves the
        routing set here, so no request admitted mid-retire can be
        routed onto the draining worker. In-flight records for the
        slot deliberately stay: a clean drain flushes their answers;
        an unclean one ends in ``_on_worker_lost``, which replays
        them."""
        with self._lock:
            self._retiring.add(slot)
            self._warming.pop(slot, None)
            self._cold.discard(slot)
        log.info("worker %d fenced out of routing for retirement",
                 slot)

    def _on_worker_ready(self, slot: int, restarted: bool = False,
                         via: Optional[str] = None) -> None:
        if restarted or via == "scale_up":
            # Replacements AND scale-up spawns warm-gate: both join a
            # fleet with live traffic and a hot-signature set, so they
            # stay unroutable until their warmups land. Only the
            # fleet-start first spawns skip the gate — they have no
            # hot set worth waiting for, and gating them would race
            # the first client dispatches.
            self._begin_warmup(slot)
        self._flush_parked()

    def _begin_warmup(self, slot: int) -> None:
        """Two-phase rejoin: replay the hot-signature set to the fresh
        worker (warmup launches, off the client path) and keep the slot
        out of routing until the last warmup answer lands."""
        now = time.monotonic()
        with self._lock:
            hot = list(self._hot.items())
        if not hot:
            return              # nothing to warm (fleet start)
        with self._lock:
            self._cold.add(slot)
            # the -1 sentinel holds the set non-empty until every
            # warmup dispatch below has registered (else an early
            # answer could mark the slot warm mid-enqueue)
            self._warming[slot] = {-1}
        if self.registry is not None:
            self.registry.counter("fleet_worker_warmups_total")
        log.info("worker %d warming %d hot signature(s) before "
                 "rejoining the routing set", slot, len(hot))
        for sig, spec in hot:
            # one warmup per signature, at capacity 1
            # (fleet/worker._warm_signature)
            self._dispatch(_Inflight(
                key=None, sig=sig, tenant="_warmup",
                req_dict=dict(spec), t0=now,
                deadline=now + (self.default_timeout or 60.0),
                slot=slot, warmup=True))
        done = _Inflight(key=None, sig="", tenant="_warmup",
                         req_dict={}, t0=now, deadline=None,
                         slot=slot, rid=-1, warmup=True)
        self._warmup_done(done)     # release the enqueue sentinel

    def _warmup_done(self, rec: _Inflight) -> None:
        with self._lock:
            pend = self._warming.get(rec.slot)
            if pend is not None:
                pend.discard(rec.rid)
                if pend:
                    return
                self._warming.pop(rec.slot, None)
            if rec.slot in self._cold:
                self.warmed.append((rec.slot, time.monotonic()))
            self._cold.discard(rec.slot)
        log.info("worker %d warm — rejoining the routing set",
                 rec.slot)

    def _flush_parked(self) -> None:
        with self._lock:
            parked, self._parked = self._parked, []
            if self.registry is not None:
                self.registry.gauge("fleet_parked", 0)
        for rec in parked:
            self._dispatch(rec)

    def _expire_overdue(self) -> None:
        """Monitor-tick sweep: fleet-level deadlines bound parked AND
        in-flight requests, whatever state the workers are in."""
        now = time.monotonic()
        overdue = []
        with self._lock:
            for rid in [rid for rid, r in self._records.items()
                        if r.deadline is not None
                        and r.deadline <= now]:
                overdue.append(self._records.pop(rid))
            keep = []
            for r in self._parked:
                (overdue if r.deadline is not None
                 and r.deadline <= now else keep).append(r)
            self._parked = keep
        for rec in overdue:
            if rec.warmup:
                # an overdue warmup must not wedge the slot cold
                self._warmup_done(rec)
                continue
            if rec.probe:
                rec.fut.set_exception(Rejected(
                    "timeout", "probe exceeded its deadline",
                    content_hash=rec.key,
                    waited_s=round(now - rec.t0, 6)))
                continue
            _end_wire(rec, outcome="timeout")
            self.flight.fail(rec.key, Rejected(
                "timeout", "request exceeded its fleet deadline",
                content_hash=rec.key,
                waited_s=round(now - rec.t0, 6)))
            self._count("rejected_timeout")
        # Parked work re-dispatches on any tick with a live worker —
        # belt-and-braces for the park-vs-ready race where a request
        # parks just after the ready flush swept the list.
        if self._parked and self.sup.alive_slots():
            self._flush_parked()

    # -- metrics ------------------------------------------------------- #

    def _count(self, outcome: str) -> None:
        if self.registry is not None:
            self.registry.counter("fleet_requests_total",
                                  outcome=outcome)

    def _latency(self, t0: float) -> None:
        if self.registry is not None:
            self.registry.observe("fleet_e2e_latency_s",
                                  time.monotonic() - t0)

    def _gauge_inflight_locked(self) -> None:
        if self.registry is not None:
            self.registry.gauge("fleet_inflight", self._total_inflight)
