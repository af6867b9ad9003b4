"""The solve server: admission -> cache -> single-flight -> micro-batch ->
ensemble launch. The port's copy of ``heat2d_tpu/serve/server.py`` for
solve requests.

Request lifecycle (``SolveServer.submit``):

1. **Validate**: a malformed or unsupported spec is rejected
   (``Rejected("invalid")`` / ``Rejected("unsupported_combination")``)
   before it touches any shared state.
2. **Cache**: a content-hash hit returns a completed future at once (the
   stored grid is the cold solve's, bit for bit).
3. **Single-flight**: an identical request already in flight attaches to
   the leader's future (one compute, N answers).
4. **Queue**: the leader enters the micro-batcher's signature bucket;
   load over the queue depth is shed at the door, and a queued request
   can time out.
5. **Launch**: the scheduler thread runs the bucket as one ensemble
   launch on the engine's device; results fill the cache and resolve the
   futures. A bucket of ``InverseRequest`` s (``request_kind ==
   "inverse"``, ``heat2d_tpu_torch/diff``) runs its optimization loops on
   a dedicated single-worker lane instead, so that it never holds solve
   launches up on the scheduler thread.

``submit`` returns a ``concurrent.futures.Future[SolveResult]`` and never
raises: rejections arrive as the future's exception. ``Client`` is the
synchronous wrapper.

A launch runs under the retry policy (transients back off and retry) and
a deadline ``Watchdog`` (a wedged launch fails its waiters with
``Rejected("watchdog_timeout")``). Repeated launch failures trip
``DegradedMode``: fresh work is shed with ``Rejected("degraded")`` while
cache hits are still served. An inverse loop also checks the deadline
and a non-drain stop once per iteration, and aborts.

``engine=`` takes another solve executor, the mesh engine
(``mesh.MeshEnsembleEngine``), whose ``max_batch`` then drives the
batcher; ``admission=`` arms modeled-capacity admission
(``mesh.MeshAdmission``), which sheds a leader before it queues.

Tracing (``obs/tracing.py``, armed by ``HEAT2D_TRACE_DIR`` or
``tracing.install``): one ``serve.request`` span per admission, the
batcher's ``serve.queue`` span and one ``serve.launch`` span per member
after its launch, all in the request's trace, so that
``heat2d-tpu-torch-trace`` connects each request end to end. The host
path is the hook's (``utils.profiling.phase``): ``serve.submit`` on the
client's thread; on the scheduler thread ``serve.dispatch``, a span
under the oldest member's request (``members`` lists the others' trace
ids), holding the engine's four steps (``serve.engine.prepare``,
``.run``, ``.readback``, ``.account``) and ``serve.resolve`` (the cache
and the futures, which run the clients' callbacks). Off, every hook is a
flag check.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from heat2d_tpu_torch.obs import tracing
from heat2d_tpu_torch.resil.retry import (DegradedMode, RetryPolicy,
                                          Watchdog, call_with_retries)
from heat2d_tpu_torch.serve.batcher import MicroBatcher
from heat2d_tpu_torch.serve.cache import ResultCache, SingleFlight
from heat2d_tpu_torch.serve.engine import EnsembleEngine
from heat2d_tpu_torch.serve.schema import (Rejected, SolveRequest,
                                           SolveResult, attach_trace,
                                           request_trace)
from heat2d_tpu_torch.utils.profiling import phase


class SolveServer:
    """In-process serving front end over the batched ensemble engine. It
    runs on ``cuda`` unless given ``device="cpu"``, and raises
    ``DeviceUnavailableError`` without a card."""

    def __init__(self, *, max_batch: int = 8, max_delay: float = 0.005,
                 max_queue: int = 256, cache_size: int = 256,
                 default_timeout: Optional[float] = 30.0,
                 registry=None, retry_policy: Optional[RetryPolicy] = None,
                 launch_deadline: Optional[float] = None,
                 breaker: Optional[DegradedMode] = None,
                 deadline_clock=None, device=None, engine=None,
                 admission=None):
        """``engine``: the solve executor, by default an
        ``EnsembleEngine`` on ``device``; a ``mesh.MeshEnsembleEngine``
        serves over its slots, and its ``max_batch`` (a slot multiple)
        drives the batcher. ``admission``: optional modeled-capacity
        admission (``mesh.MeshAdmission``): a leader it refuses is shed
        with its structured rejection before it queues; cache hits and
        coalesced followers never consult it."""
        if registry is None:
            from heat2d_tpu_torch.obs import get_registry
            registry = get_registry()
        self.registry = registry
        self.engine = (EnsembleEngine(registry=registry, max_batch=max_batch,
                                      device=device)
                       if engine is None else engine)
        max_batch = self.engine.max_batch
        self.admission = admission
        self.default_timeout = default_timeout
        self.retry_policy = (RetryPolicy() if retry_policy is None
                             else retry_policy)
        #: launch wall-clock deadline; None = no watchdog
        self.launch_deadline = launch_deadline
        #: the clock the deadline is read on (None: the wall clock); a
        #: test passes one it controls
        self.deadline_clock = deadline_clock
        self.breaker = (DegradedMode(registry=registry) if breaker is None
                        else breaker)
        self.cache = ResultCache(cache_size, registry=registry)
        self.flight = SingleFlight(registry=registry)
        #: the inverse engine and its lane, built on first use; the stop
        #: event interrupts a running loop on a non-drain stop
        self._inv_engine = None
        self._inv_pool = None
        self._inv_stop = threading.Event()
        self.batcher = MicroBatcher(self._dispatch, max_batch=max_batch,
                                    max_delay=max_delay,
                                    max_queue=max_queue, registry=registry)

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> "SolveServer":
        self._inv_stop.clear()
        self.batcher.start()
        return self

    def stop(self, drain: bool = False) -> None:
        """Stop serving. ``drain=True``: admission closes, queued buckets
        flush, and every admitted request is resolved before this
        returns (an inverse loop runs to its end). Default: whatever is
        still queued is rejected with ``Rejected("shutdown")``, and a
        running inverse loop stops at its next iteration."""
        if not drain:
            self._inv_stop.set()
        self.batcher.stop(drain=drain)
        pool, self._inv_pool = self._inv_pool, None
        if pool is not None:
            # every bucket handed to the lane is resolved when it joins
            pool.shutdown(wait=True)

    def __enter__(self) -> "SolveServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- serving ------------------------------------------------------- #

    def submit(self, req: SolveRequest,
               timeout: Optional[float] = None) -> Future:
        """Admit one request of the serving protocol (``validate``,
        ``content_hash``, ``signature``): a ``SolveRequest``, or an
        ``InverseRequest``; the future resolves to its result
        (``SolveResult`` or ``InverseResult``) or fails with a structured
        ``Rejected``."""
        with phase("serve.submit", parent=request_trace(req)):
            return self._submit(req, timeout)

    def _submit(self, req, timeout: Optional[float]) -> Future:
        t0 = time.monotonic()
        timeout = self.default_timeout if timeout is None else timeout
        try:
            req.validate()
        except Rejected as e:
            self._count("rejected_" + e.code)
            return _failed(e)
        key = req.content_hash()

        # One "serve.request" span per admission, the child of a context
        # that arrived with the request; the queue and launch spans
        # descend from it through the attached context.
        span = tracing.NULL_SPAN
        if tracing.enabled():
            span = tracing.begin(
                "serve.request", kind="request",
                parent=request_trace(req), content_hash=key,
                signature=str(req.signature()))
            attach_trace(req, span.ctx)

        hit = self.cache.get(key)
        if hit is not None:
            # Served even in degraded mode: the breaker sheds compute,
            # not answers the server already holds.
            self._count("cache_hit")
            self._latency(t0)
            span.end(outcome="cache_hit")
            fut = Future()
            fut.set_result(hit.as_cache_hit())
            return fut

        fut, leader = self.flight.claim(key)
        if span is not tracing.NULL_SPAN:
            # one close per admission, whatever path answers it (a
            # follower's closes with its leader's future)
            if not leader:
                span.set(coalesced=True)
            fut.add_done_callback(
                lambda f: span.end(outcome=_outcome_of(f)))
        if leader and not self.breaker.allow():
            self._count("rejected_degraded")
            self.registry.counter("serve_degraded_shed_total")
            self.flight.fail(key, Rejected(
                "degraded", "server is in degraded mode after repeated "
                "launch failures: uncached load is shed while the "
                "backend recovers", content_hash=key,
                breaker_state=self.breaker.state))
            return fut
        if leader and self.admission is not None:
            rej = self.admission.admit(req)
            if rej is not None:
                self._count("rejected_" + rej.code)
                self.flight.fail(key, rej)
                return fut
        if not leader:
            self._count("coalesced")
            out = coalesced_future(fut)
            out.add_done_callback(lambda _f: self._latency(t0))
            return out

        def fail(exc: BaseException) -> None:
            self._count(_outcome_label(exc))
            self.flight.fail(key, exc)

        try:
            self.batcher.submit(req, key, fail, timeout=timeout)
        except Rejected as e:
            fail(e)
        else:
            self._count("admitted")
        fut.add_done_callback(lambda _f: self._latency(t0))
        return fut

    def solve(self, req: SolveRequest,
              timeout: Optional[float] = None) -> SolveResult:
        """Submit and wait. Raises ``Rejected``."""
        wait = self.default_timeout if timeout is None else timeout
        # The queue deadline bounds the wait; the slack only guards
        # against a wedged scheduler thread.
        return self.submit(req, timeout=timeout).result(
            None if wait is None else wait + 60)

    # -- dispatch (scheduler thread) ----------------------------------- #

    def _inverse_engine(self):
        """The inverse engine, built on first inverse bucket: it aborts a
        loop that outlives ``launch_deadline`` or a non-drain stop."""
        if self._inv_engine is None:
            from heat2d_tpu_torch.diff.serving import InverseEngine
            self._inv_engine = InverseEngine(
                registry=self.registry, deadline=self.launch_deadline,
                stop_event=self._inv_stop, clock=self.deadline_clock,
                device=self.engine.device)
        return self._inv_engine

    def _dispatch(self, sig, batch) -> None:
        """Scheduler thread: a solve bucket runs here, an inverse bucket
        on the inverse lane (one worker), where ``_dispatch_batch`` still
        resolves or fails every member."""
        kind = getattr(batch[0].req, "request_kind", "solve")
        if kind == "inverse":
            if self._inv_pool is None:
                self._inv_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="heat2d-inverse")
            self._inv_pool.submit(self._dispatch_batch, sig, batch, kind)
            return
        self._dispatch_batch(sig, batch, kind)

    def _dispatch_batch(self, sig, batch, kind: str) -> None:
        """Bucket -> one launch (retried, watchdogged) -> per-request
        results. A launch that outlives ``launch_deadline`` has its
        waiters failed with ``Rejected("watchdog_timeout")`` by the
        watchdog thread; if it returns later, its results still warm the
        cache. Terminal failures fail every member and feed the
        breaker. An inverse bucket runs through the ``InverseEngine``
        under the same plumbing, and its ``InverseResult`` s cache and
        resolve as solve results do. All of it is the ``serve.dispatch``
        span, under the oldest member's request."""
        attrs = {}
        if tracing.enabled():
            attrs["members"] = [c.trace_id for c in (
                request_trace(p.req) for p in batch[1:]) if c is not None]
        with phase("serve.dispatch", parent=request_trace(batch[0].req),
                   **attrs):
            self._launch_and_resolve(sig, batch, kind)

    def _launch_and_resolve(self, sig, batch, kind: str) -> None:
        reqs = [p.req for p in batch]
        sig_str = str(sig)

        def on_timeout() -> None:
            self.registry.counter("serve_watchdog_timeouts_total")
            exc = Rejected(
                "watchdog_timeout",
                f"launch exceeded the {self.launch_deadline}s deadline",
                signature=sig_str)
            for p in batch:
                self.flight.fail(p.key, exc)
                self._count("rejected_watchdog_timeout")
                self._sig_count(sig_str, "rejected_watchdog_timeout")
            self.breaker.record_failure()

        def on_retry(i: int, exc: BaseException) -> None:
            self.registry.counter("serve_retries_total")
            self.registry.counter("serve_launch_failures_total")

        engine = (self._inverse_engine() if kind == "inverse"
                  else self.engine)
        watchdog = Watchdog(self.launch_deadline, on_timeout,
                            clock=self.deadline_clock)
        t_launch0 = time.monotonic()
        try:
            with watchdog:
                results = call_with_retries(
                    lambda: engine.solve_batch(reqs),
                    self.retry_policy, on_retry=on_retry)
        except BaseException as e:  # noqa: BLE001 — routed, not dropped
            self.registry.counter("serve_launch_failures_total")
            if not watchdog.fired:
                self.breaker.record_failure()
            self._emit_launch_spans(batch, t_launch0, time.monotonic(),
                                    kind, error=repr(e))
            outcome = _outcome_label(e)
            for p in batch:
                self.flight.fail(p.key, e)
                self._count(outcome)
                self._sig_count(sig_str, outcome)
            return
        self._emit_launch_spans(batch, t_launch0, time.monotonic(), kind)
        if not watchdog.fired:
            # a launch that outlived its deadline is a failure even if it
            # returned: a too-slow backend must not reset the breaker
            self.breaker.record_success()
        # the results into the cache and the members' futures, which run
        # the clients' done-callbacks
        with phase("serve.resolve"):
            for p, r in zip(batch, results):
                if kind == "inverse":
                    res = dataclasses.replace(r, content_hash=p.key,
                                              batch_size=len(batch))
                else:
                    u, steps_done = r
                    res = SolveResult(u=u, steps_done=steps_done,
                                      content_hash=p.key,
                                      batch_size=len(batch))
                self.cache.put(p.key, res)
                self.flight.resolve(p.key, res)
                self._count("completed_late" if watchdog.fired
                            else "completed")
                if not watchdog.fired:
                    self._sig_count(sig_str, "completed")
                    self.registry.observe("serve_signature_latency_s",
                                          time.monotonic() - p.enqueued,
                                          signature=sig_str)

    # -- tracing ------------------------------------------------------- #

    def _emit_launch_spans(self, batch, t0: float, t1: float, kind: str,
                           error=None) -> None:
        """One "serve.launch" span per member, the child of that member's
        request span: a launch serves N traces, and each request's
        critical path needs the segment. The engine's launch row flags a
        signature's first launch (its kernels' build and load), which
        the trace CLI buckets as "compile"."""
        if not tracing.enabled():
            return
        attrs = {"occupancy": len(batch)}
        if error is not None:
            attrs["error"] = error
        elif kind != "inverse" and self.engine.launch_log:
            row = self.engine.launch_log[-1]
            attrs.update(capacity=row["capacity"],
                         first_launch=row.get("first_launch", False))
        for p in batch:
            tracing.emit("serve.launch", t0, t1, kind="launch",
                         parent=request_trace(p.req), **attrs)

    # -- metrics ------------------------------------------------------- #

    def _sig_count(self, sig_str: str, outcome: str) -> None:
        self.registry.counter("serve_signature_requests_total",
                              signature=sig_str, outcome=outcome)

    def _count(self, outcome: str) -> None:
        self.registry.counter("serve_requests_total", outcome=outcome)

    def _latency(self, t0: float) -> None:
        self.registry.observe("serve_e2e_latency_s", time.monotonic() - t0)


class Client:
    """Synchronous client for tests and the CLI: requests as
    ``SolveRequest`` objects or keyword fields."""

    def __init__(self, server: SolveServer):
        self.server = server

    def solve(self, req: Optional[SolveRequest] = None,
              timeout: Optional[float] = None, **fields) -> SolveResult:
        return self.server.solve(_request(req, fields), timeout=timeout)

    def submit(self, req: Optional[SolveRequest] = None,
               timeout: Optional[float] = None, **fields) -> Future:
        return self.server.submit(_request(req, fields), timeout=timeout)


def _request(req, fields) -> SolveRequest:
    if req is None:
        return SolveRequest.from_dict(fields)
    if fields:
        raise ValueError("pass a SolveRequest or fields, not both")
    return req


def _outcome_label(exc: BaseException) -> str:
    """A structured ``Rejected`` keeps its code: it is an answer, not an
    error."""
    return ("rejected_" + exc.code if isinstance(exc, Rejected)
            else "error")


def _outcome_of(f: Future) -> str:
    """The span outcome label of a resolved future."""
    exc = f.exception()
    if exc is None:
        return "completed"
    return _outcome_label(exc)


def _failed(exc: BaseException) -> Future:
    fut = Future()
    fut.set_exception(exc)
    return fut


#: public alias: the fleet router shares the same failure path
failed_future = _failed


def coalesced_future(leader: Future) -> Future:
    """A single-flight follower's future: the leader's result relabeled
    ``coalesced=True`` (the grid is shared, not copied); the leader's
    failure propagates as it is."""
    out = Future()

    def _relabel(f: Future) -> None:
        exc = f.exception()
        if exc is not None:
            out.set_exception(exc)
        else:
            out.set_result(dataclasses.replace(f.result(), coalesced=True))

    leader.add_done_callback(_relabel)
    return out
