"""Async request queue + shape-bucketed micro-batching scheduler: the
port's copy of ``heat2d_tpu/serve/batcher.py``.

Admission puts each request into the bucket of its compiled signature
(``SolveRequest.signature()`` — shape/dtype/steps-class/method — or
``InverseRequest.signature()``, whose leading "inverse" keeps its
buckets apart; the batcher reads nothing else of a request). A
single scheduler thread dispatches a bucket as ONE downstream launch
when it reaches ``max_batch`` members or its oldest member has waited
``max_delay`` seconds — the classic latency/occupancy trade of an
inference micro-batcher: ``max_delay`` bounds the latency a lone
request pays, ``max_batch`` bounds the work one launch amortizes.

Admission control:
- queue depth limit (``max_queue``, across all buckets): excess load is
  SHED at submit time with a structured ``Rejected("queue_full")`` —
  the caller hears immediately instead of timing out deep in a queue;
- per-request timeout: a request whose deadline passes while queued is
  rejected ``Rejected("timeout")`` by the scheduler, never dispatched.

The scheduler thread is the only consumer; submission is thread-safe
from any number of producers (the "async" front half — a
``concurrent.futures.Future`` per request, awaitable from asyncio via
``asyncio.wrap_future``).

Metrics: ``serve_queue_depth`` gauge, ``serve_queue_wait_s`` histogram
(admission -> dispatch, the time-to-first-dispatch), ``serve_batch_
occupancy`` / ``serve_batch_fill`` histograms, ``serve_dispatch_total``
and ``serve_rejected_total{reason}`` counters.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import TYPE_CHECKING, Callable, Optional, Union

from heat2d_tpu_torch.analysis.locks import AuditedCondition, guarded_by
from heat2d_tpu_torch.obs import tracing
from heat2d_tpu_torch.serve.schema import (Rejected, SolveRequest,
                                           request_trace)

#: What the batcher queues: a solve or an inverse request
#: (``heat2d_tpu_torch/diff/serving.py``), both with ``signature()``.
Request = Union[SolveRequest, "InverseRequest"]

if TYPE_CHECKING:
    from heat2d_tpu_torch.diff.serving import InverseRequest

log = logging.getLogger("heat2d_tpu_torch.serve")


class Pending:
    """One queued request: the admission-time context the scheduler
    needs — bucket key, deadline, and the failure hook that rejects the
    caller's future."""

    __slots__ = ("req", "key", "enqueued", "deadline", "fail")

    def __init__(self, req: Request, key: str,
                 fail: Callable[[BaseException], None],
                 timeout: Optional[float], now: float):
        self.req = req
        self.key = key
        self.fail = fail
        self.enqueued = now
        self.deadline = None if timeout is None else now + timeout


@guarded_by("_cond", "_depth", "_running", "_draining")
class MicroBatcher:
    """The queue + scheduler. ``dispatch(signature, pendings)`` runs on
    the scheduler thread and must deliver/fail every pending it is
    handed (``serve/server.py`` wires it to the ensemble engine)."""

    def __init__(self, dispatch: Callable, *, max_batch: int = 8,
                 max_delay: float = 0.005, max_queue: int = 256,
                 registry=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {max_delay}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._dispatch = dispatch
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.max_queue = max_queue
        self.registry = registry
        self._cond = AuditedCondition("serve.batcher")
        #: signature -> FIFO of Pending (insertion order = arrival order)
        self._buckets: "collections.OrderedDict" = collections.OrderedDict()
        self._depth = 0
        self._running = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> None:
        with self._cond:
            if self._running:
                return
            if self._thread is not None and self._thread.is_alive():
                # The previous scheduler is still inside a dispatch
                # (stop() timed out waiting for it); a second consumer
                # over the same buckets would double-pop and corrupt
                # _depth.
                raise RuntimeError(
                    "scheduler thread from a previous start() is still "
                    "finishing a dispatch; retry stop()/start() later")
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="heat2d-torch-serve-batcher",
                                        daemon=True)
        self._thread.start()

    def stop(self, drain: bool = False) -> None:
        """Stop the scheduler. Default: anything still queued is
        rejected with ``Rejected("shutdown")`` (callers must not hang
        forever on a future nobody will fill).

        ``drain=True`` is the graceful path rolling worker restarts
        need: admission closes immediately (new submits reject), but
        the scheduler keeps dispatching — partial buckets flush without
        waiting out ``max_delay`` — until the queue is EMPTY, and only
        then exits. Because dispatch runs synchronously on the
        scheduler thread, when ``stop(drain=True)`` returns every
        admitted request has been resolved or failed; none were
        dropped."""
        with self._cond:
            if drain and self._running:
                self._draining = True
            else:
                self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
        with self._cond:
            self._running = False
            self._draining = False
        if self._thread is not None:
            if self._thread.is_alive():
                # A wedged dispatch: keep the handle so start() refuses
                # to spawn a concurrent consumer next to it.
                log.warning("scheduler thread did not exit within 60s; "
                            "a dispatch is still in flight")
            else:
                self._thread = None
        leftovers = []
        with self._cond:
            for q in self._buckets.values():
                leftovers.extend(q)
            self._buckets.clear()
            self._depth = 0
        for p in leftovers:
            self._reject(p, Rejected("shutdown", "server stopping",
                                     content_hash=p.key))
        self._gauge_depth()

    # -- admission ----------------------------------------------------- #

    def submit(self, req: Request, key: str,
               fail: Callable[[BaseException], None],
               timeout: Optional[float] = None) -> None:
        """Admit one request, or raise ``Rejected("queue_full")`` /
        ``Rejected("shutdown")`` — load shedding happens HERE, at the
        door, not after a queue wait."""
        now = time.monotonic()
        p = Pending(req, key, fail, timeout, now)
        with self._cond:
            if not self._running or self._draining:
                raise Rejected(
                    "shutdown",
                    "server draining" if self._draining
                    else "server not running", content_hash=key)
            if self._depth >= self.max_queue:
                if self.registry is not None:
                    self.registry.counter("serve_rejected_total",
                                          reason="queue_full")
                raise Rejected(
                    "queue_full",
                    f"queue depth {self._depth} at limit "
                    f"{self.max_queue}", content_hash=key)
            sig = req.signature()
            if sig not in self._buckets:
                self._buckets[sig] = collections.deque()
            self._buckets[sig].append(p)
            self._depth += 1
            self._cond.notify_all()
        self._gauge_depth()

    def depth(self) -> int:
        with self._cond:
            return self._depth

    # -- scheduler ----------------------------------------------------- #

    def _loop(self) -> None:
        while True:
            expired, batch, sig = [], None, None
            with self._cond:
                if not self._running:
                    return
                if self._draining and self._depth == 0:
                    self._running = False
                    return              # drained dry: a clean exit
                now = time.monotonic()
                expired = self._pop_expired_locked(now)
                sig, batch = self._pop_ready_locked(
                    now, drain=self._draining)
                if not expired and batch is None:
                    self._cond.wait(timeout=self._wake_in_locked(now))
                    continue
            for p in expired:
                self._reject(p, Rejected(
                    "timeout", "request timed out in queue",
                    content_hash=p.key,
                    waited_s=round(time.monotonic() - p.enqueued, 6)))
            if batch is not None:
                self._gauge_depth()
                self._record_batch(sig, batch)
                try:
                    self._dispatch(sig, batch)
                except BaseException as e:  # noqa: BLE001 — must not
                    #                         kill the scheduler thread
                    for p in batch:
                        self._reject(p, e)

    def _pop_expired_locked(self, now: float) -> list:
        out = []
        for sig in list(self._buckets):
            q = self._buckets[sig]
            keep, dead = collections.deque(), []
            for p in q:
                if p.deadline is not None and p.deadline <= now:
                    dead.append(p)
                else:
                    keep.append(p)
            if dead:
                out.extend(dead)
                if keep:
                    self._buckets[sig] = keep
                else:
                    del self._buckets[sig]
        self._depth -= len(out)
        return out

    def _pop_ready_locked(self, now: float, drain: bool = False):
        """Of the buckets that are full or whose oldest member aged past
        max_delay, the one with the OLDEST head dispatches first — never
        the first-inserted: a sustained hot signature keeps its bucket
        position while non-empty, and insertion-order service would
        starve every other bucket into timeout. Pops up to max_batch.
        While draining, every non-empty bucket is ready — nothing new
        can arrive, so aging a partial batch only delays shutdown."""
        pick = None
        for sig, q in self._buckets.items():
            if (drain or len(q) >= self.max_batch
                    or q[0].enqueued + self.max_delay <= now):
                if pick is None or q[0].enqueued < \
                        self._buckets[pick][0].enqueued:
                    pick = sig
        if pick is None:
            return None, None
        q = self._buckets[pick]
        batch = [q.popleft() for _ in range(min(len(q), self.max_batch))]
        if not q:
            del self._buckets[pick]
        self._depth -= len(batch)
        return pick, batch

    def _wake_in_locked(self, now: float) -> Optional[float]:
        """Sleep until the earliest dispatch-or-deadline event."""
        wake = None
        for q in self._buckets.values():
            t = q[0].enqueued + self.max_delay
            wake = t if wake is None else min(wake, t)
            for p in q:
                if p.deadline is not None:
                    wake = min(wake, p.deadline)
        return None if wake is None else max(0.0, wake - now)

    # -- bookkeeping --------------------------------------------------- #

    def _reject(self, p: Pending, exc: BaseException) -> None:
        if self.registry is not None:
            # queue_full is counted at the door (submit), not here.
            reason = (exc.code if isinstance(exc, Rejected) else "error")
            if reason != "queue_full":
                self.registry.counter("serve_rejected_total",
                                      reason=reason)
        try:
            p.fail(exc)
        except Exception:   # a broken callback must not stall the loop
            pass

    def _gauge_depth(self) -> None:
        if self.registry is not None:
            self.registry.gauge("serve_queue_depth", self.depth())

    def _record_batch(self, sig, batch) -> None:
        now = time.monotonic()
        if tracing.enabled():
            # the queue wait, stamped admission -> dispatch here on the
            # scheduler thread (known finished: tracing.emit)
            for p in batch:
                tracing.emit("serve.queue", p.enqueued, now,
                             kind="queue", parent=request_trace(p.req),
                             signature=str(sig))
        r = self.registry
        if r is None:
            return
        r.counter("serve_dispatch_total")
        r.observe("serve_batch_occupancy", len(batch))
        r.observe("serve_batch_fill", len(batch) / self.max_batch)
        for p in batch:
            r.observe("serve_queue_wait_s", now - p.enqueued)
