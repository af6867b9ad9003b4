"""Retry, watchdog and degraded mode for the serving path: the port's copy
of ``heat2d_tpu/resil/retry.py``.

- ``RetryPolicy`` + ``call_with_retries``: capped exponential backoff for
  transient failures. A structured ``Rejected`` is an answer, not a
  fault, and is never retried; nor is a programming error. With
  ``jitter=True`` the sleep is drawn uniform below its cap (full
  jitter), which the fleet supervisor's restarts take so that workers
  killed by one fault come back apart.
- ``Watchdog``: a deadline on a block of work; on expiry it fires a
  callback (the server fails the waiting futures with
  ``Rejected("watchdog_timeout")``) instead of letting callers hang.
- ``wait_for``: the bounded poll on a ``Watchdog`` (the mesh stall
  guard's deadline).
- ``DegradedMode``: a consecutive-failure circuit breaker (closed ->
  open -> half-open). While open, fresh work is shed at admission and
  cached answers are still served.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable, Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock
from heat2d_tpu_torch.resil.chaos import ChaosError

log = logging.getLogger("heat2d_tpu_torch.resil")


class TransientError(RuntimeError):
    """Marker for failures a caller knows to be retry-safe."""


def default_transient(exc: BaseException) -> bool:
    """Injected chaos, explicit transients, OS/IO errors and timeouts are
    transient. The JAX package also retries XLA's runtime errors by class
    name; PyTorch has no counterpart class: a failed CUDA launch reaches
    the port as the ``RuntimeError`` its kernel wrapper raises, which
    cannot be told apart from a programming error, so it is terminal."""
    return isinstance(exc, (ChaosError, TransientError, OSError,
                            TimeoutError))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry i (0-based) sleeps ``cap_i = min(base_delay * backoff**i,
    max_delay)``; with ``jitter=True`` a draw uniform over ``[0, cap_i)``
    from ``rng`` (a seeded ``random.Random`` in tests) or the module's."""

    max_attempts: int = 3       # total tries, including the first
    base_delay: float = 0.05
    backoff: float = 2.0
    max_delay: float = 2.0
    jitter: bool = False

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")

    def cap(self, retry_index: int) -> float:
        """The ceiling of retry ``retry_index``'s sleep; ``backoff ** i``
        may overflow a float for a long-lived caller, and the cap wins
        there."""
        try:
            d = self.base_delay * self.backoff ** retry_index
        except OverflowError:
            return self.max_delay
        return min(d, self.max_delay)

    def delay(self, retry_index: int,
              rng: Optional[random.Random] = None) -> float:
        d = self.cap(retry_index)
        if not self.jitter:
            return d
        return d * (rng if rng is not None else random).random()


def call_with_retries(fn: Callable, policy: RetryPolicy, *,
                      on_retry: Optional[Callable] = None,
                      sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` under ``policy``: non-transient failures
    (``default_transient``) propagate at once; transients retry until the
    attempts run out, then the last one propagates. ``on_retry(retry_index,
    exc)`` fires before each sleep."""
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            if (attempt == policy.max_attempts - 1
                    or not default_transient(e)):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            d = policy.delay(attempt)
            log.warning("transient failure (attempt %d/%d), retrying in "
                        "%.3fs: %r", attempt + 1, policy.max_attempts, d, e)
            sleep(d)
    raise AssertionError("unreachable")


class Watchdog:
    """``with Watchdog(2.0, on_timeout): work()``: if ``work`` outlives
    the deadline, ``on_timeout()`` fires once from a timer thread (the
    block keeps running; its waiters get an answer instead of a hang).
    ``fired`` says whether it did. ``deadline_s=None`` arms nothing.

    ``clock`` (a ``time.monotonic``-shaped callable) makes the deadline
    controllable: a watcher thread polls it every 5 ms of real time in
    place of a wall-clock timer, so a test can hold time still and
    advance it past the deadline exactly when its scenario says."""

    _POLL_S = 0.005

    def __init__(self, deadline_s: Optional[float],
                 on_timeout: Callable[[], None],
                 clock: Optional[Callable[[], float]] = None):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self.clock = clock
        self.fired = False
        self._timer: Optional[threading.Timer] = None
        self._stop: Optional[threading.Event] = None

    def _fire(self) -> None:
        self.fired = True
        try:
            self.on_timeout()
        except Exception:   # a broken callback must not kill the timer
            log.exception("watchdog on_timeout callback failed")

    def _watch(self, t0: float) -> None:
        while not self._stop.wait(self._POLL_S):
            if self.clock() - t0 >= self.deadline_s:
                self._fire()
                return

    def __enter__(self) -> "Watchdog":
        if self.deadline_s is None:
            return self
        if self.clock is None:
            self._timer = threading.Timer(self.deadline_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        else:
            self._stop = threading.Event()
            threading.Thread(target=self._watch, args=(self.clock(),),
                             name="heat2d-watchdog", daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        if self._timer is not None:
            self._timer.cancel()
        if self._stop is not None:
            self._stop.set()


def wait_for(predicate: Callable[[], bool],
             deadline_s: Optional[float], *,
             clock: Optional[Callable[[], float]] = None,
             poll: float = 0.01,
             sleep: Callable[[float], None] = time.sleep) -> bool:
    """Poll ``predicate`` until it is truthy (True) or ``deadline_s``
    expires on ``clock`` (False), on a ``Watchdog`` so that an injected
    clock controls the deadline. ``deadline_s=None`` waits forever."""
    if predicate():
        return True
    wd = Watchdog(deadline_s, lambda: None, clock=clock)
    with wd:
        while not wd.fired:
            if predicate():
                return True
            sleep(poll)
    # completion wins a race with the deadline in the same poll window
    return bool(predicate())


class DegradedMode:
    """Consecutive-failure circuit breaker. ``allow()`` is True while
    CLOSED, False while OPEN; after ``cooldown`` seconds one caller gets
    True as the HALF-OPEN probe, and its ``record_success`` closes the
    breaker or its ``record_failure`` re-opens it. A probe that never
    reports expires after one more cooldown."""

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 registry=None, clock: Callable[[], float] = time.monotonic,
                 metric_prefix: str = "serve"):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown = cooldown
        self.registry = registry
        #: the metric family's prefix (``fleet`` for the fleet router's
        #: breaker: ``fleet_degraded``, ``fleet_breaker_trips_total``)
        self.metric_prefix = metric_prefix
        self._clock = clock
        self._lock = AuditedLock("resil.degraded")
        self._failures = 0          # consecutive
        self._opened_at: Optional[float] = None
        self._probing = False
        self._probe_at: Optional[float] = None
        self.trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._probing or \
                self._clock() - self._opened_at >= self.cooldown:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        with self._lock:
            s = self._state_locked()
            if s == "closed":
                return True
            if s == "open":
                return False
            now = self._clock()
            if (self._probing and self._probe_at is not None
                    and now - self._probe_at < self.cooldown):
                return False    # a live probe holds the token
            self._probing = True
            self._probe_at = now
            self._gauge_locked()
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False
            self._gauge_locked()

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            reopen = self._probing
            self._probing = False
            if reopen or self._failures >= self.threshold:
                if self._opened_at is None:
                    self.trips += 1
                    log.warning("degraded mode tripped after %d "
                                "consecutive failures (cooldown %.1fs)",
                                self._failures, self.cooldown)
                    if self.registry is not None:
                        self.registry.counter(
                            self.metric_prefix + "_breaker_trips_total")
                self._opened_at = self._clock()
            self._gauge_locked()

    def _gauge_locked(self) -> None:
        if self.registry is not None:
            self.registry.gauge(self.metric_prefix + "_degraded",
                                0.0 if self._opened_at is None else 1.0)
