"""Content-addressed result cache + single-flight deduplication: the
port's copy of ``heat2d_tpu/serve/cache.py``.

The cache is a bounded LRU keyed by the request's ``content_hash()`` (a
``SolveRequest``'s or an ``InverseRequest``'s; their results both
implement ``as_cache_hit``):
identical repeat requests return the stored result without touching the
queue (bitwise-identical — the stored grid IS the cold solve's output,
never recomputed). Single-flight covers the window BEFORE a result
exists: identical requests already in flight coalesce onto the leader's
future, so N duplicates cost one compute and one cache fill.

Metrics (``obs/metrics.py`` registry, optional): ``serve_cache_hits_total``,
``serve_cache_misses_total``, ``serve_cache_evictions_total`` counters,
``serve_cache_size`` / ``serve_cache_hit_rate`` gauges,
``serve_coalesced_total`` counter. The fleet router's shared cache and
single-flight take the same classes under their own names (``prefix=
"fleet_cache"``, ``counter="fleet_coalesced_total"``).
"""

from __future__ import annotations

import collections
from concurrent.futures import Future
from typing import Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock, guarded_by


@guarded_by("_lock", "hits", "misses", "evictions")
class ResultCache:
    """Bounded LRU over content hashes. Thread-safe: admission runs on
    caller threads, fills on the scheduler thread."""

    def __init__(self, capacity: int = 256, registry=None,
                 prefix: str = "serve_cache"):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self.registry = registry
        self.prefix = prefix
        self._lock = AuditedLock(prefix)
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                value = self._data[key]
            else:
                self.misses += 1
                value = None
        self._record(hit=value is not None)
        return value

    def put(self, key: str, value) -> None:
        if self.capacity == 0:
            return
        evicted = 0
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evicted += 1
            self.evictions += evicted
        if evicted and self.registry is not None:
            self.registry.counter(self.prefix + "_evictions_total", evicted)
        self._record()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def _record(self, hit: Optional[bool] = None) -> None:
        r = self.registry
        if r is None:
            return
        if hit is True:
            r.counter(self.prefix + "_hits_total")
        elif hit is False:
            r.counter(self.prefix + "_misses_total")
        r.gauge(self.prefix + "_size", len(self))
        total = self.hits + self.misses
        if total:
            r.gauge(self.prefix + "_hit_rate", self.hits / total)


class SingleFlight:
    """In-flight deduplication: the first caller for a key becomes the
    LEADER and owns the returned Future; later callers for the same key
    (while it is unresolved) get the SAME Future back. Coalesced
    requests share the leader's fate — result or rejection."""

    def __init__(self, registry=None, counter: str = "serve_coalesced_total"):
        self._lock = AuditedLock("single_flight")
        self._inflight: dict = {}
        self.registry = registry
        self._counter = counter

    def claim(self, key: str):
        """(future, leader): ``leader`` is True when this caller must
        actually perform the work and later call ``resolve``/``fail``."""
        with self._lock:
            fut = self._inflight.get(key)
            if fut is not None:
                if self.registry is not None:
                    self.registry.counter(self._counter)
                return fut, False
            fut = Future()
            self._inflight[key] = fut
            return fut, True

    def _pop(self, key: str) -> Optional[Future]:
        with self._lock:
            return self._inflight.pop(key, None)

    def resolve(self, key: str, value) -> None:
        fut = self._pop(key)
        if fut is not None and not fut.done():
            fut.set_result(value)

    def fail(self, key: str, exc: BaseException) -> None:
        fut = self._pop(key)
        if fut is not None and not fut.done():
            fut.set_exception(exc)

    def __len__(self) -> int:
        with self._lock:
            return len(self._inflight)
