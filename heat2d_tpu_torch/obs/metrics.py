"""Process-local metrics registry: counters, gauges, timing histograms
and (x, y) point series, each labeled, with JSONL and Prometheus-text
exports. The port's copy of ``heat2d_tpu/obs/metrics.py``: its structured
events, its structured lookups (``find_histograms`` and the rest, which
``obs/slo.py`` reads), its aggregate over processes; the metric names are
the JAX package's (``docs/SERVING.md``, ``docs/RESILIENCE.md``). Fed the
same observations, both registries give the same summaries and the same
Prometheus text.

Pure host-side Python: recording a metric never touches a tensor.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import random
import re
import threading
import time

#: histogram sample cap: below it quantiles are exact; above it the
#: reservoir keeps a uniform sample (Algorithm R) while count/sum/min/
#: max/mean stay exact.
HIST_RESERVOIR_CAP = 4096


def _utc_now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _PROM_NAME.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def _prom_value(v: str) -> str:
    """Escape a label value per the Prometheus text-format spec."""
    return (v.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_prom_value(v)}"'
                     for k, v in labels)
    return "{" + inner + "}"


def quantile(sorted_samples: list, q: float) -> float:
    """Nearest-rank quantile of an already-sorted sample list."""
    if not sorted_samples:
        return float("nan")
    i = max(0, math.ceil(q * len(sorted_samples)) - 1)
    return float(sorted_samples[i])


class Reservoir:
    """Bounded histogram storage: exact count/sum/min/max; the samples
    exactly up to ``cap``, then a uniform reservoir (deterministically
    seeded, so two registries fed one stream summarize alike)."""

    __slots__ = ("cap", "count", "sum", "min", "max", "samples", "_rng")

    def __init__(self, cap: int = HIST_RESERVOIR_CAP):
        self.cap = cap
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.samples: list = []
        self._rng = random.Random(0x1612)

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.samples) < self.cap:
            self.samples.append(v)
        else:
            i = self._rng.randrange(self.count)
            if i < self.cap:
                self.samples[i] = v

    def exact(self) -> bool:
        """True while quantiles are exact (no sample was evicted)."""
        return self.count <= self.cap

    def summary(self) -> dict:
        s = sorted(self.samples)
        return {
            "count": self.count,
            "sum": float(self.sum),
            "min": float(self.min),
            "max": float(self.max),
            "mean": (float(self.sum / self.count) if self.count
                     else float("nan")),
            "p50": quantile(s, 0.50),
            "p90": quantile(s, 0.90),
            "p99": quantile(s, 0.99),
        }


class CounterDeltas:
    """Cumulative counters differentiated between calls:
    ``tick(registry, name)`` returns {label-pairs tuple: delta since the
    previous tick} per series (the first tick sees the whole value). A
    negative delta means the registry was swapped, and that series
    resets to its new total."""

    def __init__(self):
        self._last: dict = {}

    def tick(self, registry, name: str) -> dict:
        out = {}
        for k, v in registry.find_counters(name).items():
            key = (name, k)
            d = v - self._last.get(key, 0.0)
            self._last[key] = v
            out[k] = d if d >= 0 else v
        return out


class MetricsRegistry:
    """Counters, gauges, timing histograms and point series, each
    identified by (name, labels) as in Prometheus. Thread-safe: the serve
    scheduler and submitting threads record concurrently."""

    def __init__(self, hist_cap: int = HIST_RESERVOIR_CAP):
        self._lock = threading.Lock()
        self._hist_cap = hist_cap
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}
        self._series: dict = {}
        self._events: list = []

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        """Monotonically add ``value`` to the counter."""
        k = (name, _label_key(labels))
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set the gauge to the latest ``value``."""
        with self._lock:
            self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Add one sample to the (timing) histogram."""
        k = (name, _label_key(labels))
        with self._lock:
            r = self._histograms.get(k)
            if r is None:
                r = self._histograms[k] = Reservoir(self._hist_cap)
            r.add(float(value))

    def series(self, name: str, x, y, **labels) -> None:
        """Append the point (x, y) to a labeled series, e.g. an inverse
        solve's loss per iteration."""
        k = (name, _label_key(labels))
        with self._lock:
            self._series.setdefault(k, []).append((x, y))

    def event(self, kind: str, **fields) -> None:
        """Append a structured event (e.g. ``run_start``) to the log that
        ``write_jsonl`` writes before the snapshot."""
        with self._lock:
            self._events.append(
                {"event": kind, "ts": _utc_now_iso(), **fields})

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    @contextlib.contextmanager
    def timer(self, name: str, **labels):
        """Time the enclosed block into the ``name`` histogram (seconds)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0, **labels)

    @staticmethod
    def _fmt(key: tuple) -> str:
        name, labels = key
        if not labels:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

    def find_histograms(self, name: str) -> dict:
        """{label-pairs tuple: summary} for every series of ``name`` (the
        structured accessor: snapshot keys flatten labels into strings,
        which is ambiguous for label values holding commas, such as
        signature tuples)."""
        with self._lock:
            return {k[1]: v.summary() for k, v in self._histograms.items()
                    if k[0] == name}

    def find_counters(self, name: str) -> dict:
        """{label-pairs tuple: value} for every series of ``name``."""
        with self._lock:
            return {k[1]: v for k, v in self._counters.items()
                    if k[0] == name}

    def find_gauges(self, name: str) -> dict:
        """{label-pairs tuple: value} for every series of ``name``."""
        with self._lock:
            return {k[1]: v for k, v in self._gauges.items()
                    if k[0] == name}

    def snapshot(self) -> dict:
        """Point-in-time view: counters and gauges flat, histograms
        summarized, series as point lists."""
        with self._lock:
            return {
                "counters": {self._fmt(k): v
                             for k, v in self._counters.items()},
                "gauges": {self._fmt(k): v
                           for k, v in self._gauges.items()},
                "histograms": {self._fmt(k): v.summary()
                               for k, v in self._histograms.items()},
                "series": {self._fmt(k): [[x, y] for x, y in v]
                           for k, v in self._series.items()},
            }

    def aggregate_multihost(self) -> dict:
        """Counters and gauges over the processes of a world: rank-max,
        rank-mean and rank-min of each (the JAX package's
        ``aggregate_multihost``; one process gives its own values in the
        same shape). A collective in a world: every process calls it with
        the same metric names, taken in sorted order."""
        from heat2d_tpu_torch.utils.timing import gather_over_processes

        with self._lock:
            scalars = {**{("counter",) + k: v
                          for k, v in self._counters.items()},
                       **{("gauge",) + k: v
                          for k, v in self._gauges.items()}}
        out = {}
        for k in sorted(scalars):
            col = gather_over_processes(scalars[k])
            out[self._fmt(k[1:])] = {"rank_max": max(col),
                                     "rank_mean": sum(col) / len(col),
                                     "rank_min": min(col)}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition: counters, gauges, and each
        histogram as a summary (its exact running ``_sum``/``_count`` and
        one ``{quantile="..."}`` line for p50, p90 and p99)."""
        lines = []
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (v.sum, v.count, sorted(v.samples))
                     for k, v in self._histograms.items()}
        seen = set()

        def typ(name, kind):
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for (name, labels), v in sorted(counters.items()):
            n = _prom_name(name)
            typ(n, "counter")
            lines.append(f"{n}{_prom_labels(labels)} {v}")
        for (name, labels), v in sorted(gauges.items()):
            n = _prom_name(name)
            typ(n, "gauge")
            lines.append(f"{n}{_prom_labels(labels)} {v}")
        for (name, labels), (total, count, samples) in sorted(
                hists.items()):
            n = _prom_name(name)
            typ(n, "summary")
            lines.append(f"{n}_sum{_prom_labels(labels)} {float(total)}")
            lines.append(f"{n}_count{_prom_labels(labels)} {count}")
            for q in (0.5, 0.9, 0.99):
                ql = labels + (("quantile", f"{q}"),)
                lines.append(f"{n}{_prom_labels(ql)} "
                             f"{quantile(samples, q)}")
        return "\n".join(lines) + "\n"

    def write_jsonl(self, path: str, extra_records=()) -> None:
        """The events, a ``snapshot`` line, then any caller-supplied
        records (e.g. the run record), committed atomically (tmp + fsync +
        ``os.replace``)."""
        from heat2d_tpu_torch.io.binary import write_text_atomic

        lines = [json.dumps(ev) for ev in self.events()]
        lines.append(json.dumps({"event": "snapshot", "ts": _utc_now_iso(),
                                 **self.snapshot()}))
        lines.extend(json.dumps(rec) for rec in extra_records)
        write_text_atomic("\n".join(lines) + "\n", path)


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry."""
    return _default_registry


def reset_registry() -> MetricsRegistry:
    """A fresh default registry (test isolation); returns it."""
    global _default_registry
    _default_registry = MetricsRegistry()
    return _default_registry
