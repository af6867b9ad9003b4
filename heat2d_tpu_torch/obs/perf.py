"""The performance observatory: cost cards, duty-cycle sampling and the
online anomaly sentinel (the port's counterpart of
``heat2d_tpu/obs/perf.py``, with its schema and card keys).

- **Cost cards** (``extract_cost_card`` / ``PerfObserver``): at a
  launch's first run per (signature, capacity, route), one card of what
  that launch is: FLOPs and device-memory bytes from ``obs/roofline``'s
  model at the launch's tile or resident plan (``plan``, ``kernel``),
  argument and output bytes from the operand and result tensors, temp
  and peak bytes from ``torch.cuda.max_memory_allocated`` around that
  first launch (the resident sweep's exchange planes show there), and the
  registers and local (spill) bytes a thread of the kernel's build
  (``cudaFuncGetAttributes``, where the build has a query: H1-H7, H9).
  The JAX card reads XLA's cost and memory analyses of a compiled
  program; the port has no compiled program to ask, so the XLA-only
  fields (``generated_code_bytes``, the model's ``hlo_bytes_per_cell``)
  are None. Extraction failure is counted
  (``perf_card_failures_total{stage}``) and never raised.
- **Duty-cycle sampler** (``DutyCycleSampler``): a background thread fed
  by the tracer's span stream (``tracing.add_span_tap``) integrating
  closed launch-span intervals over a sliding window per (service, pid)
  lane: the live "how busy is each lane" gauge.
- **Anomaly sentinel** (``AnomalySentinel``): EWMA + MAD per (signature,
  metric) over windowed request rate, windowed mean latency, cumulative
  p99 and roofline fraction; a finding needs ``sustain`` consecutive
  anomalous windows, and a zero-traffic window is no evidence.

Armed by ``install(PerfObserver(...))``, ``HEAT2D_PERF_DIR`` (cards
persisted there, the file ``heat2d-tpu-torch-trace --stats`` joins on) or
``HEAT2D_PERF=1`` (in memory): the JAX package's names. Off, the launch
path pays one ``enabled()`` check.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock, guarded_by

log = logging.getLogger("heat2d_tpu_torch.obs")

PERF_SCHEMA = "heat2d-tpu/cost-card/v1"

#: extraction failure placeholder cached in the card book so a launch
#: key that cannot be carded is probed once, not per launch
_FAILED = object()


def _nbytes(tree) -> int:
    """Bytes of every tensor in a (nested) tuple of results."""
    from heat2d_tpu_torch.utils.timing import _leaves
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


class LaunchWatch:
    """Device memory around one launch: ``torch.cuda``'s peak counter
    reset and the allocated bytes noted before it (after its operands
    exist), so that the peak above that baseline after it is what the
    launch allocated (its results and its scratch). Nothing to watch on
    the CPU: ``extra_bytes`` is None there."""

    def __init__(self, device):
        import torch
        self.device = torch.device(device)
        self.baseline = None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self.baseline = torch.cuda.memory_allocated(self.device)

    def extra_bytes(self) -> Optional[int]:
        import torch
        if self.baseline is None:
            return None
        return torch.cuda.max_memory_allocated(self.device) - self.baseline


def kernel_attrs(kernel: Optional[str], meta: dict, device) -> Optional[dict]:
    """Registers and local bytes a thread of the launch's hand kernel on
    the card (None on the CPU, off the hand kernels, and for H8, whose
    build has no query)."""
    import torch
    if kernel is None or torch.device(device).type != "cuda":
        return None
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    conv = bool(meta.get("convergence"))
    if kernel == "H2/H3":
        return cs.func_attrs("tile_multi_resid" if conv else "tile_multi")
    if kernel == "H4":
        return cs.func_attrs("resident")
    if kernel == "H5":
        return ce.func_attrs("ens_resident")
    if kernel == "H6/H7":
        return ce.func_attrs("ens_tile_multi_conv" if conv
                             else "ens_tile_multi")
    if kernel == "H9":
        from heat2d_tpu_torch.ops import cuda_family as cf
        problem = meta["problem"]
        info = cf.tile_info(problem, cf.tile_plan(
            meta["nx"], meta["ny"], problem, device,
            cf.SWEEP_TSTEPS[problem]))
        return {"registers": info["registers"],
                "local_bytes": info["local_bytes"]}
    return None


def extract_cost_card(runner, args, *, meta: dict, registry=None,
                      outputs=None,
                      watch: Optional[LaunchWatch] = None) -> Optional[dict]:
    """One cost card of a launch: ``runner`` ran ``args`` (its operand
    tensors, the batch first) into ``outputs``; ``meta`` names it
    (signature, nx, ny, steps, method, convergence, capacity, dtype,
    problem, route; ``model_method`` overrides the method the byte model
    resolves, as the mesh's spatial route runs the golden loop: "jnp");
    ``watch`` is the ``LaunchWatch`` taken just before it. Returns None
    (never raises) when the card cannot be made, counted as
    ``perf_card_failures_total{stage}``."""
    def _fail(stage: str, err) -> None:
        if registry is not None:
            registry.counter("perf_card_failures_total", stage=stage)
        log.debug("cost-card extraction failed at %s: %s", stage, err)

    from heat2d_tpu_torch.obs import roofline

    try:
        nx, ny = int(meta["nx"]), int(meta["ny"])
        steps = max(1, int(meta.get("steps") or 1))
        batch = int(meta.get("capacity") or meta.get("batch") or 1)
        dtype = meta.get("dtype", "float32")
        problem = meta.get("problem", "heat5")
        device = args[0].device
        m = roofline.analytic_bytes_per_cell_step(
            nx, ny, method=meta.get("model_method") or meta.get("method",
                                                                "auto"),
            dtype=dtype, problem=problem, steps=steps, batch=batch,
            device=device)
    except Exception as e:  # noqa: BLE001 — observability must not throw
        _fail("model", e)
        return None
    cells = batch * nx * ny
    per_cell = (None if m["coarse"]
                else roofline.FLOPS_PER_CELL_STEP.get(problem))
    flops = None if per_cell is None else float(per_cell) * cells * steps
    bytes_accessed = m["bytes_per_cell_step"] * cells * steps
    arg_b = _nbytes(tuple(args))
    out_b = _nbytes(outputs) if outputs is not None else None
    extra = watch.extra_bytes() if watch is not None else None
    tmp_b = (max(0, extra - (out_b or 0)) if extra is not None else None)
    try:
        attrs = kernel_attrs(m["kernel"], dict(meta, problem=problem),
                             device)
    except Exception as e:  # noqa: BLE001
        _fail("attributes", e)
        attrs = None
    card = {
        "schema": PERF_SCHEMA,
        **meta,
        "backend": device.type,
        "device_kind": roofline.device_kind(device),
        "kernel": m["kernel"],
        "plan": m["model"],
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": tmp_b,
        "peak_bytes": (arg_b + (out_b or 0) + tmp_b
                       if tmp_b is not None else None),
        "registers": attrs["registers"] if attrs else None,
        "local_bytes": attrs["local_bytes"] if attrs else None,
        "generated_code_bytes": None,
        "arithmetic_intensity": (round(flops / bytes_accessed, 4)
                                 if flops and bytes_accessed > 0
                                 else None),
    }
    bb = roofline.boundary_bytes(
        nx, ny, batch=batch, dtype=dtype,
        convergence=bool(meta.get("convergence", False)))
    measured = arg_b + (out_b or 0)
    card["model"] = {
        "boundary_bytes": bb["total_bytes"],
        "measured_boundary_bytes": measured,
        "boundary_agreement_pct": (
            round(100.0 * measured / bb["total_bytes"], 2)
            if bb["total_bytes"] and out_b is not None else None),
        "bytes_per_cell_step": round(m["bytes_per_cell_step"], 4),
        "route": m["route"],
        "coarse": m["coarse"],
        "hlo_bytes_per_cell": None,
    }
    return card


@guarded_by("_lock", "_cards", "_file")
class PerfObserver:
    """The card book: dedup-by-key cost-card extraction at first
    launch, optional JSONL persistence beside the trace spans
    (``cost-cards-<service>-<pid>.jsonl``, the file
    ``heat2d-tpu-torch-trace --stats`` joins on),
    ``perf_cost_cards_total`` accounting."""

    def __init__(self, registry=None, dir: Optional[str] = None,
                 service: str = "perf"):
        self.registry = registry
        self.dir = dir
        self.service = service
        self._lock = AuditedLock("obs.perf.observer")
        self._cards: dict = {}          # key -> card dict | _FAILED
        self._file = None
        if dir:
            os.makedirs(dir, exist_ok=True)
            self._path = os.path.join(
                dir, f"cost-cards-{service}-{os.getpid()}.jsonl")
        else:
            self._path = None

    @staticmethod
    def _key(meta: dict) -> tuple:
        return (meta.get("signature"), meta.get("capacity"),
                meta.get("route"))

    def seen(self, meta: dict) -> bool:
        """Whether (signature, capacity, route) has its card (or its
        cached failure) already."""
        with self._lock:
            return self._key(meta) in self._cards

    def observe(self, runner, args, meta: dict, outputs=None,
                watch: Optional[LaunchWatch] = None) -> Optional[dict]:
        """Card for (signature, capacity, route): cached after the
        first extraction, including cached failure — a launch path
        never pays the probe twice."""
        key = self._key(meta)
        with self._lock:
            hit = self._cards.get(key)
        if hit is not None:
            return None if hit is _FAILED else hit
        card = extract_cost_card(runner, args, meta=meta,
                                 registry=self.registry, outputs=outputs,
                                 watch=watch)
        with self._lock:
            # double-checked: a racing launch may have filled the slot
            hit = self._cards.get(key)
            if hit is not None:
                return None if hit is _FAILED else hit
            self._cards[key] = card if card is not None else _FAILED
        if card is None:
            return None
        if self.registry is not None:
            self.registry.counter("perf_cost_cards_total",
                                  route=str(card.get("route")
                                            or meta.get("route")
                                            or "batch"))
        self._persist(card)
        return card

    def card_for(self, signature, capacity=None,
                 route=None) -> Optional[dict]:
        with self._lock:
            hit = self._cards.get((signature, capacity, route))
        return None if hit is None or hit is _FAILED else hit

    def cards(self) -> list:
        with self._lock:
            return [c for c in self._cards.values()
                    if c is not _FAILED]

    def snapshot(self) -> dict:
        return {"schema": PERF_SCHEMA, "cards": self.cards()}

    def _persist(self, card: dict) -> None:
        if self._path is None:
            return
        line = json.dumps(card) + "\n"
        with self._lock:
            if self._file is None:
                self._file = open(self._path, "a", encoding="utf-8")
            self._file.write(line)
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# -- module-level arming (the tracing.install pattern) ----------------- #

_lock = AuditedLock("obs.perf")
_observer: Optional[PerfObserver] = None
_env_checked = False


def install(obs: PerfObserver) -> None:
    global _observer
    with _lock:
        _observer = obs


def uninstall() -> None:
    global _observer, _env_checked
    with _lock:
        if _observer is not None:
            _observer.close()
        _observer = None
        _env_checked = True     # an explicit uninstall wins over env


def activate_from_env() -> None:
    """Arm from ``HEAT2D_PERF_DIR`` (cards persisted there) or
    ``HEAT2D_PERF=1`` (in-memory book only) — once per process, like
    ``tracing.activate_from_env``."""
    global _env_checked, _observer
    with _lock:
        if _env_checked or _observer is not None:
            return
        _env_checked = True
        d = os.environ.get("HEAT2D_PERF_DIR")
        if not d and os.environ.get("HEAT2D_PERF") != "1":
            return
        from heat2d_tpu_torch.obs.metrics import get_registry
        _observer = PerfObserver(registry=get_registry(),
                                 dir=d or None, service="env")


def enabled() -> bool:
    activate_from_env()
    return _observer is not None


def observer() -> Optional[PerfObserver]:
    activate_from_env()
    return _observer


def launch_watch(meta: dict, device) -> Optional[LaunchWatch]:
    """A ``LaunchWatch`` to take just before a launch whose key has no
    card yet (None when no observer is armed or the key has its card)."""
    obs = observer()
    if obs is None or obs.seen(meta):
        return None
    return LaunchWatch(device)


def observe_launch(runner, args, *, meta: dict, outputs=None,
                   watch: Optional[LaunchWatch] = None) -> Optional[dict]:
    """The launch-path hook: no-op (None) when no observer is armed."""
    obs = observer()
    if obs is None:
        return None
    return obs.observe(runner, args, meta, outputs=outputs, watch=watch)


def card_for(signature, capacity=None, route=None) -> Optional[dict]:
    obs = observer()
    if obs is None:
        return None
    return obs.card_for(signature, capacity, route)


# -- duty-cycle sampler ------------------------------------------------ #

class DutyCycleSampler:
    """Launch-occupancy duty cycle per (service, pid) lane from the
    tracer's span feed.

    Wire it with ``tracing.add_span_tap(sampler.feed)`` and
    ``sampler.start()``. ``feed`` runs on whatever thread emits a span
    — it does ONE kind check and a deque append under the lock.
    Serve launch spans carry epoch t0/t1 and are emitted after the
    launch completes, so each ``_sample`` merges the closed intervals
    that overlap the trailing window (plus any still-open
    ``span_start``) into per-lane busy time / window. Exported as
    ``perf_duty_cycle{lane=...}`` + ``perf_duty_samples_total``."""

    def __init__(self, registry=None, *, window_s: float = 2.0,
                 interval_s: float = 0.25,
                 span_kinds: tuple = ("launch",)):
        self.registry = registry
        self.window_s = float(window_s)
        self.interval_s = float(interval_s)
        self._kinds = frozenset(span_kinds)
        self._lock = AuditedLock("obs.perf.duty")
        self._closed: collections.deque = collections.deque()
        self._open: dict = {}           # span_id -> (t0, lane)
        self._duty: dict = {}           # lane -> last sampled duty
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # the tracer tap — hot-ish path, keep tiny
    def feed(self, rec: dict) -> None:
        if rec.get("kind") not in self._kinds:
            return
        lane = f"{rec.get('service', '?')}:{rec.get('pid', 0)}"
        ev = rec.get("event")
        with self._lock:
            if ev == "span":
                self._open.pop(rec.get("span_id"), None)
                self._closed.append(
                    (float(rec["t0"]), float(rec["t1"]), lane))
            elif ev == "span_start":
                self._open[rec.get("span_id")] = (
                    float(rec["t0"]), lane)

    def _sample(self, now: Optional[float] = None) -> dict:
        # spans carry epoch timestamps (tracing.Tracer.epoch_of)
        now = time.time() if now is None else now
        lo = now - self.window_s
        with self._lock:
            while self._closed and self._closed[0][1] < lo:
                self._closed.popleft()
            spans = list(self._closed)
            spans.extend((t0, now, lane)
                         for t0, lane in self._open.values())
        by_lane: dict = {}
        for t0, t1, lane in spans:
            a, b = max(t0, lo), min(t1, now)
            if b > a:
                by_lane.setdefault(lane, []).append((a, b))
        duty = {}
        for lane, ivals in by_lane.items():
            ivals.sort()
            busy, cur0, cur1 = 0.0, ivals[0][0], ivals[0][1]
            for a, b in ivals[1:]:
                if a > cur1:
                    busy += cur1 - cur0
                    cur0, cur1 = a, b
                else:
                    cur1 = max(cur1, b)
            busy += cur1 - cur0
            duty[lane] = min(1.0, busy / self.window_s)
        # lanes that went idle decay to 0 instead of holding stale duty
        for lane in self._duty:
            duty.setdefault(lane, 0.0)
        self._duty = duty
        self.samples += 1
        if self.registry is not None:
            self.registry.counter("perf_duty_samples_total")
            for lane, d in duty.items():
                self.registry.gauge("perf_duty_cycle", d, lane=lane)
        return duty

    def duty(self, lane: Optional[str] = None):
        if lane is None:
            return dict(self._duty)
        return self._duty.get(lane, 0.0)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.interval_s):
                self._sample()

        self._thread = threading.Thread(
            target=_loop, name="heat2d-perf-duty", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def snapshot(self) -> dict:
        return {"duty": dict(self._duty), "samples": self.samples,
                "window_s": self.window_s}


# -- anomaly sentinel -------------------------------------------------- #

class AnomalySentinel:
    """EWMA + MAD change detection per (signature, metric).

    Metrics per tick (each skipped when unobservable, and a
    zero-traffic window contributes NO evidence — the BurnWindow
    convention, so a drained queue never reads as a regression):

    - ``rate_rps``       windowed request rate (CounterDeltas over
                         ``serve_signature_requests_total``); DOWN bad.
    - ``latency_mean_s`` windowed mean latency (sum/count deltas of
                         ``serve_signature_latency_s`` — exact, and
                         immune to the cumulative reservoir's
                         first-launch spike); UP bad.
    - ``p99_s``          the cumulative tail of the same histogram
                         (Dean & Barroso's number); UP bad.
    - ``roofline_pct``   latest ``perf_pct_of_bound`` gauge (absent
                         off the calibrated card); DOWN bad.

    Score = bad-direction deviation / robust scale, with scale =
    max(1.4826 x MAD over recent history, ``rel_floor`` x |EWMA|).
    The baseline is NOT updated by a window that scores anomalous
    (outbursts must not become their own reference); a finding fires
    after ``sustain`` consecutive anomalous windows, once per episode.
    Defaults (k=5, rel_floor=0.5, sustain=2, warmup=3) flag a
    sustained >250% deviation (the JAX package's defaults)."""

    METRIC_DIRECTION = {"rate_rps": -1, "latency_mean_s": +1,
                        "p99_s": +1, "roofline_pct": -1}

    def __init__(self, *, alpha: float = 0.3, k: float = 5.0,
                 rel_floor: float = 0.5, sustain: int = 2,
                 warmup: int = 3, history: int = 64,
                 clock=time.monotonic):
        from heat2d_tpu_torch.obs.metrics import CounterDeltas
        self.alpha, self.k = alpha, k
        self.rel_floor, self.sustain = rel_floor, sustain
        self.warmup, self.history = warmup, history
        self._clock = clock
        self._deltas = CounterDeltas()
        self._hist_last: dict = {}      # sig -> (sum, count)
        self._state: dict = {}          # (sig, metric) -> state dict
        self._last_t: Optional[float] = None
        self.findings: list = []

    @staticmethod
    def _sig(label_pairs: tuple) -> Optional[str]:
        return dict(label_pairs).get("signature")

    def tick(self, registry) -> list:
        """Evaluate one window; returns NEW findings (also appended to
        ``self.findings``). Call at a steady cadence."""
        now = self._clock()
        dt = (now - self._last_t) if self._last_t is not None else None
        self._last_t = now

        per_sig: dict = {}
        for labels, d in self._deltas.tick(
                registry, "serve_signature_requests_total").items():
            sig = self._sig(labels)
            if sig is not None:
                per_sig[sig] = per_sig.get(sig, 0.0) + d
        lat = {self._sig(k): v for k, v in registry.find_histograms(
            "serve_signature_latency_s").items()}
        frac = {self._sig(k): v for k, v in registry.find_gauges(
            "perf_pct_of_bound").items()}

        out = []
        for sig, d in per_sig.items():
            if d <= 0 or dt is None or dt <= 0:
                continue            # zero traffic / first tick: no window
            obs = {"rate_rps": d / dt}
            summ = lat.get(sig)
            if summ is not None:
                s, c = float(summ["sum"]), float(summ["count"])
                ps, pc = self._hist_last.get(sig, (0.0, 0.0))
                self._hist_last[sig] = (s, c)
                if c > pc:
                    obs["latency_mean_s"] = (s - ps) / (c - pc)
                p99 = summ.get("p99")
                if p99 == p99:      # not NaN
                    obs["p99_s"] = float(p99)
            f = frac.get(sig)
            if f is not None:
                obs["roofline_pct"] = float(f)
            for metric, x in obs.items():
                finding = self._observe(sig, metric, x, registry)
                if finding is not None:
                    out.append(finding)
        self.findings.extend(out)
        return out

    def _observe(self, sig: str, metric: str, x: float,
                 registry) -> Optional[dict]:
        st = self._state.setdefault((sig, metric), {
            "ewma": None, "hist": collections.deque(
                maxlen=self.history), "n": 0, "streak": 0,
            "flagged": False})
        finding = None
        anomalous = False
        if st["n"] >= self.warmup and st["ewma"] is not None:
            hist = sorted(st["hist"])
            med = hist[len(hist) // 2]
            mad = sorted(abs(v - med) for v in hist)[len(hist) // 2]
            scale = max(1.4826 * mad,
                        self.rel_floor * max(abs(st["ewma"]), 1e-9))
            score = (self.METRIC_DIRECTION[metric] * (x - st["ewma"])
                     / scale)
            if registry is not None:
                registry.gauge("perf_anomaly_score", score,
                               signature=sig, metric=metric)
            anomalous = score >= self.k
            if anomalous:
                st["streak"] += 1
                if st["streak"] >= self.sustain and not st["flagged"]:
                    st["flagged"] = True
                    finding = {
                        "signature": sig, "metric": metric,
                        "value": round(x, 6),
                        "baseline": round(st["ewma"], 6),
                        "score": round(score, 2),
                        "windows": st["streak"],
                    }
                    if registry is not None:
                        registry.counter("perf_anomalies_total",
                                         metric=metric)
            else:
                st["streak"] = 0
                st["flagged"] = False
        if not anomalous:
            # baseline adapts only on windows it would accept
            st["ewma"] = (x if st["ewma"] is None else
                          self.alpha * x + (1 - self.alpha)
                          * st["ewma"])
            st["hist"].append(x)
            st["n"] += 1
        return finding
