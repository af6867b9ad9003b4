"""Open-loop load runner — fire a schedule at a live target and
measure the latency/throughput surface. The port's copy of
``heat2d_tpu/load/runner.py``, with the same metric families and
row keys.

Open-loop is the discipline: arrivals fire at their SCHEDULED times
whether or not earlier requests have answered (a closed loop — the
fleet soak's semaphore — self-throttles when the server slows down,
which hides exactly the queueing collapse a capacity model must see).
The runner submits on one pacing thread, records outcomes on future
callbacks, and reports:

- **fidelity** — intended vs actual submit time per arrival
  (``load_submit_skew_s``): the proof a replayed schedule reproduced
  the recorded gaps (CI asserts the p99 bound);
- **outcomes** — ``load_requests_total{outcome}`` (completed /
  rejected_* / error), with shed (queue_full / overloaded / degraded
  / quota) and timeout classes broken out of the shed rate;
- **latency** — ``load_e2e_latency_s`` overall plus the per-signature
  ``load_signature_latency_s`` / ``load_signature_requests_total``
  families ``obs/slo.py`` evaluates (prefix="load");
- **throughput** — offered vs achieved req/s over the measured span.

Targets duck-type one protocol (``submit(request, tenant, timeout) ->
Future``): ``ServeTarget`` wraps an in-process ``SolveServer``,
``FleetTarget`` a supervised ``FleetServer`` with the mix's tenant
quotas. Both take ``device`` (``cuda`` unless the caller asks for
``cpu``): on the card a 640x1024 bucket runs H5 and a 4096^2 bucket H6,
in-process or in each worker. Tests substitute fakes — the runner
itself launches nothing.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock
from heat2d_tpu_torch.load.schedule import Schedule
from heat2d_tpu_torch.obs.metrics import quantile
from heat2d_tpu_torch.serve.schema import Rejected

#: rejection codes that are LOAD SHEDDING (admission said no): the
#: shed-rate numerator. Timeouts/faults are failures, not shedding;
#: invalid requests are caller bugs and count as neither.
#: ``mesh_saturated`` is the mesh engine's modeled-capacity admission
#: verdict (mesh.MeshAdmission) — shedding by design.
SHED_CODES = ("queue_full", "overloaded", "degraded", "quota",
              "mesh_saturated")


class ServeTarget:
    """An in-process ``SolveServer`` as a load target (1 serving
    unit). ``tenant`` is accepted and ignored — single-process serving
    has no tenant plane.

    ``mesh=True`` serves through the mesh-aware engine
    (``heat2d_tpu_torch/mesh``): still ONE serving unit, but spanning
    every visible card of ``device`` (the serve CLI's slots without
    ``--host-device-count``) — ``chips_per_unit`` then carries the mesh
    size into the capacity fit so sizing advice speaks in chips."""

    units = 1
    chips_per_unit = 1

    def __init__(self, registry=None, *, max_batch: int = 8,
                 max_delay: float = 0.005, max_queue: int = 256,
                 launch_deadline: Optional[float] = None,
                 cache_size: int = 0, mesh: bool = False,
                 device: str = "cuda"):
        from heat2d_tpu_torch.serve.server import SolveServer
        engine = None
        if mesh:
            from heat2d_tpu_torch.mesh import MeshEnsembleEngine
            from heat2d_tpu_torch.parallel.mesh import visible_devices
            # max_batch becomes the per-chip bound under the mesh
            engine = MeshEnsembleEngine(
                registry=registry, max_batch_per_chip=max_batch,
                devices=visible_devices(device))
            self.chips_per_unit = engine.n_devices
        self.max_batch = engine.max_batch if engine else max_batch
        # cache_size=0 by default: measured load must exercise the
        # SOLVE path; repeated payload hashes served from cache would
        # inflate the surface (the fleet soak makes the same call).
        self.server = SolveServer(
            max_batch=max_batch, max_delay=max_delay,
            max_queue=max_queue, cache_size=cache_size,
            launch_deadline=launch_deadline, registry=registry,
            device=device, engine=engine)
        self.server.start()

    def submit(self, req, tenant: str, timeout: Optional[float]):
        return self.server.submit(req, timeout=timeout)

    def close(self) -> None:
        self.server.stop(drain=True)


class FleetTarget:
    """A supervised worker fleet as a load target (``workers`` serving
    units). ``quotas`` come from the mix profile's tenant tiers;
    ``env`` reaches every worker (how a chaos campaign — e.g.
    ``HEAT2D_CHAOS_SLOW_WORKER_S`` — seeds a regression for the gate
    to catch). Every worker serves on ``device``, passed to it as its
    ``--device`` flag: a worker that cannot reach the card fails its
    start instead of answering from the CPU, which would fit a "card"
    capacity model on the CPU."""

    chips_per_unit = 1

    def __init__(self, workers: int = 2, registry=None, *,
                 quotas: Optional[dict] = None,
                 max_inflight: int = 256,
                 env: Optional[dict] = None,
                 default_timeout: Optional[float] = 30.0,
                 max_batch: int = 8, mesh: bool = False,
                 device: str = "cuda"):
        from heat2d_tpu_torch.fleet.router import FleetServer
        self.units = workers
        self.max_batch = max_batch
        env = dict(env or {})
        if mesh:
            # every worker serves through its mesh engine
            # (fleet/worker.py's env knob). Co-hosted workers SHARE
            # the host's devices, so chips-per-unit is the host's
            # device count split across the workers (floor, min 1) —
            # a per-worker full count would double-charge the same
            # physical chips into the capacity fit
            env.setdefault("HEAT2D_MESH_SERVE", "1")
            from heat2d_tpu_torch.parallel.mesh import visible_devices
            self.chips_per_unit = max(
                1, len(visible_devices(device)) // workers)
        self.fleet = FleetServer(
            workers=workers, registry=registry, quotas=quotas,
            max_batch=max_batch,
            max_inflight=max_inflight, cache_size=0,
            worker_cache_size=0, default_timeout=default_timeout,
            env=env, device=device)
        self.fleet.start()

    def submit(self, req, tenant: str, timeout: Optional[float]):
        return self.fleet.submit(req, tenant=tenant, timeout=timeout)

    def close(self) -> None:
        self.fleet.stop()


def _outcome_label(exc) -> str:
    if exc is None:
        return "completed"
    if isinstance(exc, Rejected):
        return "rejected_" + exc.code
    return "error"


def warm_target(target, schedule: Schedule,
                timeout: float = 120.0) -> int:
    """Warm every distinct signature in the schedule before the
    measured window opens, so the surface measures steady-state
    serving, not first launches.

    Solve signatures walk the padded-capacity ladder (simultaneous
    bursts of 1, 2, 4, ... up to the target's ``max_batch``): the
    engine builds one runner per power-of-two batch capacity, and a
    capacity first hit MID-window would otherwise land its first launch
    in the p99. On the card a new capacity compiles nothing (the kernel
    libraries are built once), but its first launch still allocates its
    operands through the caching allocator (measurement hygiene, not a
    serving-path change — the fleet's own warm restarts deliberately
    stay narrower). Inverse signatures warm with a 1-iteration twin:
    the first gradient is the expensive one; the iteration budget is a
    host loop. Warmup failures are tolerated — the measured window will
    surface them as what they are. Returns warm requests issued."""
    import dataclasses as dc
    seen = {}
    for a in schedule:
        req = a.build_request()
        seen.setdefault(req.signature(), (req, a.tenant, a.kind))
    max_batch = getattr(target, "max_batch", 8)
    issued = 0
    for req, tenant, kind in seen.values():
        if kind == "inverse":
            bursts = [[dc.replace(req, iterations=1)]]
        else:
            bursts, b = [], 1
            while b <= max_batch:
                # distinct diffusivities: the burst must not coalesce
                # (single-flight) into fewer members than its
                # capacity, nor cache-hit an earlier rung's member
                bursts.append([dc.replace(req, cx=0.9 + 1e-4 * i
                                          + 1e-3 * b)
                               for i in range(b)])
                b *= 2
        for burst in bursts:
            futs = [target.submit(r, tenant, timeout) for r in burst]
            issued += len(futs)
            for f in futs:
                try:
                    f.result(timeout)
                except Exception:   # noqa: BLE001 — best-effort
                    pass
    return issued


def run_schedule(schedule: Schedule, target, registry, *,
                 speedup: float = 1.0,
                 timeout: Optional[float] = 30.0,
                 warmup: bool = True,
                 drain_timeout: float = 120.0) -> dict:
    """Fire ``schedule`` (compressed ``speedup``x) at ``target``
    open-loop; block until every future answers (or the drain timeout
    passes); return one surface row (see module docstring for the
    metric families it fills in ``registry``)."""
    sched = schedule.scaled(speedup) if speedup != 1.0 else schedule
    if warmup:
        warm_target(target, sched)

    lock = AuditedLock("load.runner")
    outcomes: dict = {}
    latencies_done = threading.Semaphore(0)
    skews = []
    t_last_done = [0.0]

    def on_done(fut, sig_str, t_submit) -> None:
        now = time.monotonic()
        exc = fut.exception()
        label = _outcome_label(exc)
        with lock:
            outcomes[label] = outcomes.get(label, 0) + 1
            t_last_done[0] = max(t_last_done[0], now)
        if registry is not None:
            registry.counter("load_requests_total", outcome=label)
            registry.counter("load_signature_requests_total",
                             signature=sig_str, outcome=label)
            if label == "completed":
                registry.observe("load_e2e_latency_s", now - t_submit)
                registry.observe("load_signature_latency_s",
                                 now - t_submit, signature=sig_str)
        latencies_done.release()

    t0 = time.monotonic()
    n = 0
    for a in sched:
        due = t0 + a.t
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
        req = a.build_request()
        sig_str = str(req.signature())
        t_submit = time.monotonic()
        skew = t_submit - due
        skews.append(skew)
        if registry is not None:
            registry.observe("load_submit_skew_s", skew)
        fut = target.submit(req, a.tenant, timeout)
        fut.add_done_callback(
            lambda f, s=sig_str, t=t_submit: on_done(f, s, t))
        n += 1
    t_submit_end = time.monotonic()

    deadline = time.monotonic() + drain_timeout
    answered = 0
    while answered < n:
        if not latencies_done.acquire(
                timeout=max(0.0, deadline - time.monotonic())):
            break
        answered += 1

    with lock:
        out = dict(outcomes)
        t_end = max(t_last_done[0], t_submit_end)
    completed = out.get("completed", 0)
    shed = sum(out.get("rejected_" + c, 0) for c in SHED_CODES)
    span = max(t_end - t0, 1e-9)
    skews_sorted = sorted(skews)
    row = {
        "arrivals": n,
        "answered": answered,
        "unanswered": n - answered,
        "offered_rps": round(sched.offered_rps(), 4),
        "achieved_rps": round(completed / span, 4),
        "completed": completed,
        "shed": shed,
        "shed_rate": round(shed / n, 6) if n else 0.0,
        "outcomes": out,
        "speedup": float(speedup),
        "fidelity": {
            "mean_abs_skew_s": round(
                sum(abs(s) for s in skews) / len(skews), 6)
            if skews else 0.0,
            # nearest-rank quantile — the registry's one convention
            "p99_skew_s": round(quantile(skews_sorted, 0.99), 6)
            if skews_sorted else 0.0,
            "max_skew_s": round(max(skews), 6) if skews else 0.0,
        },
    }
    if registry is not None:
        hists = registry.find_histograms("load_e2e_latency_s")
        for _k, summ in hists.items():
            row["latency"] = {q: summ[q]
                              for q in ("p50", "p90", "p99", "mean",
                                        "max", "count")}
        point = f"{row['offered_rps']:g}"
        registry.gauge("load_offered_rps", row["offered_rps"],
                       point=point)
        registry.gauge("load_achieved_rps", row["achieved_rps"],
                       point=point)
        registry.gauge("load_shed_rate", row["shed_rate"], point=point)
    return row


def measure_point(schedule: Schedule, target, *,
                  speedup: float = 1.0,
                  timeout: Optional[float] = 30.0,
                  slo_policy=None, warmup: bool = True) -> dict:
    """One sweep point with its OWN registry (per-point quantiles must
    not mix across offered rates) + an SLO evaluation over the
    per-signature families. Returns the surface row; the point
    registry rides in ``row["_registry"]`` for callers that export
    telemetry."""
    from heat2d_tpu_torch.obs import MetricsRegistry, slo
    reg = MetricsRegistry()
    # the target records into its own registry; the runner's families
    # land here — per-point isolation either way
    row = run_schedule(schedule, target, reg, speedup=speedup,
                       timeout=timeout, warmup=warmup)
    row["slo"] = slo.evaluate(reg, prefix="load", default=slo_policy)
    row["slo_ok"] = all(r.get("ok", True) for r in row["slo"])
    row["_registry"] = reg
    return row
