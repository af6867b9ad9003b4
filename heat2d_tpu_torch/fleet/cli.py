"""``heat2d-tpu-torch-fleet``: drive a supervised worker pool, optionally
under chaos, and prove the fleet invariants from outside. The port's
copy of the soak of ``heat2d_tpu/fleet/cli.py``.

The soak (``--soak S``) sustains a closed-loop load of ``--concurrency``
outstanding requests over a rotating set of signatures for S seconds, on
workers that run on ``--device`` (``cuda`` unless the caller asks for
``cpu``). With ``--chaos``, ``--kill K`` workers are hard-killed at the
soak's midpoint (the supervisor must detect, fail over, and restart
them). After the load drains, the CLI asserts the acceptance criteria
and exits nonzero if any fail:

1. **Zero incorrect results**: every distinct request is re-solved by a
   one-process ORACLE (an in-process ``SolveServer`` on the same device)
   and every fleet response must match it bitwise.
2. **Nothing silently lost**: submitted == completed + structured
   ``Rejected``.
3. **Throughput recovers**: after the kill, the completion rate over a
   sliding window must return to within ``--recovery-margin`` (default
   20%) of the pre-kill steady state. Recovery is MEASURED: the load
   keeps running until the bar clears (the time to recovery is
   reported) or 3x the nominal soak elapses (a failure).
4. **Clean exit**: every worker drains and exits 0 at shutdown.

``--metrics-out`` writes the registry JSONL and a ``kind="fleet"`` run
record (soak phases, throughput windows, worker deaths/restarts, replay
counts).

Requests take method ``auto``, where the JAX soak takes ``jnp``: on the
card ``auto`` is the hand kernels' route (H5 for grids the resident gate
admits, else H6), while ``jnp`` would be their plain versions.

The control plane (``--control*``) and the elastic soak
(``--autoscale*``) drive ``heat2d_tpu_torch.control`` and
``heat2d_tpu_torch.autoscale``, which the port does not have yet: those
flags exit 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

from heat2d_tpu_torch.analysis.locks import AuditedLock


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-fleet",
        description="supervised multi-worker serving pool with "
                    "chaos-proven failover")
    p.add_argument("--workers", type=int, default=3,
                   help="worker subprocesses in the pool")
    p.add_argument("--soak", type=float, default=None, metavar="S",
                   help="run the sustained-load soak for S seconds "
                        "and assert the fleet invariants")
    p.add_argument("--chaos", action="store_true",
                   help="with --soak: hard-kill --kill workers at the "
                        "soak midpoint (failover + restart must absorb "
                        "it)")
    p.add_argument("--kill", type=int, default=1, metavar="K",
                   help="workers to kill with --chaos (k of N)")
    p.add_argument("--concurrency", type=int, default=8,
                   help="outstanding requests in the closed loop")
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--signatures", type=int, default=2,
                   help="distinct signatures in the request mix (steps, "
                        "steps+1, ...)")
    p.add_argument("--recovery-margin", type=float, default=0.2,
                   help="allowed post-restart throughput drop vs the "
                        "pre-kill window (0.2 = within 20%%)")
    p.add_argument("--window", type=float, default=None, metavar="S",
                   help="throughput measurement window (default: a "
                        "third of the soak)")
    p.add_argument("--heartbeat-timeout", type=float, default=2.0)
    p.add_argument("--timeout", type=float, default=60.0,
                   help="per-request fleet deadline")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write telemetry JSONL (fleet_* families + the "
                        "kind='fleet' run record)")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="arm fleet-wide tracing AND the workers' crash "
                        "flight recorders: the router and every worker "
                        "write span JSONL into DIR (workers inherit "
                        "HEAT2D_TRACE_DIR/HEAT2D_FLIGHT_DIR through the "
                        "supervisor); merge with heat2d-tpu-torch-trace "
                        "DIR")
    p.add_argument("--worker-env", action="append", default=[],
                   metavar="SLOT:KEY=VAL",
                   help="extra env for ONE worker slot (repeatable), e.g. "
                        "0:HEAT2D_CHAOS_WORKER_KILL_AFTER=5 aims a chaos "
                        "self-kill at worker 0 (a self-kill flushes the "
                        "worker's flight recorder)")
    p.add_argument("--slo-p99", type=float, default=None, metavar="S",
                   help="per-signature p99 latency target; evaluation "
                        "lands in the run record's 'slo' rows and the "
                        "slo_* gauges")
    p.add_argument("--slo-error-budget", type=float, default=0.001,
                   metavar="F",
                   help="allowed failure fraction per signature")
    for flag in ("--control", "--control-rollout",
                 "--control-bad-candidate", "--autoscale"):
        p.add_argument(flag, action="store_true",
                       help="needs heat2d_tpu_torch.control/autoscale, "
                            "which the port does not have yet (exit 2)")
    for flag in ("--control-db", "--control-storm-phase",
                 "--control-observe", "--autoscale-util",
                 "--autoscale-seed"):
        p.add_argument(flag, default=None,
                       help="needs heat2d_tpu_torch.control/autoscale, "
                            "which the port does not have yet (exit 2)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the workers and the oracle run (default "
                        "cuda)")
    p.add_argument("--log-level", default=None,
                   choices=["debug", "info", "warning", "error"])
    return p


def _requests(args, n: int):
    """The soak's request stream (a generator): ``n`` requests over
    ``--signatures`` distinct signatures with rotating diffusivities.
    The pool repeats with period 256 per signature, bounded so the
    oracle can verify every distinct hash, which is why ``run_soak``
    disables every result cache: the repeats must re-solve, or the
    throughput gate would measure cache service."""
    from heat2d_tpu_torch.serve.schema import SolveRequest
    for i in range(n):
        yield SolveRequest(
            nx=args.nx, ny=args.ny,
            steps=args.steps + (i % args.signatures),
            cx=0.05 + 0.0003 * (i % 256), cy=0.1, method="auto")


def _parse_worker_env(specs) -> dict:
    """--worker-env SLOT:KEY=VAL flags -> per_worker_env dict."""
    out: dict = {}
    for spec in specs:
        try:
            slot, kv = spec.split(":", 1)
            key, val = kv.split("=", 1)
            out.setdefault(int(slot), {})[key] = val
        except ValueError:
            raise SystemExit(f"bad --worker-env {spec!r} "
                             f"(want SLOT:KEY=VAL)") from None
    return out


def run_soak(args, registry) -> int:
    from heat2d_tpu_torch.fleet.router import FleetServer
    from heat2d_tpu_torch.serve.schema import Rejected

    failures = []
    events = []                 # (t, "completed" | rejected-code)
    ev_lock = AuditedLock("fleet.cli.events")
    responses = {}              # content_hash -> result bytes

    fleet = FleetServer(
        workers=args.workers, registry=registry,
        default_timeout=args.timeout,
        heartbeat_timeout=args.heartbeat_timeout,
        # ALL result caches are OFF for the soak: the request pool cycles,
        # and either cache would absorb the repeats; the throughput
        # windows must measure the SOLVE path the chaos is aimed at.
        cache_size=0, worker_cache_size=0,
        device=args.device,
        per_worker_env=_parse_worker_env(args.worker_env))
    killed = []
    submitted = 0
    sem = threading.Semaphore(args.concurrency)

    def on_done(fut, req):
        import numpy as np
        now = time.monotonic()
        try:
            res = fut.result()
            with ev_lock:
                events.append((now, "completed"))
                responses.setdefault(req.content_hash(),
                                     np.asarray(res.u).tobytes())
                if responses[req.content_hash()] != \
                        np.asarray(res.u).tobytes():
                    failures.append(
                        f"divergent responses for {req.content_hash()}")
        except Rejected as e:
            with ev_lock:
                events.append((now, f"rejected_{e.code}"))
        except Exception as e:  # noqa: BLE001 (a soak reports, always)
            with ev_lock:
                events.append((now, f"error:{e!r}"))
        sem.release()

    print(f"# fleet soak: {args.workers} workers on {args.device}, "
          f"{args.soak:.0f}s, concurrency {args.concurrency}"
          + (f", killing {args.kill} at midpoint" if args.chaos else ""))
    with fleet:
        # Warmup OUTSIDE the measured window: every signature runs its
        # first launches on its worker, so the pre-kill window measures
        # steady-state serving (the recovery gate needs a real baseline).
        warm = [fleet.submit(r) for r in
                (dataclasses.replace(req, cx=0.9 + 0.0003 * j)
                 for j, req in enumerate(_requests(
                     args, args.signatures * max(args.concurrency, 8))))]
        for f in warm:
            try:
                f.result(timeout=args.timeout + 60)
            except Exception:   # noqa: BLE001 (warmup is best-effort)
                pass
        t_start = time.monotonic()
        kill_at = t_start + args.soak / 2 if args.chaos else None
        window = args.window or max(1.0, args.soak / 3)
        reqs = iter(_requests(args, 10 ** 9))
        t_rec = None        # when the fleet was whole-and-warm again
        pre = post = None   # rps windows
        t_thr = None        # when throughput was back within margin
        last_check = 0.0
        while True:
            now = time.monotonic()
            if (killed and t_rec is None
                    and fleet.sup.deaths >= len(killed)
                    and fleet.sup.restarts >= len(killed)
                    and len(fleet.sup.alive_slots()) == args.workers
                    and not fleet._cold):
                t_rec = now
                print(f"# t+{now - t_start:.1f}s: fleet recovered "
                      f"({args.workers} workers alive and warm)")
            if (pre is not None and t_thr is None
                    and now >= kill_at + window   # window all post-kill
                    and now - last_check >= 0.25):
                # the recovery probe: completion rate over the sliding
                # last window, against the pre-kill baseline
                last_check = now
                with ev_lock:
                    r = _rate(events, 0.0, now - window, now)
                if r >= (1.0 - args.recovery_margin) * pre:
                    t_thr, post = now, r
                    print(f"# t+{now - t_start:.1f}s: throughput "
                          f"recovered ({r:.1f} rps vs {pre:.1f} "
                          f"pre-kill)")
            if now - t_start >= args.soak:
                # under --chaos the load keeps running until the sliding
                # window clears the recovery bar (capped at 3x the soak,
                # reported as a failure)
                if (not args.chaos
                        or (t_thr is not None and t_rec is not None)
                        or now - t_start >= 3 * args.soak):
                    break
            if (kill_at is not None and not killed
                    and now >= kill_at):
                with ev_lock:
                    pre = _rate(events, t_start, kill_at - t_start
                                - window, kill_at - t_start)
                for k in range(args.kill):
                    fleet.sup.kill_worker(k)
                    killed.append(k)
                print(f"# t+{now - t_start:.1f}s: killed "
                      f"worker(s) {killed} (pre-kill {pre:.1f} rps)")
            if not sem.acquire(timeout=0.1):
                continue
            req = next(reqs)
            submitted += 1
            fleet.submit(req).add_done_callback(
                lambda f, r=req: on_done(f, r))
        # drain: wait for every outstanding slot back
        for _ in range(args.concurrency):
            sem.acquire(timeout=args.timeout + 30)
        deaths, restarts = fleet.sup.deaths, fleet.sup.restarts
        alive = len(fleet.sup.alive_slots())
        clean = fleet.stop()

    answered = len(events)
    completed = sum(1 for _t, o in events if o == "completed")
    rejected = answered - completed
    if answered != submitted:
        failures.append(f"silent loss: {submitted} submitted but only "
                        f"{answered} answered")
    if completed == 0:
        failures.append("no request completed")
    errors = [o for _t, o in events if o.startswith("error:")]
    if errors:
        failures.append(f"{len(errors)} unstructured errors, e.g. "
                        f"{errors[0]}")

    # -- oracle: every distinct request, bitwise ----------------------- #
    mismatches = _oracle_check(args, responses)
    if mismatches:
        failures.append(f"{mismatches} responses differ bitwise from "
                        f"the single-worker oracle")

    # -- throughput windows -------------------------------------------- #
    summary = {
        "workers": args.workers, "soak_s": args.soak,
        "device": args.device,
        "submitted": submitted, "completed": completed,
        "rejected": rejected, "distinct": len(responses),
        "deaths": deaths, "restarts": restarts,
        "replays": fleet.replays, "alive_at_end": alive,
        "clean_exit": clean, "killed": killed,
        "kernel_launches": fleet.sup.kernel_launches(),
    }
    if args.chaos:
        if post is None:        # never cleared the bar: report the tail
            t_end = events[-1][0] if events else time.monotonic()
            post = _rate(events, 0.0, t_end - window, t_end)
        summary.update(
            pre_kill_rps=round(pre or 0.0, 2),
            post_restart_rps=round(post, 2), window_s=window,
            restart_recovery_s=(None if t_rec is None
                                else round(t_rec - kill_at, 2)),
            throughput_recovery_s=(None if t_thr is None
                                   else round(t_thr - kill_at, 2)))
        if registry is not None:
            registry.gauge("fleet_throughput_rps", pre or 0.0,
                           window="pre_kill")
            registry.gauge("fleet_throughput_rps", post,
                           window="post_restart")
            if t_thr is not None:
                registry.gauge("fleet_recovery_s", t_thr - kill_at)
        if not pre:
            failures.append("no pre-kill steady state measured: the "
                            "recovery gate would be vacuous (soak too "
                            "short or workers never warmed)")
        if t_rec is None:
            failures.append("fleet never returned to full strength "
                            "(no recovery point observed)")
        if deaths < len(killed):
            failures.append(f"killed {len(killed)} workers but only "
                            f"{deaths} deaths detected")
        if restarts < len(killed):
            failures.append(f"no restart after kill ({restarts} < "
                            f"{len(killed)})")
        if pre and t_thr is None:
            failures.append(
                f"throughput did not recover within {3 * args.soak:.0f}"
                f"s: {post:.1f} rps vs {pre:.1f} pre-kill (margin "
                f"{args.recovery_margin})")
    if not clean:
        failures.append("supervisor shutdown was not clean")

    print(f"# soak summary: {json.dumps(summary)}")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    _write_metrics(args, registry, dict(summary, failures=failures))
    print("fleet soak " + ("FAILED" if failures else "passed"))
    return 1 if failures else 0


def _rate(events, t_start: float, lo: float, hi: float) -> float:
    """Completions per second inside the (lo, hi] soak-relative
    window."""
    if hi <= lo:
        return 0.0
    n = sum(1 for t, o in events
            if o == "completed" and lo < t - t_start <= hi)
    return n / (hi - lo)


def _oracle_check(args, responses) -> int:
    """Re-solve every distinct request on ONE in-process server on the
    soak's device and count bitwise mismatches against the fleet's
    answers."""
    import numpy as np

    from heat2d_tpu_torch.serve.server import SolveServer

    todo = dict(responses)
    mismatches = 0
    with SolveServer(registry=None, device=args.device) as oracle:
        # regenerate the request stream and solve each distinct hash
        for req in _requests(args, 10 ** 6):
            h = req.content_hash()
            if h not in todo:
                if not todo:
                    break
                continue
            want = todo.pop(h)
            got = np.asarray(
                oracle.solve(req, timeout=120).u).tobytes()
            if got != want:
                mismatches += 1
    return mismatches + len(todo)


def _write_metrics(args, registry, extra) -> None:
    from heat2d_tpu_torch.obs.record import write_run_jsonl
    if args.slo_p99 is not None and registry is not None:
        from heat2d_tpu_torch.obs import slo
        slo.stamp_record(extra, slo.evaluate(
            registry, prefix="fleet",
            default=slo.SLOPolicy(latency_p99_s=args.slo_p99,
                                  error_budget=args.slo_error_budget)))
    if args.trace_dir:
        from heat2d_tpu_torch.obs import flight, tracing
        t = tracing.tracer()
        extra["trace"] = {
            "dir": args.trace_dir,
            "router_spans": t.spans_emitted if t is not None else 0,
            "postmortems": len(flight.find_postmortems(args.trace_dir)),
        }
    write_run_jsonl(registry, args.metrics_out, "fleet", extra)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.log_level:
        import logging
        logging.basicConfig(
            format="%(asctime)s %(name)s %(levelname)s %(message)s")
        logging.getLogger("heat2d_tpu_torch").setLevel(
            getattr(logging, args.log_level.upper()))
    if args.control or args.control_rollout or args.control_bad_candidate \
            or args.control_db or args.control_storm_phase \
            or args.control_observe:
        print("--control* drives the control plane "
              "(heat2d_tpu_torch.control), which heat2d_tpu_torch does "
              "not have yet", file=sys.stderr)
        return 2
    if args.autoscale or args.autoscale_util or args.autoscale_seed:
        print("--autoscale* drives the elastic soak "
              "(heat2d_tpu_torch.autoscale), which heat2d_tpu_torch does "
              "not have yet", file=sys.stderr)
        return 2
    if args.trace_dir:
        # Router tracer here; workers inherit the campaign through the
        # environment (the supervisor copies os.environ into each
        # worker). The explicit flag wins over stale env vars, so every
        # process writes into the ONE directory.
        os.environ["HEAT2D_TRACE_DIR"] = args.trace_dir
        os.environ["HEAT2D_FLIGHT_DIR"] = args.trace_dir
        from heat2d_tpu_torch.obs import tracing
        tracing.install(tracing.Tracer(args.trace_dir, service="router"))
    from heat2d_tpu_torch.fleet.supervisor import WorkerStartError
    from heat2d_tpu_torch.obs import MetricsRegistry
    from heat2d_tpu_torch.utils.device import (DeviceUnavailableError,
                                               resolve_device)
    registry = MetricsRegistry()
    if args.soak is not None:
        try:
            resolve_device(args.device)     # the oracle's, before any spawn
            return run_soak(args, registry)
        except (DeviceUnavailableError, WorkerStartError) as e:
            print(f"{e}\nQuitting...", file=sys.stderr)
            return 1
    print("nothing to do: pass --soak S (optionally --chaos); the fleet "
          "embeds in-process via heat2d_tpu_torch.fleet.FleetServer",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
