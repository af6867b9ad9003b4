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

``--control`` arms the SLO-driven control plane
(``heat2d_tpu_torch.control``) beside the soak: workers serve under the
control directory's validated tuning db, and ``--control-rollout``
stages a candidate for the hottest signature (simulated measurement
backend, as the JAX CLI) at the soak's midpoint and runs one safe
rollout while the load keeps running. ``--control-bad-candidate`` and
``--control-storm-phase`` poison the canary or land a kill storm in one
rollout window; the CLI then asserts the revert's bitwise parity and
that no worker generation served a non-validated config. The control
plane's decisions ride a ``kind="control"`` record beside the fleet one.

``--autoscale`` runs the ELASTIC soak instead (``run_autoscale``): the
compressed diurnal envelope of ``load/synth.py`` drives the control
plane's capacity advice through an ``autoscale.Actuator``; the pool must
follow the envelope both ways, SLOs must hold through every resize,
chip-seconds must land below static provisioning at ``--workers``, one
live-migrated inverse job must finish bitwise equal to its unmigrated
oracle, and a mesh engine over ``--host-device-count`` slots of
``--device`` must resize, quarantine and parole bitwise.
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
    p.add_argument("--control", action="store_true",
                   help="arm the SLO-driven control plane beside the "
                        "soak: a BurnWindow watches per-signature burn "
                        "and sheds/retunes before the breaker trips; "
                        "workers serve under the control db directory's "
                        "validated tuning db")
    p.add_argument("--control-db", default=None, metavar="DIR",
                   help="directory for the control plane's "
                        "validated.json / candidate.json tuning dbs "
                        "(default: a temp dir)")
    p.add_argument("--control-rollout", action="store_true",
                   help="with --control: at the soak midpoint, stage a "
                        "candidate db for the hottest signature "
                        "(simulated measurement backend) and run one "
                        "safe rollout (canary, bitwise parity, "
                        "observation, promote or auto-revert) while the "
                        "load keeps running")
    p.add_argument("--control-bad-candidate", action="store_true",
                   help="inject a deliberately-bad candidate: the "
                        "canary's one-generation env overlay carries "
                        "HEAT2D_CHAOS_SLOW_WORKER_S, so the rollout MUST "
                        "measure the regression and auto-revert with "
                        "bitwise post-revert parity (the CLI fails "
                        "otherwise)")
    p.add_argument("--control-storm-phase", default=None,
                   choices=["canary", "parity", "observe", "promote"],
                   help="arm a chaos kill storm (every worker hard-"
                        "killed) to land when the rollout reaches this "
                        "window; the CLI then asserts no worker "
                        "generation ever served a non-validated config")
    p.add_argument("--control-observe", type=float, default=2.0,
                   metavar="S",
                   help="rollout observation window (paired probes + "
                        "windowed SLO burn)")
    p.add_argument("--autoscale", action="store_true",
                   help="run the ELASTIC soak instead of the chaos soak: "
                        "a compressed diurnal traffic envelope "
                        "(load/synth 'diurnal' profile) drives the "
                        "control plane's capacity advice through an "
                        "autoscale.Actuator; the worker pool must follow "
                        "the envelope both directions, SLOs must hold "
                        "through every resize, chip-seconds must land "
                        "below static provisioning at --workers, and one "
                        "live-migrated inverse job must finish "
                        "bitwise-identical to its unmigrated oracle")
    p.add_argument("--autoscale-util", type=float, default=0.6,
                   metavar="F",
                   help="target utilization: the capacity fit is derated "
                        "to F of the calibrated per-unit rate, so "
                        "sizing keeps 1-F headroom")
    p.add_argument("--autoscale-seed", type=int, default=0,
                   help="seed naming the synthesized diurnal workload")
    p.add_argument("--host-device-count", type=int, default=4,
                   metavar="N",
                   help="with --autoscale: the slots of --device the "
                        "mesh leg resizes, quarantines and paroles over "
                        "(parallel.mesh.host_devices; 1 skips the leg, "
                        "as the JAX CLI skips a one-device process)")
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
    env = {}

    # -- control plane setup -------------------------------------------- #
    control = args.control or args.control_rollout
    validated_path = candidate_path = None
    if control:
        import tempfile
        cdir = args.control_db or tempfile.mkdtemp("heat2d-control")
        os.makedirs(cdir, exist_ok=True)
        validated_path = os.path.join(cdir, "validated.json")
        candidate_path = os.path.join(cdir, "candidate.json")
        # every worker serves under the VALIDATED db path (a missing
        # file degrades to "no db"); rollouts hand the candidate path to
        # a canary via a one-generation env overlay only
        env["HEAT2D_TUNE_DB"] = validated_path
    if args.control_storm_phase:
        from heat2d_tpu_torch.resil import chaos
        chaos.install(chaos.ChaosConfig(
            rollout_kill_phase=args.control_storm_phase,
            rollout_kills=0), registry=registry)

    fleet = FleetServer(
        workers=args.workers, registry=registry,
        default_timeout=args.timeout,
        heartbeat_timeout=args.heartbeat_timeout,
        # ALL result caches are OFF for the soak: the request pool cycles,
        # and either cache would absorb the repeats; the throughput
        # windows must measure the SOLVE path the chaos is aimed at.
        cache_size=0, worker_cache_size=0,
        device=args.device, env=env,
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
          + (f", killing {args.kill} at midpoint" if args.chaos else "")
          + (", control plane armed" if control else ""))
    plane = None
    rollout_thread = None
    rollout_out: dict = {}
    control_extra = None
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
        if control:
            from heat2d_tpu_torch.control import ControlPlane, Retuner
            from heat2d_tpu_torch.obs import slo as _slo
            plane = ControlPlane(
                fleet,
                policy=_slo.SLOPolicy(
                    latency_p99_s=args.slo_p99 or 30.0,
                    error_budget=args.slo_error_budget),
                retuner=Retuner(fleet, candidate_path=candidate_path,
                                validated_path=validated_path),
                registry=registry).start()
        t_start = time.monotonic()
        kill_at = t_start + args.soak / 2 if args.chaos else None
        rollout_at = (t_start + args.soak / 2
                      if args.control_rollout else None)
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
            if (rollout_at is not None and rollout_thread is None
                    and now >= rollout_at):
                rollout_at = None
                rollout_thread = _start_rollout(
                    args, plane, validated_path, candidate_path,
                    rollout_out, failures)
            if now - t_start >= args.soak:
                # under --chaos the load keeps running until the sliding
                # window clears the recovery bar (capped at 3x the soak,
                # reported as a failure)
                chaos_done = (not args.chaos
                              or (t_thr is not None and t_rec is not None)
                              or now - t_start >= 3 * args.soak)
                # a mid-soak rollout keeps its observation probes under
                # live load: the loop runs until it settles (capped)
                rollout_done = (rollout_thread is None
                                or not rollout_thread.is_alive()
                                or now - t_start >= 6 * args.soak)
                if chaos_done and rollout_done:
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
        if rollout_thread is not None:
            rollout_thread.join(timeout=3 * args.soak + 120)
            if rollout_thread.is_alive():
                failures.append("control rollout did not finish")
        # drain: wait for every outstanding slot back
        for _ in range(args.concurrency):
            sem.acquire(timeout=args.timeout + 30)
        if plane is not None:
            plane.stop()
            control_extra = plane.summary()
            control_extra["validated_path"] = validated_path
            control_extra["candidate_path"] = candidate_path
            # what every CURRENT worker reports serving, pre-shutdown
            control_extra["workers_tune"] = {
                str(s): (fleet.sup.worker_info(s) or {}).get("tune")
                for s in fleet.sup.alive_slots()}
        deaths, restarts = fleet.sup.deaths, fleet.sup.restarts
        alive = len(fleet.sup.alive_slots())
        clean = fleet.stop()
    if args.control_storm_phase:
        from heat2d_tpu_torch.resil import chaos
        chaos.uninstall()

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

    # -- control-plane acceptance --------------------------------------- #
    if control_extra is not None:
        _control_acceptance(args, control_extra, rollout_out,
                            validated_path, summary, failures)

    print(f"# soak summary: {json.dumps(summary)}")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    _write_metrics(args, registry, dict(summary, failures=failures),
                   control=control_extra)
    print("fleet soak " + ("FAILED" if failures else "passed"))
    return 1 if failures else 0


def _control_acceptance(args, control_extra, rollout_out, validated_path,
                        summary, failures) -> None:
    """The control legs' verdicts (the JAX CLI's, verbatim): nothing
    unvalidated served; the rollout ended as its flags demand."""
    from heat2d_tpu_torch.tune.db import TuningDB
    if not control_extra.get("no_unvalidated_serving"):
        failures.append(
            "control: a non-rollout worker generation served a "
            "non-validated config: "
            f"{control_extra.get('unvalidated_serving')}")
    oc = rollout_out.get("outcome")
    control_extra["rollout_outcome"] = oc
    if args.control_rollout and oc is None:
        failures.append("control: the rollout never produced an "
                        "outcome")
    elif args.control_bad_candidate:
        if not (oc or "").startswith("reverted"):
            failures.append(f"control: the deliberately-bad "
                            f"candidate was NOT auto-reverted "
                            f"(outcome {oc})")
        elif rollout_out.get("post_revert_parity") is not True:
            failures.append("control: post-revert answers were "
                            "not bitwise-identical to the "
                            "pre-rollout baseline")
    elif args.control_storm_phase and (oc or "").startswith("reverted"):
        if rollout_out.get("post_revert_parity") is not True:
            failures.append("control: storm revert without a "
                            "bitwise post-revert parity proof")
    elif args.control_rollout and not args.control_storm_phase:
        if oc != "promoted":
            failures.append(f"control: a healthy candidate did "
                            f"not promote (outcome {oc})")
        else:
            vdb = TuningDB(validated_path)
            if not (vdb.validated and vdb.epoch
                    == rollout_out.get("epoch")):
                failures.append(
                    f"control: promote did not advance the "
                    f"validated db (epoch {vdb.epoch}, validated "
                    f"{vdb.validated})")
    summary["control"] = {
        "rollout_outcome": oc,
        "no_unvalidated_serving":
            control_extra.get("no_unvalidated_serving"),
        "decisions": len(control_extra.get("decisions", [])),
    }


def run_autoscale(args, registry) -> int:
    """The elastic soak: calibrate one worker's throughput and the whole
    pool's, synthesize a compressed diurnal day from ``load/synth``, and
    let the control plane and actuator run the pool; then assert the
    closed loop closed. A serving unit is sized at the lesser of one
    worker's rate and the pool's rate per worker (the JAX package sizes
    it by one worker: on one card the workers share the card and the
    router's host, and a pool of three carries little more than one):

    1. capacity FOLLOWS the envelope: scale-ups and scale-downs both
       happen, and the mean pool size under the envelope's peak beats
       the mean under its trough;
    2. SLOs hold through every resize: nothing lost, nothing rejected,
       no unstructured errors;
    3. elasticity is cheaper than static provisioning: the actuator's
       chip-seconds ledger lands below ``--workers`` workers held for
       the whole window;
    4. one long-running inverse job, live-migrated off a retiring worker
       mid-optimization, finishes bitwise equal to the oracle that never
       moved (both on ``--device``);
    5. with ``--host-device-count`` >= 2: mesh resize down/up,
       quarantine and parole over that many slots of ``--device`` all
       serve bitwise-identical answers with ``no_quarantined_serving``
       intact and the paroled slot back in the serving set.
    """
    from heat2d_tpu_torch.load.synth import PROFILES
    return run_elastic(args, registry, PROFILES["diurnal"])[0]


def run_elastic(args, registry, profile, *, migration=None) -> tuple:
    """``run_autoscale`` on ``profile`` (a diurnal ``MixProfile``: the
    CLI's is the JAX package's; ``chip_smoke.py`` passes one at the
    card's width). ``migration``: the inverse job's (problem, iterations,
    lr), default the JAX CLI's 12x12 job. Returns (exit code, summary):
    the summary is the record's, with the failures, the actuator's
    actions and its pool-size trace beside the load's start time."""
    import math

    from heat2d_tpu_torch.autoscale import Actuator, AutoscalePolicy
    from heat2d_tpu_torch.autoscale import migrate as migrate_mod
    from heat2d_tpu_torch.control import ControlPlane
    from heat2d_tpu_torch.fleet.router import FleetServer
    from heat2d_tpu_torch.load import capacity
    from heat2d_tpu_torch.load.synth import synthesize
    from heat2d_tpu_torch.obs import MetricsRegistry
    from heat2d_tpu_torch.obs import slo as _slo
    from heat2d_tpu_torch.resil.retry import wait_for
    from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest

    failures = []
    events = []                 # (t, "completed" | rejected-code)
    ev_lock = AuditedLock("fleet.cli.autoscale")
    period = profile.diurnal_period_s
    amp = profile.diurnal_amplitude
    soak = args.soak if args.soak is not None else 1.5 * period
    min_w, max_w = 1, args.workers
    submitted = 0

    print(f"# autoscale soak: diurnal envelope ({period:.0f}s period, "
          f"amplitude {amp}), {soak:.0f}s, pool [{min_w}, {max_w}] on "
          f"{args.device}")
    fleet = FleetServer(
        # the whole pool starts for the calibration; the day starts
        # with min_w of it
        workers=max_w, registry=registry,
        default_timeout=args.timeout,
        heartbeat_timeout=args.heartbeat_timeout,
        # caches off for the same reason as the chaos soak: calibration
        # and the envelope response must measure the SOLVE path
        cache_size=0, worker_cache_size=0,
        # the envelope DELIBERATELY under-provisions at the trough (that
        # is the savings), so the rising edge queues until the scale-up
        # absorbs it: admission must hold the backlog, not shed it (the
        # router's admission AND the workers' own batcher doors)
        max_inflight=100_000, queue_depth=100_000,
        worker_timeout=args.timeout, device=args.device)

    def on_done(fut, _req):
        now = time.monotonic()
        try:
            fut.result()
            with ev_lock:
                events.append((now, "completed"))
        except Rejected as e:
            with ev_lock:
                events.append((now, f"rejected_{e.code}"))
        except Exception as e:  # noqa: BLE001 (a soak reports, always)
            with ev_lock:
                events.append((now, f"error:{e!r}"))

    plane = None
    summary: dict = {}
    control_extra = None
    with fleet:
        # -- warmup: every signature runs once off the measured path -- #
        warm = [fleet.submit(SolveRequest(
            nx=profile.nx, ny=profile.ny, steps=profile.steps + s,
            cx=0.9 + 0.001 * s, cy=0.1, method=profile.method))
            for s in range(profile.signatures)]
        for f in warm:
            try:
                f.result(timeout=args.timeout + 60)
            except Exception:   # noqa: BLE001 (warmup is best-effort)
                pass

        # -- calibration: one worker's sustainable rate, then the -- #
        # -- whole pool's over the profile's signatures ------------ #
        def one(i):
            return SolveRequest(
                nx=profile.nx, ny=profile.ny, steps=profile.steps,
                cx=round(0.05 + 0.0001 * (i % 997), 6), cy=0.1,
                method=profile.method)

        def mixed(i):
            return SolveRequest(
                nx=profile.nx, ny=profile.ny,
                steps=profile.steps + i % profile.signatures,
                cx=round(0.05 + 0.0001 * (i % 997), 6), cy=0.1,
                method=profile.method)

        cal_conc = max(2, min(4, args.concurrency))
        # one signature routes to one worker: that worker's rate
        measured = _calibrate(fleet, one, cal_conc, args.timeout)
        pool_rps = (_calibrate(fleet, mixed, cal_conc * max_w,
                               args.timeout) if max_w > 1 else measured)
        if measured <= 0 or pool_rps <= 0:
            print("FAIL: calibration measured no throughput",
                  file=sys.stderr)
            fleet.stop()
            return 1, {"failures": ["calibration measured no throughput"]}
        for slot in sorted(fleet.sup.alive_slots())[min_w:]:
            fleet.retire_worker(slot, timeout=args.timeout)
        # a unit is worth one worker's rate only where the pool scales
        # with its workers: workers sharing one card (or the router's
        # host) add less, and sizing by one worker would promise the
        # envelope's peak a capacity the pool never had
        unit_rps = min(measured, pool_rps / max_w)
        fit = capacity.fit_capacity(
            [{"offered_rps": unit_rps, "achieved_rps": unit_rps,
              "shed_rate": 0.0, "slo_ok": True},
             {"offered_rps": 4 * unit_rps, "achieved_rps": unit_rps,
              "shed_rate": 0.5, "slo_ok": False}], units=1)
        # derate to the target utilization: the autoscaler sizes for
        # headroom, not the saturation knee it calibrated at
        fit["per_unit_rps"] = round(
            fit["per_unit_rps"] * args.autoscale_util, 4)
        # base rate such that the envelope's PEAK needs the whole pool
        # and its trough needs ~min_workers
        base_rate = max_w * fit["per_unit_rps"] / (1.0 + amp)
        print(f"# calibrated {measured:.1f} rps/worker, {pool_rps:.1f} "
              f"rps for {max_w} (derated per-unit "
              f"{fit['per_unit_rps']:.1f}); base rate {base_rate:.1f} rps")
        sched = synthesize(profile, base_rate, soak,
                           seed=args.autoscale_seed, max_arrivals=20000)

        # -- arm the loop: plane -> actuator -> fleet ---------------- #
        policy = AutoscalePolicy(
            min_workers=min_w, max_workers=max_w,
            up_cooldown_s=1.0, down_cooldown_s=2.0,
            down_hold_ticks=2, max_step_up=2, max_step_down=1,
            drain_timeout_s=args.timeout)
        actuator = Actuator(fleet, policy, registry=registry,
                            device=args.device)
        plane = ControlPlane(
            fleet,
            policy=_slo.SLOPolicy(latency_p99_s=args.slo_p99 or 30.0,
                                  error_budget=args.slo_error_budget),
            interval=0.25, capacity_fit=fit, registry=registry,
            actuator=actuator).start()

        # -- replay the synthesized day (open loop) ------------------ #
        t_load = time.monotonic()
        for arr in sched.arrivals:
            now = time.monotonic() - t_load
            if arr.t > now:
                time.sleep(arr.t - now)
            submitted += 1
            fleet.submit(SolveRequest(**arr.spec)).add_done_callback(
                lambda f, r=arr: on_done(f, r))
        deadline = time.monotonic() + args.timeout + 60
        while time.monotonic() < deadline:
            with ev_lock:
                if len(events) >= submitted:
                    break
            time.sleep(0.05)
        plane.stop()
        control_extra = plane.summary()

        # -- live-migration leg -------------------------------------- #
        if fleet.sup.pool_size() < 2:
            # migration needs a survivor to land on
            fleet.add_worker()
        mig_summary = _autoscale_migration_leg(
            args, actuator, fleet, migrate_mod, MetricsRegistry,
            wait_for, failures, migration)

        # -- mesh resize / parole leg (two slots or more) ------------ #
        mesh_summary = _autoscale_mesh_leg(args, actuator, profile,
                                           registry, failures)

        auto = actuator.summary()
        clean = fleet.stop()
        launches = fleet.sup.kernel_launches()

    # -- acceptance ----------------------------------------------------- #
    answered = len(events)
    completed = sum(1 for _t, o in events if o == "completed")
    if answered != submitted:
        failures.append(f"silent loss: {submitted} submitted but only "
                        f"{answered} answered")
    bad = [o for _t, o in events if o != "completed"]
    if bad:
        # "SLOs hold through every resize": a drain that dropped or
        # rejected even one request is an elastic-path failure
        failures.append(f"{len(bad)} requests not completed through "
                        f"the resizes, e.g. {bad[0]}")
    if auto["scale_ups"] < 1 or auto["scale_downs"] < 1:
        failures.append(
            f"capacity did not follow the envelope both directions "
            f"({auto['scale_ups']} ups, {auto['scale_downs']} downs)")
    # the pool must TRACK the envelope: mean size under the peak half vs
    # the trough half of the sinusoid
    peak, trough = [], []
    for t, pool in auto["trace"]:
        phase = math.sin(2.0 * math.pi * (t - t_load) / period)
        if phase > 0.5:
            peak.append(pool)
        elif phase < -0.5:
            trough.append(pool)
    if peak and trough:
        if (sum(peak) / len(peak)) <= (sum(trough) / len(trough)):
            failures.append(
                f"pool did not track the envelope: peak mean "
                f"{sum(peak) / len(peak):.2f} <= trough mean "
                f"{sum(trough) / len(trough):.2f}")
    else:
        failures.append("soak too short to sample both envelope "
                        "phases")
    if auto["chip_seconds"] >= auto["static_chip_seconds"]:
        failures.append(
            f"elasticity saved nothing: {auto['chip_seconds']:.1f} "
            f"chip-seconds vs static "
            f"{auto['static_chip_seconds']:.1f}")
    if not clean:
        failures.append("supervisor shutdown was not clean")

    summary = {
        "soak_s": soak, "submitted": submitted,
        "completed": completed, "device": args.device,
        "calibrated_rps_per_worker": round(measured, 2),
        "calibrated_rps_pool": round(pool_rps, 2),
        "per_unit_rps": fit["per_unit_rps"],
        "base_rate_rps": round(base_rate, 2),
        "scale_ups": auto["scale_ups"],
        "scale_downs": auto["scale_downs"],
        "workers_min": auto["workers_min"],
        "workers_max": auto["workers_max"],
        "chip_seconds": round(auto["chip_seconds"], 1),
        "static_chip_seconds": round(auto["static_chip_seconds"], 1),
        "savings_fraction": round(auto["savings_fraction"], 3),
        "migration": mig_summary,
        "mesh": mesh_summary,
        "clean_exit": clean,
        "kernel_launches": launches,
    }
    print(f"# autoscale summary: {json.dumps(summary)}")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if args.metrics_out:
        from heat2d_tpu_torch.obs.record import write_run_jsonl
        write_run_jsonl(
            registry, args.metrics_out, "autoscale",
            dict(summary, failures=failures,
                 actions=auto["actions"],
                 migrations=auto["migration_rows"]),
            device=args.device,
            more=[("control", control_extra)] if control_extra else ())
    print("autoscale soak " + ("FAILED" if failures else "passed"))
    return (1 if failures else 0,
            dict(summary, failures=failures, trace=auto["trace"],
                 t_load=t_load, actions=auto["actions"]))


def _calibrate(fleet, make_req, conc: int, timeout: float,
               seconds: float = 3.0) -> float:
    """Closed-loop throughput of ``fleet`` at ``conc`` requests in flight
    for ``seconds`` (``make_req(i)`` builds the i-th request), its first
    half second dropped as ramp: req/s, 0.0 if nothing completed."""
    done: list = []
    sem = threading.Semaphore(conc)
    end = time.monotonic() + seconds
    i = 0
    while time.monotonic() < end:
        if not sem.acquire(timeout=0.1):
            continue
        i += 1
        fleet.submit(make_req(i)).add_done_callback(
            lambda f: (done.append(time.monotonic()), sem.release()))
    for _ in range(conc):
        sem.acquire(timeout=timeout + 30)
    # steady state only: drop the first half second as ramp
    t0 = done[0] if done else time.monotonic()
    late = [t for t in done if t - t0 >= 0.5]
    span = (done[-1] - t0 - 0.5) if len(late) >= 2 else 0.0
    return len(late) / span if span > 0 else 0.0


def _autoscale_migration_leg(args, actuator, fleet, migrate_mod,
                             MetricsRegistry, wait_for, failures,
                             migration=None):
    """Prove live migration end to end: a long inverse job attached to
    the highest provisioned slot, that slot retired mid-optimization (the
    actuator's own scale-down path), the resumed job joined and compared
    BITWISE against an oracle that never migrated. ``migration``: the
    job's (problem, iterations, lr); default the JAX CLI's job, 12x12 x
    10 steps recovering its init over 600 iterations, on ``--device``."""
    import numpy as np

    if migration is None:
        import torch

        from heat2d_tpu_torch.diff.adjoint import make_diff_solve
        from heat2d_tpu_torch.diff.inverse import (InverseProblem,
                                                   observation_mask,
                                                   unit_reference_init)
        from heat2d_tpu_torch.utils.device import resolve_device
        nx = ny = 12
        steps, iters, lr = 10, 600, 0.05
        u0 = unit_reference_init(nx, ny)
        dev = resolve_device(args.device)
        with torch.no_grad():
            u_true = make_diff_solve(nx, ny, steps, device=dev)(
                torch.as_tensor(u0, device=dev), 0.1, 0.1).cpu().numpy()
        prob = InverseProblem(nx=nx, ny=ny, steps=steps, target="init",
                              obs_mask=observation_mask(nx, ny, every=1),
                              obs_values=u_true, cx=0.1, cy=0.1,
                              device=args.device)
    else:
        prob, iters, lr = migration
    t0 = time.monotonic()
    # oracle FIRST: warms the runner, so the live job's iteration cadence
    # is steady when the checkpoint lands
    oracle = migrate_mod.run_unmigrated(prob, iterations=iters, lr=lr)
    oracle_s = time.monotonic() - t0
    job_reg = MetricsRegistry()
    job = migrate_mod.InverseJob(prob, iterations=iters, lr=lr,
                                 registry=job_reg).start()
    victim = fleet.sup.provisioned_slots()[-1]
    actuator.attach_job(victim, job)

    def _progress() -> float:
        return job_reg.snapshot()["counters"].get(
            "inverse_iterations_total", 0.0)

    # retire mid-flight: the job must be demonstrably PAST iteration 0
    # and short of done when the drain takes its worker
    wait_for(lambda: _progress() >= 50, 120.0)
    t_retire = time.monotonic()
    row = actuator.retire(victim)
    mig = row.get("migrated") or []
    out = {"victim": victim, "clean_drain": row.get("clean"),
           "migrated": bool(mig), "iterations": iters,
           "oracle_s": oracle_s, "retire_s": time.monotonic() - t_retire}
    if not mig or not mig[0].get("resumed"):
        failures.append("no live migration occurred on retire "
                        f"(row {row})")
        return out
    rec = mig[0]
    out.update(iteration=rec["iteration"], dest=rec["to"],
               wire_bytes=rec["bytes"])
    if not 0 < rec["iteration"] < iters:
        failures.append(f"checkpoint not mid-flight: iteration "
                        f"{rec['iteration']} of {iters}")
    moved = actuator.jobs_on(rec["to"])[-1]
    try:
        moved.join(timeout=600)
    except Exception as e:  # noqa: BLE001 (a soak reports, always)
        failures.append(f"migrated job failed to finish: {e!r}")
        return out
    out["job_s"] = time.monotonic() - t0 - oracle_s
    sol = moved.solution
    if sol is None or sol.paused:
        failures.append("migrated job did not run to completion")
        return out
    bitwise = (
        np.asarray(sol.params).tobytes()
        == np.asarray(oracle.params).tobytes()
        and list(sol.loss_history) == list(oracle.loss_history))
    out["bitwise_vs_oracle"] = bitwise
    if not bitwise:
        failures.append("migrated inverse job is NOT bitwise-identical "
                        "to the unmigrated oracle")
    return out


def _autoscale_mesh_leg(args, actuator, profile, registry, failures):
    """Mesh elasticity over ``--host-device-count`` slots of
    ``--device`` (the port's counterpart of the JAX package's devices):
    voluntary resize down and back up, a quarantine, and a parole; every
    leg bitwise the full-mesh baseline, the serving invariant provable
    throughout, and the paroled slot back in the serving set. The
    requests take the profile's width and method."""
    import numpy as np

    from heat2d_tpu_torch.mesh.degrade import FaultPolicy, serving_invariant
    from heat2d_tpu_torch.mesh.engine import MeshEnsembleEngine
    from heat2d_tpu_torch.parallel.mesh import host_devices
    from heat2d_tpu_torch.serve.schema import SolveRequest

    nd = args.host_device_count
    if nd < 2:
        return {"skipped": f"single-slot mesh (nd={nd})"}
    t0 = time.monotonic()
    engine = MeshEnsembleEngine(registry=registry, fault=FaultPolicy(),
                                devices=host_devices(nd, args.device))
    actuator.mesh_engine = engine
    actuator.health = engine.health
    reqs = [SolveRequest(nx=profile.nx, ny=profile.ny,
                         steps=profile.steps,
                         cx=round(0.07 + 0.001 * i, 6), cy=0.1,
                         method=profile.method) for i in range(2 * nd)]

    def solve_bytes():
        return [np.asarray(u).tobytes()
                for u, _s in engine.solve_batch(reqs)]

    base = solve_bytes()
    legs = {}
    actuator.resize_mesh(nd - 1)
    legs["resized_down"] = solve_bytes()
    actuator.resize_mesh(nd)
    legs["resized_up"] = solve_bytes()
    engine.health.quarantine(nd - 1, "probe_failure")
    legs["degraded"] = solve_bytes()
    parole_rows = actuator.parole_all()
    paroled = [r for r in parole_rows if r["outcome"] == "paroled"]
    if not paroled:
        failures.append(f"parole denied a healthy device "
                        f"({parole_rows})")
    mark = len(engine.launch_log)
    legs["paroled"] = solve_bytes()
    for name, got in legs.items():
        if got != base:
            failures.append(f"mesh leg '{name}' diverged bitwise from "
                            f"the full-mesh baseline")
    inv = serving_invariant(engine.health, engine.launch_log)
    if not inv["ok"]:
        failures.append(f"no_quarantined_serving violated: "
                        f"{inv['violations']}")
    served_after = any(
        (nd - 1) in ((r.get("mesh") or {}).get("devices") or ())
        for r in engine.launch_log[mark:])
    if paroled and not served_after:
        failures.append("paroled device never re-entered the serving "
                        "set")
    return {"devices": nd, "paroled": len(paroled),
            "resizes": len(engine.resize_log),
            "invariant_ok": inv["ok"],
            "paroled_device_served": served_after,
            "launches": len(engine.launch_log),
            "seconds": time.monotonic() - t0}


def _start_rollout(args, plane, validated_path, candidate_path,
                   out, failures):
    """Stage a candidate for the hottest signature (simulated measurement
    backend: the rollout machinery, not kernel speed, is under test) and
    run one safe rollout on a thread beside the live load. Appends to
    ``failures`` / updates ``out`` in place."""
    from heat2d_tpu_torch.control import RolloutConfig

    staged = None
    for sig, _n in plane.retuner.hot_signatures():
        staged = plane.retuner.stage_candidate(sig)
        if staged is not None:
            break
    if staged is None:
        failures.append("control rollout: no tunable hot signature "
                        "to stage")
        return None
    extra = ({"HEAT2D_CHAOS_SLOW_WORKER_S": "0.5"}
             if args.control_bad_candidate else {})
    cfg = RolloutConfig(
        candidate_path=candidate_path, validated_path=validated_path,
        probe_spec={"nx": args.nx, "ny": args.ny, "steps": args.steps,
                    "cx": 0.123, "cy": 0.1, "method": "jnp"},
        observe_s=args.control_observe,
        probe_timeout=args.timeout,
        extra_canary_env=extra)
    print(f"# control: staged candidate epoch {staged['epoch']} for "
          f"{staged['signature']}; starting rollout"
          + (" (bad-candidate injection armed)" if extra else ""))

    def _run():
        out.update(plane.run_rollout(cfg))
        print(f"# control: rollout outcome {out.get('outcome')}")

    t = threading.Thread(target=_run, name="heat2d-control-rollout",
                         daemon=True)
    t.start()
    return t


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


def _write_metrics(args, registry, extra, control=None) -> None:
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
    # the control plane's decisions/rollouts/invariant ride as their own
    # kind="control" record beside the fleet record
    write_run_jsonl(registry, args.metrics_out, "fleet", extra,
                    device=args.device,
                    more=[("control", control)] if control else ())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.log_level:
        import logging
        logging.basicConfig(
            format="%(asctime)s %(name)s %(levelname)s %(message)s")
        logging.getLogger("heat2d_tpu_torch").setLevel(
            getattr(logging, args.log_level.upper()))
    if ((args.control_storm_phase or args.control_bad_candidate)
            and not args.control_rollout):
        # without a rollout there is no storm window and no canary to
        # poison: a soak that "passed" would prove nothing
        print("--control-storm-phase/--control-bad-candidate require "
              "--control-rollout (they act on a live rollout)",
              file=sys.stderr)
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
    if args.autoscale or args.soak is not None:
        try:
            resolve_device(args.device)     # the oracle's, before any spawn
            if args.autoscale:
                return run_autoscale(args, registry)
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
