"""``heat2d-tpu-torch-load`` — trace-driven load generation, latency/
throughput surfaces, capacity fitting, and the serving-regression
gate. The port's copy of ``heat2d_tpu/load/cli.py`` (docs/LOADGEN.md
describes both), with its flags, record keys and failure texts.

One flag differs: ``--device cuda|cpu`` (default ``cuda``) replaces the
JAX CLI's ``--platform``, whose default is the CPU because the JAX gate
is a logic/serving gate, not a kernel bench. The port's entry points run
on the card unless the caller asks for the CPU: the serve target, and
every fleet worker (its ``--device`` flag), serve on ``--device``, so a
surface measured here is the card's. Without a card, ``--device cuda``
exits 1 with ``DeviceUnavailableError``'s text before any target
starts; it never serves from the CPU.

Modes compose left to right:

- **source** — ``--replay DIR`` (a recorded trace campaign's arrival
  process, gaps preserved) or ``--profile NAME`` (a seeded synthetic
  mix from ``load/synth.PROFILES``) at ``--rate``/``--duration`` (or
  a ``--sweep`` of rates);
- **target** — ``--target serve`` (in-process SolveServer) or
  ``--target fleet --workers N`` (supervised worker pool with the
  profile's tenant quotas);
- **measure** — each point runs open-loop, producing a surface row
  (offered/achieved req/s, latency quantiles, shed rate, SLO
  evaluation) and the capacity fit over all rows;
- **gate** — ``--gate --baseline FILE`` compares the surface+fit
  against a committed baseline and exits 1 on regression;
  ``--write-baseline FILE`` records a new one.

``--chaos-slow S`` seeds a DELIBERATE regression (fleet workers get
``HEAT2D_CHAOS_SLOW_WORKER_S``; serve targets an in-process launch-
latency campaign) — how CI proves the gate actually fires. ``--max-
skew S`` fails the run when replay fidelity (p99 intended-vs-actual
submit skew) exceeds S — the closed-loop proof a replayed schedule
reproduced the recorded gaps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from heat2d_tpu_torch.utils.logs import add_log_level_flag, configure_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-load",
        description="load generation + capacity model + serving-"
                    "regression gate (docs/LOADGEN.md)")
    src = p.add_argument_group("traffic source")
    src.add_argument("--replay", default=None, metavar="DIR",
                     help="replay the arrival process recorded in a "
                          "--trace-dir campaign (spans-*.jsonl)")
    src.add_argument("--profile", default=None, metavar="NAME",
                     help="synthesize a named mix (load/synth.py: "
                          "uniform, zipf, bursty, diurnal, "
                          "multitenant, inverse_heavy, production, "
                          "smoke)")
    src.add_argument("--rate", type=float, default=8.0, metavar="RPS",
                     help="base arrival rate for --profile")
    src.add_argument("--sweep", default=None, metavar="R1,R2,...",
                     help="sweep offered rates (overrides --rate) to "
                          "map the latency/throughput surface")
    src.add_argument("--duration", type=float, default=5.0,
                     metavar="S", help="schedule length per point")
    src.add_argument("--seed", type=int, default=0)
    src.add_argument("--speedup", type=float, default=1.0,
                     help="compress the schedule Nx (replay at 2.0 = "
                          "twice production speed)")
    src.add_argument("--limit", type=int, default=None,
                     help="cap arrivals per point")
    tgt = p.add_argument_group("target")
    tgt.add_argument("--target", default="serve",
                     choices=["serve", "fleet"])
    tgt.add_argument("--mesh", action="store_true",
                     help="serve through the mesh-aware engine "
                          "(heat2d_tpu_torch/mesh): --target serve "
                          "gets a MeshEnsembleEngine in-process, --target "
                          "fleet arms HEAT2D_MESH_SERVE=1 on every "
                          "worker; the capacity fit gains the "
                          "chips_per_unit dimension (docs/LOADGEN.md)")
    tgt.add_argument("--workers", type=int, default=2,
                     help="fleet worker subprocesses")
    tgt.add_argument("--max-inflight", type=int, default=256)
    tgt.add_argument("--timeout", type=float, default=30.0,
                     help="per-request deadline")
    slo = p.add_argument_group("SLO objectives (docs/OBSERVABILITY.md)")
    slo.add_argument("--slo-p99", type=float, default=None,
                     metavar="S")
    slo.add_argument("--slo-error-budget", type=float, default=0.001,
                     metavar="F")
    g = p.add_argument_group("gate (docs/LOADGEN.md)")
    g.add_argument("--baseline", default=None, metavar="JSON",
                   help="committed baseline surface to gate against")
    g.add_argument("--gate", action="store_true",
                   help="exit 1 when the measured surface regresses "
                        "past the margins vs --baseline")
    g.add_argument("--write-baseline", default=None, metavar="JSON",
                   help="record the measured surface as a baseline")
    g.add_argument("--gate-throughput-margin", type=float, default=0.3)
    g.add_argument("--gate-p99-factor", type=float, default=3.0)
    g.add_argument("--gate-p99-slack", type=float, default=0.25,
                   metavar="S")
    g.add_argument("--gate-shed-slack", type=float, default=0.05)
    g.add_argument("--gate-capacity-margin", type=float, default=0.5)
    p.add_argument("--chaos-slow", type=float, default=None,
                   metavar="S",
                   help="seed a regression: sleep S inside every "
                        "request pickup (fleet workers) / launch "
                        "(serve) — the gate must catch it")
    p.add_argument("--max-skew", type=float, default=None, metavar="S",
                   help="fail unless replay fidelity holds: p99 "
                        "|actual - intended| submit skew <= S")
    p.add_argument("--selftest", action="store_true",
                   help="seeded-determinism + in-process serving "
                        "smoke; exits nonzero on any failure")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write telemetry JSONL (load_* families + "
                        "the kind='load' run record)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="serve on the CUDA card (default) or, with the "
                        "plain PyTorch versions of the kernels, the CPU; "
                        "fleet workers take the same device")
    add_log_level_flag(p)
    return p


def _schedules(args) -> list:
    """[(label, Schedule)] — one per sweep point."""
    from heat2d_tpu_torch.load import replay as replay_mod
    from heat2d_tpu_torch.load import synth

    if args.replay:
        sched = replay_mod.schedule_from_trace_dir(
            args.replay, seed=args.seed, limit=args.limit)
        return [("replay", sched)]
    profile = synth.PROFILES.get(args.profile or "uniform")
    if profile is None:
        raise SystemExit(f"unknown --profile {args.profile!r} "
                         f"(known: {sorted(synth.PROFILES)})")
    rates = ([float(r) for r in args.sweep.split(",")]
             if args.sweep else [args.rate])
    return [(f"{r:g}rps",
             synth.synthesize(profile, r, args.duration,
                              seed=args.seed,
                              max_arrivals=args.limit))
            for r in rates]


def _drop_inverse_for_fleet(args, schedules) -> list:
    """The fleet wire carries solve specs only (fleet/wire.py): an
    inverse arrival cannot be dispatched to a worker, so fleet runs
    drop them with a visible count rather than polluting the outcome
    stats with structured rejections that measure nothing."""
    if args.target != "fleet":
        return schedules
    from heat2d_tpu_torch.load.schedule import Schedule
    out = []
    for label, sched in schedules:
        solves = [a for a in sched if a.kind == "solve"]
        dropped = len(sched) - len(solves)
        if dropped:
            print(f"# {label}: dropped {dropped} inverse arrival(s) — "
                  "the fleet wire is solve-only (docs/LOADGEN.md)",
                  file=sys.stderr)
            sched = Schedule(solves, meta=dict(
                sched.meta, inverse_dropped=dropped))
        out.append((label, sched))
    return out


def _make_target(args, registry, profile=None):
    from heat2d_tpu_torch.load.runner import FleetTarget, ServeTarget
    if args.target == "fleet":
        env = {}
        if args.chaos_slow:
            env["HEAT2D_CHAOS_SLOW_WORKER_S"] = str(args.chaos_slow)
        quotas = (profile.quotas(args.max_inflight)
                  if profile is not None else None)
        return FleetTarget(workers=args.workers, registry=registry,
                           quotas=quotas,
                           max_inflight=args.max_inflight, env=env,
                           default_timeout=args.timeout,
                           mesh=args.mesh, device=args.device)
    if args.chaos_slow:
        from heat2d_tpu_torch.resil import chaos
        chaos.install(chaos.ChaosConfig(
            launch_latency_s=args.chaos_slow))
    return ServeTarget(registry=registry, mesh=args.mesh,
                       device=args.device)


def _surface_markdown(rows: list, fit: dict) -> str:
    lines = [
        "| offered rps | achieved rps | p50 | p99 | shed | slo "
        "| skew p99 |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lat = r.get("latency") or {}
        lines.append(
            f"| {r['offered_rps']:g} | {r['achieved_rps']:g} "
            f"| {lat.get('p50', float('nan')):.4g} "
            f"| {lat.get('p99', float('nan')):.4g} "
            f"| {r['shed_rate']:.3g} "
            f"| {'ok' if r.get('slo_ok', True) else 'VIOLATED'} "
            f"| {r['fidelity']['p99_skew_s']:.4g} |")
    sat = ("saturated" if fit["saturated"]
           else "LOWER BOUND — sweep never saturated")
    lines.append(
        f"\ncapacity: {fit['max_sustainable_rps']:g} rps sustainable "
        f"over {fit['units']} unit(s) ({fit['per_unit_rps']:g} "
        f"rps/unit, {sat})")
    return "\n".join(lines)


def run_load(args, registry) -> int:
    from heat2d_tpu_torch.load import capacity as cap_mod
    from heat2d_tpu_torch.load import gate as gate_mod
    from heat2d_tpu_torch.load import synth
    from heat2d_tpu_torch.load.runner import measure_point
    from heat2d_tpu_torch.obs.slo import SLOPolicy

    failures = []
    schedules = _drop_inverse_for_fleet(args, _schedules(args))
    profile = (synth.PROFILES.get(args.profile)
               if args.profile else None)
    policy = (SLOPolicy(latency_p99_s=args.slo_p99,
                        error_budget=args.slo_error_budget)
              if args.slo_p99 is not None else None)

    target = _make_target(args, registry, profile=profile)
    rows = []
    try:
        for label, sched in schedules:
            print(f"# point {label}: {len(sched)} arrivals over "
                  f"{sched.duration():.1f}s "
                  f"(offered {sched.offered_rps():.1f} rps"
                  + (f", speedup {args.speedup:g}x"
                     if args.speedup != 1.0 else "") + ")")
            row = measure_point(sched, target,
                                speedup=args.speedup,
                                timeout=args.timeout,
                                slo_policy=policy)
            point_reg = row.pop("_registry")
            row["label"] = label
            row["schedule"] = sched.summary()
            rows.append(row)
            if registry is not None:
                point = f"{row['offered_rps']:g}"
                registry.gauge("load_offered_rps",
                               row["offered_rps"], point=point)
                registry.gauge("load_achieved_rps",
                               row["achieved_rps"], point=point)
                registry.gauge("load_shed_rate", row["shed_rate"],
                               point=point)
                for labels, v in point_reg.find_counters(
                        "load_requests_total").items():
                    registry.counter("load_requests_total", v,
                                     point=point, **dict(labels))
            if row["unanswered"]:
                failures.append(
                    f"{label}: {row['unanswered']} request(s) never "
                    f"answered within the drain timeout")
    finally:
        target.close()
        if args.chaos_slow and args.target == "serve":
            # the in-process campaign must not outlive the run (the
            # fleet flavor dies with its worker processes)
            from heat2d_tpu_torch.resil import chaos
            chaos.uninstall()

    units = getattr(target, "units", 1)
    fit = cap_mod.fit_capacity(
        rows, units,
        chips_per_unit=getattr(target, "chips_per_unit", 1))
    if registry is not None:
        registry.gauge("load_capacity_rps",
                       fit["max_sustainable_rps"])
        registry.gauge("load_capacity_per_unit_rps",
                       fit["per_unit_rps"])
        registry.gauge("load_capacity_per_chip_rps",
                       fit["per_chip_rps"])
    print(_surface_markdown(rows, fit))

    if args.max_skew is not None:
        for r in rows:
            skew = r["fidelity"]["p99_skew_s"]
            if skew > args.max_skew:
                failures.append(
                    f"{r['label']}: replay fidelity broke — p99 "
                    f"submit skew {skew:.4g}s > --max-skew "
                    f"{args.max_skew:g}s")

    gate_result = None
    if args.write_baseline:
        from heat2d_tpu_torch.io.binary import write_json_atomic
        base = gate_mod.build_baseline(
            rows, fit, meta={
                "profile": args.profile, "replay": args.replay,
                "target": args.target, "workers": args.workers,
                "mesh": args.mesh,
                "seed": args.seed, "duration_s": args.duration,
                "slo_p99_s": args.slo_p99})
        write_json_atomic(base, args.write_baseline)
        print(f"# wrote baseline {args.write_baseline} "
              f"({len(base['rows'])} point(s))")
    if args.gate:
        if not args.baseline:
            failures.append("--gate needs --baseline FILE")
        else:
            try:
                with open(args.baseline) as f:
                    base = json.load(f)
            except (OSError, ValueError) as e:
                base, gate_failures = None, [
                    f"unreadable baseline {args.baseline}: {e}"]
            if base is not None:
                margins = gate_mod.GateMargins(
                    throughput_margin=args.gate_throughput_margin,
                    p99_factor=args.gate_p99_factor,
                    p99_slack_s=args.gate_p99_slack,
                    shed_slack=args.gate_shed_slack,
                    capacity_margin=args.gate_capacity_margin)
                gate_failures = gate_mod.compare(rows, fit, base,
                                                 margins)
            gate_result = {"baseline": args.baseline,
                           "passed": not gate_failures,
                           "failures": gate_failures}
            failures.extend(gate_failures)

    _write_metrics(args, registry, rows, fit, gate_result, failures)
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    print("load " + ("FAILED" if failures else "passed"))
    return 1 if failures else 0


def _write_metrics(args, registry, rows, fit, gate_result,
                   failures) -> None:
    from heat2d_tpu_torch.obs.record import write_run_jsonl
    extra = {
        "source": ("replay" if args.replay
                   else f"profile:{args.profile or 'uniform'}"),
        "target": args.target,
        "mesh": args.mesh,
        "workers": (args.workers if args.target == "fleet" else 1),
        "speedup": args.speedup,
        "seed": args.seed,
        "surface": [{k: v for k, v in r.items() if k != "slo"}
                    for r in rows],
        "slo": [r.get("slo", []) for r in rows],
        "capacity": fit,
        "gate": gate_result,
        "chaos_slow_s": args.chaos_slow,
        "failures": list(failures),
    }
    write_run_jsonl(registry, args.metrics_out, "load", extra,
                    device=args.device)


def run_selftest(args, registry) -> int:
    """Seeded determinism + an in-process serving smoke: the
    properties every other mode builds on, provable in seconds on the
    CPU (``--device cpu``)."""
    from heat2d_tpu_torch.load import capacity as cap_mod
    from heat2d_tpu_torch.load import synth
    from heat2d_tpu_torch.load.runner import ServeTarget, measure_point
    from heat2d_tpu_torch.load.schedule import Schedule

    failures = []
    a = synth.synthesize(synth.PROFILES["smoke"], 20.0, 2.0, seed=7)
    b = synth.synthesize(synth.PROFILES["smoke"], 20.0, 2.0, seed=7)
    c = synth.synthesize(synth.PROFILES["smoke"], 20.0, 2.0, seed=8)
    if a.fingerprint() != b.fingerprint():
        failures.append("same seed produced different schedules")
    if a.fingerprint() == c.fingerprint():
        failures.append("different seeds produced identical "
                        "schedules")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sched.jsonl")
        a.to_jsonl(path)
        if Schedule.from_jsonl(path).fingerprint() != a.fingerprint():
            failures.append("schedule JSONL round-trip drifted")

    target = ServeTarget(registry=registry, device=args.device)
    try:
        row = measure_point(a, target, timeout=60.0)
        row.pop("_registry")
    finally:
        target.close()
    if row["unanswered"]:
        failures.append(f"{row['unanswered']} selftest request(s) "
                        "unanswered")
    if row["completed"] < 1:
        failures.append("no request completed")
    fit = cap_mod.fit_capacity([row], getattr(target, "units", 1))
    if fit["max_sustainable_rps"] <= 0 and not row["shed"]:
        failures.append("capacity fit found no sustainable point on "
                        "a healthy run")
    print(f"selftest: {row['arrivals']} arrivals -> "
          f"{row['completed']} completed, achieved "
          f"{row['achieved_rps']:g} rps, fit "
          f"{fit['max_sustainable_rps']:g} rps")
    _write_metrics(args, registry, [row], fit, None, failures)
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    print("selftest " + ("FAILED" if failures else "passed"))
    return 1 if failures else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure_logging(args.log_level)
    from heat2d_tpu_torch.fleet.supervisor import WorkerStartError
    from heat2d_tpu_torch.obs import MetricsRegistry
    from heat2d_tpu_torch.utils.device import (DeviceUnavailableError,
                                               resolve_device)
    registry = MetricsRegistry()
    if args.selftest or args.replay or args.profile or args.sweep:
        try:
            resolve_device(args.device)     # before any target starts
            if args.selftest:
                return run_selftest(args, registry)
            return run_load(args, registry)
        except (DeviceUnavailableError, WorkerStartError) as e:
            print(f"{e}\nQuitting...", file=sys.stderr)
            return 1
    print("nothing to do: pass --selftest, --replay DIR, or "
          "--profile NAME [--sweep R1,R2,...] (docs/LOADGEN.md)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
