"""``heat2d-tpu-torch-tune``: run or resume a kernel search on the card,
print the frontier, export or merge dbs. The port of
``heat2d_tpu/tune/cli.py``.

The search loop per shape: build the candidate space (pruned by the
port's own planners before anything launches), skip the points the db
already holds a terminal result for (resume: a killed search loses at
most the point in flight), measure the rest, record every outcome with
an atomic save after each point, then stamp each frontier's best
``(route, bm, tsteps)``, its Mcells/s and its provenance as the entry
the consults (``tune/runtime.py``) look up.

    heat2d-tpu-torch-tune --shapes 4096x4096,640x1024 --db tune_db.json
    heat2d-tpu-torch-tune --shapes 2048x2048 --routes fused --db ...
    heat2d-tpu-torch-tune --selftest --device cpu

``--device cuda`` (the default) measures on the card and raises without
one. On ``--device cpu`` only ``--simulate``, ``--selftest``,
``--merge`` and ``--print`` run: a real search asked of the CPU is
refused, never run quietly on the plain versions. ``--selftest`` runs
the whole loop twice on the simulated backend: the first pass must
write a db with a best per shape and exercise a failure class, the
second must measure nothing, and the printed frontier must match the
stored entries.

The fused route's points time a 2x2 mesh of the problem's shard shape
on ``host_devices(4)`` of ONE card (``measure.FUSED_MESH``): a
decomposition's cost on one card, not a four-card rate; the frontier
says so under their rows.
"""

from __future__ import annotations

import argparse
import os
import sys

from heat2d_tpu_torch.tune import runtime
from heat2d_tpu_torch.tune.db import DB_SCHEMA, TuningDB, current_salt
from heat2d_tpu_torch.tune.measure import (FUSED_MESH, ROUTE_LO,
                                           TERMINAL_STATUSES, WINDOW_S,
                                           SimulatedBackend,
                                           measure_candidate)
from heat2d_tpu_torch.tune.space import (ROUTES, Candidate, Problem,
                                         candidate_space, planner_pick)
from heat2d_tpu_torch.utils.device import resolve_device

DEFAULT_DB = "tune_db.json"
#: The selftest's shapes: one that stays on the chip (the resident
#: route's K), two streamed (the tile route's T and ty; at 8192 columns
#: the deepest tiles stop fitting), each also a fused shard shape.
SELFTEST_SHAPES = ((640, 1024), (4096, 4096), (4096, 8192))
#: The point the selftest's simulated backend fails to "build", so that
#: the compile_error class is exercised end to end.
SELFTEST_BUILD_ERROR = Candidate("tile", 16, 4)
#: What a fused frontier's rows mean (printed under them).
FUSED_NOTE = (f"# fused: a {FUSED_MESH[0]}x{FUSED_MESH[1]} mesh of the "
              f"shard shape on host_devices(4) of one card: a "
              f"decomposition's cost on one card, not a four-card rate")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-tune",
        description="kernel search on the card with a persistent "
                    "per-device tuning database")
    p.add_argument("--shapes", default=None, metavar="LIST",
                   help="comma-separated NXxNY shapes to tune (e.g. "
                        "4096x4096,640x1024); for the fused route the "
                        "shard's shape")
    p.add_argument("--db", default=None, metavar="PATH",
                   help=f"tuning db path (default: ${runtime.ENV_VAR} or "
                        f"./{DEFAULT_DB})")
    p.add_argument("--routes", default=None, metavar="LIST",
                   help="restrict the search to these routes "
                        "(resident,tile,fused; default all)")
    p.add_argument("--t-ladder", default=None, metavar="LIST",
                   help="comma-separated sweep depths of the tile route "
                        "(default 4,8,12,16)")
    p.add_argument("--ty-grid", default=None, metavar="LIST",
                   help="comma-separated tile heights of the tile route "
                        "(multiples of 8; default 16,32,64 and the "
                        "planner's)")
    p.add_argument("--lo", type=int, default=None,
                   help="the two-point marginal's low step count "
                        f"(default per route: {ROUTE_LO})")
    p.add_argument("--window", type=float, default=WINDOW_S, metavar="S",
                   help="the marginal's window in seconds; the high step "
                        "count is picked to give it")
    p.add_argument("--reps", type=int, default=4,
                   help="min-of-reps per step count")
    p.add_argument("--compile-timeout", type=float, default=300.0,
                   metavar="S",
                   help="soft wall on a point's first call (nvcc builds "
                        "there); a point over it records status=timeout "
                        "and is never re-attempted on resume")
    p.add_argument("--probe-past-envelope", action="store_true",
                   help="measure the points the planners prune too (the "
                        "failure class is the datum)")
    p.add_argument("--simulate", action="store_true",
                   help="measure on the deterministic simulated backend "
                        "(search-logic testing; runs on the CPU)")
    p.add_argument("--selftest", action="store_true",
                   help="end-to-end search/db/resume selftest on the "
                        "simulated backend; exit nonzero on any failed "
                        "invariant")
    p.add_argument("--print", dest="print_only", action="store_true",
                   help="print the frontier table from the stored db "
                        "without measuring anything")
    p.add_argument("--merge", nargs="+", default=None, metavar="DB",
                   help="merge these tuning dbs (best entry per device "
                        "kind, shape:dtype, salt) into -o/--out")
    p.add_argument("-o", "--out", default=None, metavar="PATH",
                   help="with --merge: output db path (may equal an "
                        "input)")
    p.add_argument("--export", default=None, metavar="PATH",
                   help="write the db document (pretty JSON) here after "
                        "the run")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write telemetry JSONL (tune_* metric families "
                        "and a kind='tune' run record)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="measure on the card (default); the CPU runs "
                        "only --simulate, --selftest, --merge and "
                        "--print")
    return p


def _parse_shapes(arg: str):
    out = []
    for tok in arg.split(","):
        nx, ny = tok.lower().split("x")
        out.append((int(nx), int(ny)))
    return out


def _ints(arg):
    return [int(v) for v in arg.split(",")] if arg else None


def search_problem(db: TuningDB, problem: Problem, *, backend=None,
                   routes=None, ty_grid=None, t_ladder=None, lo=None,
                   window_s=WINDOW_S, reps=4, compile_timeout_s=300.0,
                   probe_past_envelope=False, registry=None,
                   device="cuda", out=sys.stdout) -> dict:
    """Search one shape, resuming from the db: on ``backend`` (the
    simulated one) when given, else on the card ``device``. Returns
    {"problem", "measured", "cached", "failed", "best" (the plain key's
    best point or None), "fused_best"}."""
    if backend is None:
        device = resolve_device(device)
        if device.type != "cuda":
            raise ValueError("a real search runs on the card; on the CPU "
                             "pass --simulate (or --selftest)")
        kind = runtime.device_kind(device)
        plan_device = device
    else:
        kind, plan_device = backend.device_kind, "cpu"
    key = problem.key()

    def key_for(c):
        # Fused points time a mesh program: their own frontier, so that
        # neither they nor the single-grid best shadow the other.
        return problem.fused_key() if c.route == "fused" else key

    cands, pruned = candidate_space(
        problem, routes=routes, ty_grid=ty_grid, t_ladder=t_ladder,
        probe_past_envelope=probe_past_envelope, device=plan_device)
    keys = (key, problem.fused_key())
    # A prune note never clobbers a real measurement (a prior
    # --probe-past-envelope run may hold data for points the planners
    # refuse).
    measured_already = {
        k: db.measured_keys(kind, k, ("ok", "oom", "compile_error",
                                      "timeout", "error"))
        for k in keys}
    wrote_pruned = False
    for c, reason in pruned:
        if (c.route, c.bm, c.tsteps) in measured_already[key_for(c)]:
            continue
        db.record_point(kind, key_for(c),
                        {"route": c.route, "bm": c.bm, "tsteps": c.tsteps,
                         "status": "pruned", "error": reason})
        wrote_pruned = True
    if wrote_pruned:
        db.save()
    # Under --probe-past-envelope a pruned point is what was asked for:
    # only real outcomes count as terminal then.
    terminal = (tuple(s for s in TERMINAL_STATUSES if s != "pruned")
                if probe_past_envelope else TERMINAL_STATUSES)
    done = {k: db.measured_keys(kind, k, terminal) for k in keys}
    measured = failed = cached = 0
    card = None
    if backend is None:
        from heat2d_tpu_torch.utils.device import nvidia_smi_query
        card = nvidia_smi_query("name,power.limit")
    for c in cands:
        if (c.route, c.bm, c.tsteps) in done[key_for(c)]:
            cached += 1
            continue
        outc = measure_candidate(
            problem, c, backend=backend, lo=lo, reps=reps,
            window_s=window_s, compile_timeout_s=compile_timeout_s,
            registry=registry, device=device)
        point = outc.to_point()
        if card is not None:
            point["card"] = card      # the name and power limit it ran at
        db.record_point(kind, key_for(c), point)
        db.save()          # crash-safe resume: one point at risk
        measured += 1
        if outc.status != "ok":
            failed += 1
            print(f"  {key_for(c):>24} {c.label():<20} "
                  f"{outc.status}: {outc.error}", file=out)
        else:
            print(f"  {key_for(c):>24} {c.label():<20} "
                  f"step={outc.step_time_s:.3e}s "
                  f"{outc.mcells_per_s:12.1f} Mcells/s", file=out)
    if registry is not None and cached:
        registry.counter("tune_points_cached_total", value=cached)

    bests = {}
    for k in keys:
        entry = db.entry(kind, k)
        ok_points = [p for p in (entry or {}).get("points", [])
                     if p.get("status") == "ok"]
        if not ok_points:
            continue
        k_best = max(ok_points, key=lambda p: p["mcells_per_s"])
        db.set_best(kind, k,
                    {"route": k_best["route"], "bm": k_best["bm"],
                     "tsteps": k_best["tsteps"]},
                    k_best["mcells_per_s"],
                    _provenance(backend, lo, window_s, reps, k_best))
        db.save()
        if registry is not None:
            registry.gauge("tune_best_mcells_per_s",
                           k_best["mcells_per_s"], shape=k)
        bests[k] = k_best
    return {"problem": key, "measured": measured, "cached": cached,
            "failed": failed, "best": bests.get(key),
            "fused_best": bests.get(problem.fused_key())}


def _provenance(backend, lo, window_s, reps, best: dict) -> dict:
    """Where a best came from: the protocol and its spans, the backend,
    the salt, a timestamp and, on the card, its name and power limit and
    the torch and CUDA versions."""
    import datetime

    import torch

    prov = {
        "protocol": (f"two-point marginal: low step count "
                     f"{lo or ROUTE_LO}, high picked for a {window_s}s "
                     f"window, min of {reps}"),
        "spans": best.get("steps"),
        "backend": "simulated" if backend is not None else "device",
        "salt": current_salt(),
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }
    if backend is None:
        from heat2d_tpu_torch.utils.device import nvidia_smi_query
        prov.update(card=nvidia_smi_query("name,power.limit"),
                    torch_version=torch.__version__,
                    cuda_version=torch.version.cuda)
    if best.get("route") == "fused":
        prov["mesh"] = (f"{FUSED_MESH[0]}x{FUSED_MESH[1]} slots on one "
                        f"card")
    return prov


def frontier_table(db: TuningDB, device_kind: str) -> str:
    """The stored frontier: one row per (shape, measured point), ok
    points ranked by rate, the stamped best tagged. Everything printed
    comes from the db, so the table doubles as a dump to diff against
    the entries."""
    lines = [f"# tuning frontier — {device_kind} "
             f"(salt {current_salt()})",
             f"{'shape:dtype':>20} {'route':<5} {'bm':>4} {'T':>3} "
             f"{'step (s)':>11} {'Mcells/s':>10}  status"]
    entries = (db.data["devices"].get(device_kind, {})
               .get("entries", {}))
    fused = False
    for key in sorted(entries):
        e = db.entry(device_kind, key)
        if e is None:
            continue
        fused |= key.startswith("fused:")
        best = e.get("best") or {}
        vtag = ""
        if "validated" in e or "epoch" in e:
            # an entry without 'validated' is the incumbent: validated
            kind_tag = ("validated" if e.get("validated", True)
                        else "candidate")
            vtag = f" [{kind_tag} e{int(e.get('epoch', 0))}]"
        pts = sorted(e.get("points", []),
                     key=lambda p: -(p.get("mcells_per_s") or 0))
        for p in pts:
            is_best = (best and p.get("status") == "ok"
                       and (p["route"], p["bm"], p["tsteps"])
                       == (best.get("route"), best.get("bm"),
                           best.get("tsteps")))
            st = p.get("step_time_s")
            mc = p.get("mcells_per_s")
            lines.append(
                f"{key:>20} {p.get('route', '?'):<5} "
                f"{p.get('bm', 0):>4} {p.get('tsteps', 0):>3} "
                f"{f'{st:.3e}' if st is not None else '—':>11} "
                f"{f'{mc:.1f}' if mc is not None else '—':>10}  "
                f"{p.get('status')}"
                f"{'  <-- best' + vtag if is_best else ''}")
    if fused:
        lines.append(FUSED_NOTE)
    return "\n".join(lines)


def planner_rows(db: TuningDB, device_kind: str, problem: Problem,
                 device="cpu") -> list:
    """One row per route measured ok on ``problem``: the planner's own
    point of that route and its stored row beside the route's best row,
    and whether that is the frontier's best. What a search bought over
    the static plan, read from the db alone."""
    out = []
    for route in ROUTES:
        key = problem.fused_key() if route == "fused" else problem.key()
        e = db.entry(device_kind, key) or {}
        ok = [p for p in e.get("points", [])
              if p["route"] == route and p.get("status") == "ok"]
        if not ok:
            continue
        pick = planner_pick(problem, route, device)
        best = max(ok, key=lambda p: p["mcells_per_s"])
        at = {(p["bm"], p["tsteps"]): p for p in ok}
        out.append({"key": key, "route": route, "planner": pick.label(),
                    "planner_point": at.get((pick.bm, pick.tsteps)),
                    "route_best": best,
                    "is_best": (e.get("best") or {}) == {
                        k: best[k] for k in ("route", "bm", "tsteps")}})
    return out


def run_search(args, registry=None, out=sys.stdout) -> int:
    backend = SimulatedBackend() if args.simulate else None
    if backend is None and args.device == "cpu":
        print("a real search runs on the card (--device cuda); on the "
              "CPU pass --simulate, --selftest, --merge or --print",
              file=sys.stderr)
        return 2
    db_path = args.db or os.environ.get(runtime.ENV_VAR, DEFAULT_DB)
    db = TuningDB(db_path)
    kind = (backend.device_kind if backend is not None
            else runtime.device_kind(args.device))
    shapes = _parse_shapes(args.shapes) if args.shapes else [(4096, 4096)]
    routes = args.routes.split(",") if args.routes else None
    print(f"# search on {kind}; db={db_path} (salt {current_salt()})",
          file=out)
    totals = {"measured": 0, "cached": 0, "failed": 0}
    for nx, ny in shapes:
        s = search_problem(
            db, Problem(nx, ny), backend=backend, routes=routes,
            ty_grid=_ints(args.ty_grid), t_ladder=_ints(args.t_ladder),
            lo=args.lo, window_s=args.window, reps=args.reps,
            compile_timeout_s=args.compile_timeout,
            probe_past_envelope=args.probe_past_envelope,
            registry=registry, device=args.device, out=out)
        for k in totals:
            totals[k] += s[k]
        for name in ("best", "fused_best"):
            b = s[name]
            if b is not None:
                print(f"# {s['problem']} {name}: {b['route']} "
                      f"bm={b['bm']} T={b['tsteps']} "
                      f"{b['mcells_per_s']:.1f} Mcells/s", file=out)
        print(f"# {s['problem']}: measured {s['measured']}, cached "
              f"{s['cached']}, failed {s['failed']}", file=out)
    print(frontier_table(db, kind), file=out)
    print(f"# totals: measured={totals['measured']} "
          f"cached={totals['cached']} failed={totals['failed']}",
          file=out)
    if args.export:
        from heat2d_tpu_torch.io.binary import write_json_atomic
        write_json_atomic(db.data, args.export, sort_keys=True)
        print(f"# exported db to {args.export}", file=out)
    _write_metrics(args, registry, totals)
    return 0


def run_selftest(args, registry=None) -> int:
    """Search -> db -> resume -> frontier, all on the simulated backend.
    Asserts: a db file with a stamped best per shape and a fused best; a
    failure class exercised; a second run that is a pure cache hit; the
    frontier's best rows equal to the stored entries; the simulated
    backend reproducing its stored step times."""
    import tempfile

    backend = SimulatedBackend(build_error=SELFTEST_BUILD_ERROR)
    db_path = args.db or os.path.join(tempfile.mkdtemp("heat2d-tune"),
                                      "tune_db.json")
    if os.path.exists(db_path):
        # The invariants assume a cold start (the first pass must
        # measure, the second must not): the path is the selftest's own.
        os.remove(db_path)
        print(f"# selftest: removed pre-existing db at {db_path} "
              f"(cold-start invariants)")
    failures = []
    shapes = (_parse_shapes(args.shapes) if args.shapes
              else SELFTEST_SHAPES)

    def search_all(db):
        # probe_past_envelope: the planners' rejects are measured (the
        # simulated backend raises its OOM), exercising the failure
        # classes end to end.
        return [search_problem(db, Problem(nx, ny), backend=backend,
                               probe_past_envelope=True,
                               registry=registry)
                for nx, ny in shapes]

    first = search_all(TuningDB(db_path))
    if not os.path.exists(db_path):
        failures.append(f"no db written at {db_path}")
    if not any(s["measured"] for s in first):
        failures.append("first pass measured nothing")
    if any(s["best"] is None for s in first):
        failures.append(f"a shape has no best config: {first}")
    if not any(s["fused_best"] for s in first):
        failures.append("no fused frontier stamped a best under a "
                        "fused: key")
    kind = backend.device_kind
    statuses = {p.get("status") for nx, ny in shapes
                for k in (Problem(nx, ny).key(), Problem(nx, ny).fused_key())
                for p in (TuningDB(db_path).entry(kind, k) or {})
                .get("points", [])}
    for want in ("oom", "compile_error"):
        if want not in statuses:
            failures.append(f"no candidate exercised the {want} class "
                            f"(statuses {sorted(statuses)})")

    # Resume: a fresh db object on the same file skips every point.
    db2 = TuningDB(db_path)
    second = search_all(db2)
    if any(s["measured"] for s in second):
        failures.append(f"second run re-measured points: {second}")
    if not all(s["cached"] for s in second):
        failures.append("second run reported no cached points")

    table = frontier_table(db2, kind)
    print(table)
    for nx, ny in shapes:
        e = db2.entry(kind, Problem(nx, ny).key())
        b = (e or {}).get("best")
        if not b:
            failures.append(f"no stored best for {nx}x{ny}")
            continue
        want = f"{b['route']:<5} {b['bm']:>4} {b['tsteps']:>3}"
        tagged = [ln for ln in table.splitlines()
                  if "<-- best" in ln
                  and ln.lstrip().startswith(f"{nx}x{ny}:")]
        if len(tagged) != 1 or want not in tagged[0]:
            failures.append(
                f"frontier best row for {nx}x{ny} does not match the "
                f"stored entry {b}: {tagged}")

    # Determinism: a drifting model would silently break resume.
    probe = Problem(*shapes[-1])
    for p in db2.entry(kind, probe.key())["points"]:
        if p["status"] != "ok":
            continue
        again = measure_candidate(
            probe, Candidate(p["route"], p["bm"], p["tsteps"]),
            backend=backend)
        if again.step_time_s != p["step_time_s"]:
            failures.append(f"simulated backend non-deterministic at "
                            f"{p}")
            break

    summary = {"measured": sum(s["measured"] for s in first),
               "cached_on_resume": sum(s["cached"] for s in second),
               "failures": failures}
    print(f"# selftest: measured {summary['measured']} points, resume "
          f"cached {summary['cached_on_resume']}, db at {db_path}")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    _write_metrics(args, registry, summary)
    print("selftest " + ("FAILED" if failures else "passed"), flush=True)
    return 1 if failures else 0


def _write_metrics(args, registry, extra) -> None:
    from heat2d_tpu_torch.obs.record import write_run_jsonl
    write_run_jsonl(registry, args.metrics_out, "tune", extra,
                    device="cpu" if args.simulate or args.selftest
                    else args.device)


def run_merge(args, out=sys.stdout) -> int:
    """``--merge a.json b.json -o out.json``: consolidate per-worker dbs.
    Inputs load with the normal corruption tolerance (a torn db
    contributes nothing, flagged in the exit code); the output commits
    atomically and starts empty, so it is exactly the merge of the named
    inputs."""
    if not args.out:
        print("--merge requires -o/--out PATH", file=sys.stderr)
        return 2
    merged = TuningDB(args.out)
    merged.data = {"schema": DB_SCHEMA, "devices": {}}
    merged.corrupt = False
    rc = 0
    for path in args.merge:
        src = TuningDB(path)
        if src.corrupt or (not src.data["devices"]
                           and not os.path.exists(path)):
            print(f"# {path}: unreadable or missing — contributed "
                  f"nothing", file=out)
            rc = 1
            continue
        s = merged.merge(src)
        print(f"# {path}: +{s['entries_added']} entries, "
              f"{s['entries_merged']} merged "
              f"(+{s['points_added']} points), "
              f"{s['entries_kept']} kept", file=out)
    merged.save()
    n = nv = 0
    for d in merged.data["devices"].values():
        for e in d.get("entries", {}).values():
            n += 1
            nv += bool(e.get("validated"))
    print(f"# wrote {args.out}: {n} entries across "
          f"{len(merged.data['devices'])} device kinds"
          f" ({nv} validated)", file=out)
    return rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    registry = None
    if args.metrics_out:
        from heat2d_tpu_torch.obs import MetricsRegistry
        registry = MetricsRegistry()
    if args.merge:
        return run_merge(args)
    if args.selftest:
        return run_selftest(args, registry)
    if args.print_only:
        db = TuningDB(args.db
                      or os.environ.get(runtime.ENV_VAR, DEFAULT_DB))
        kinds = db.device_kinds() or [
            SimulatedBackend.device_kind if args.simulate
            else runtime.device_kind(args.device)]
        for kind in kinds:
            print(frontier_table(db, kind))
        return 0
    return run_search(args, registry)


if __name__ == "__main__":
    sys.exit(main())
