"""``heat2d-tpu-torch-serve``: the serving command of the port (the
counterpart of ``heat2d-tpu-serve``).

- ``--selftest``: start an in-process server, fire a small mixed workload
  through the synchronous client (same-shape batching, mixed-shape
  buckets, duplicate single-flight, a cache-hit repeat, an ``adi``
  request and its bitwise cache-hit repeat, one request of every problem
  family, and ``reactdiff`` x ``adi``, which must come back as
  ``Rejected("unsupported_combination")``), then check the serving
  invariants: fewer launches than requests, a launch that held more than
  one member, a cache hit, bitwise-identical cached and coalesced
  results, a launch counted for every family, the structured rejection.
  Exit 0 iff every check holds.
- ``--requests FILE.jsonl``: serve a file of request dicts (one JSON
  object per line), writing one result or rejection summary per line to
  stdout or ``--results-out``.

``--mesh`` serves through the mesh engine (``mesh.MeshEnsembleEngine``)
over the visible cards of ``--device``, or over ``--host-device-count N``
slots sharing them: buckets split their members over the slots, huge
grids take the spatial route, and ``--max-batch`` bounds the members per
slot. ``--mesh-admission-mcells R`` arms modeled-capacity admission at R
Mcells/s a slot, ``--mesh-stall-deadline S`` the stall watchdog and
``--mesh-abft`` the ABFT verify tier; each of them without ``--mesh``
is a usage error (exit 2).

``--metrics-out PATH`` writes the metrics snapshot and a ``kind="serve"``
run record as JSONL; ``--log-level`` sets the port's loggers' level.
``--trace-dir DIR`` arms request tracing (each request's admission,
queue and launch spans; merge with ``heat2d-tpu-torch-trace DIR``),
``--perf`` the cost cards (persisted beside the spans with
``--trace-dir``), ``--slo-p99 S`` and ``--slo-error-budget F`` the
per-signature SLO evaluation; the record gains ``trace``, ``perf`` and
``slo`` as the JAX serve CLI's does. ``HEAT2D_FLIGHT_DIR`` arms the crash
flight recorder.
``--device cpu`` runs the plain PyTorch versions of the kernels on the
CPU; without it the server runs on the card and refuses to start where
there is none.

    heat2d-tpu-torch-serve --selftest --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from heat2d_tpu_torch.utils.device import DeviceUnavailableError
from heat2d_tpu_torch.utils.logs import add_log_level_flag, configure_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-serve",
        description="solve serving on PyTorch/CUDA: async queue, shape-"
                    "bucketed micro-batching onto the ensemble kernels, "
                    "content-addressed result cache")
    p.add_argument("--selftest", action="store_true",
                   help="run the in-process mixed-workload smoke test and "
                        "exit nonzero on any serving-invariant failure")
    p.add_argument("--requests", default=None, metavar="JSONL",
                   help="serve a file of request dicts, one JSON object "
                        "per line")
    p.add_argument("--results-out", default=None, metavar="PATH",
                   help="with --requests: write result summaries here "
                        "instead of stdout")
    s = p.add_argument_group("scheduler tuning")
    s.add_argument("--max-batch", type=int, default=8,
                   help="members per ensemble launch (a bucket dispatches "
                        "when full)")
    s.add_argument("--max-delay", type=float, default=0.005, metavar="S",
                   help="longest a bucket's oldest request waits before "
                        "a partial batch dispatches")
    s.add_argument("--queue-depth", type=int, default=256,
                   help="admission limit across all buckets; excess load "
                        "is shed with a structured rejection")
    s.add_argument("--cache-size", type=int, default=256,
                   help="result-cache entries (content-addressed LRU)")
    s.add_argument("--timeout", type=float, default=30.0,
                   help="per-request queue timeout in seconds")
    m = p.add_argument_group("mesh serving")
    m.add_argument("--mesh", action="store_true",
                   help="serve through the mesh-aware engine "
                        "(heat2d_tpu_torch/mesh): buckets split over the "
                        "device slots on the batch axis, huge-grid "
                        "signatures take the spatial route, the split is "
                        "recorded per bucket; --max-batch then bounds "
                        "members PER SLOT")
    m.add_argument("--host-device-count", type=int, default=None,
                   metavar="N",
                   help="with --mesh: N slots on --device, sharing its "
                        "cards in turn (default: one slot per visible "
                        "card)")
    m.add_argument("--mesh-admission-mcells", type=float, default=None,
                   metavar="R",
                   help="with --mesh: arm modeled-capacity admission "
                        "control at R Mcells/s per slot (default: "
                        "admission off)")
    m.add_argument("--mesh-stall-deadline", type=float, default=None,
                   metavar="S",
                   help="with --mesh: arm the stall watchdog: a WARM mesh "
                        "launch stalling past S seconds is quarantined "
                        "and shrunk-and-requeued instead of hanging")
    m.add_argument("--mesh-abft", action="store_true",
                   help="with --mesh: arm the ABFT checksum verify tier "
                        "(ops/abft.py): silent data corruption "
                        "quarantines the slot and recomputes")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the metrics snapshot and the kind='serve' "
                        "run record as JSONL")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="arm request tracing: per-request spans "
                        "(admission, queue, launch) land as JSONL in DIR; "
                        "merge with heat2d-tpu-torch-trace DIR")
    p.add_argument("--perf", action="store_true",
                   help="arm the cost cards (obs/perf.py: the roofline "
                        "model at each launch's plan, operand and peak "
                        "bytes, the kernel's registers) at each "
                        "signature's first launch; persisted beside the "
                        "spans with --trace-dir, and in the run record")
    s2 = p.add_argument_group("SLO objectives")
    s2.add_argument("--slo-p99", type=float, default=None, metavar="S",
                    help="per-signature p99 latency target in seconds; "
                         "the evaluation lands in the run record's 'slo' "
                         "rows and the slo_* gauges")
    s2.add_argument("--slo-error-budget", type=float, default=0.001,
                    metavar="F",
                    help="allowed failure fraction per signature "
                         "(default 0.001 = 99.9%%)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="serve on the CUDA card (default) or, with the "
                        "plain PyTorch versions of the kernels, the CPU")
    add_log_level_flag(p)
    return p


def _mesh_kwargs(args, registry) -> dict:
    """``SolveServer``'s engine and admission for ``--mesh``: the mesh
    engine over the slots, and modeled-capacity admission when a rate was
    given."""
    if not args.mesh:
        return {}
    from heat2d_tpu_torch.mesh import MeshAdmission, MeshEnsembleEngine
    from heat2d_tpu_torch.parallel.mesh import host_devices, visible_devices
    devices = (host_devices(args.host_device_count, args.device)
               if args.host_device_count else visible_devices(args.device))
    fault = None
    if args.mesh_stall_deadline is not None or args.mesh_abft:
        from heat2d_tpu_torch.mesh import FaultPolicy
        fault = FaultPolicy(stall_deadline_s=args.mesh_stall_deadline,
                            abft=bool(args.mesh_abft))
    # --max-batch becomes the per-slot bound: the engine's launch bound
    # scales with the mesh.
    out = {"engine": MeshEnsembleEngine(
        registry=registry, max_batch_per_chip=args.max_batch,
        fault=fault, devices=devices)}
    if args.mesh_admission_mcells is not None:
        out["admission"] = MeshAdmission(
            registry=registry,
            per_chip_mcells_per_s=args.mesh_admission_mcells,
            devices=devices)
    return out


def _server(args, registry, max_delay):
    from heat2d_tpu_torch.serve.server import SolveServer
    return SolveServer(
        max_batch=args.max_batch, max_delay=max_delay,
        max_queue=args.queue_depth, cache_size=args.cache_size,
        default_timeout=args.timeout, registry=registry,
        device=args.device, **_mesh_kwargs(args, registry))


def _selftest_workload(client):
    """The mixed workload: returns (requests fired, failures)."""
    from heat2d_tpu_torch.serve.schema import SolveRequest

    a = [SolveRequest(nx=24, ny=32, steps=6, cx=0.05 + 0.01 * i, cy=0.1,
                      method="jnp") for i in range(6)]
    b = [SolveRequest(nx=16, ny=48, steps=6, cx=0.1, cy=0.05 + 0.01 * i,
                      method="jnp") for i in range(3)]
    dup = SolveRequest(nx=24, ny=32, steps=6, cx=0.2, cy=0.2, method="jnp")

    failures = []
    # Same-shape batching + mixed shapes in separate buckets + two
    # identical in-flight duplicates, all submitted before the batcher's
    # max_delay elapses.
    futs = [client.submit(r) for r in a + b] + [client.submit(dup),
                                                client.submit(dup)]
    results = []
    for i, f in enumerate(futs):
        try:
            results.append(f.result(timeout=120))
        except Exception as e:  # noqa: BLE001 — report, don't crash
            failures.append(f"request {i} failed: {e!r}")
            results.append(None)
    fired = len(futs)

    if results[0] is not None:
        again = client.solve(a[0], timeout=60)
        fired += 1
        if not again.cache_hit:
            failures.append("repeat request was not a cache hit")
        if np.asarray(again.u).tobytes() != \
                np.asarray(results[0].u).tobytes():
            failures.append("cache hit result not bitwise-identical")
    if results[-1] is not None and results[-2] is not None:
        if np.asarray(results[-1].u).tobytes() != \
                np.asarray(results[-2].u).tobytes():
            failures.append("coalesced duplicates returned different "
                            "grids")
    # The implicit route: an adi request (diffusion numbers far past the
    # explicit box) answers through the server, and its repeat is a
    # bitwise cache hit.
    adi = SolveRequest(nx=24, ny=32, steps=4, cx=8.0, cy=6.0, method="adi")
    try:
        first = client.solve(adi, timeout=120)
        again = client.solve(adi, timeout=60)
        fired += 2
        if not again.cache_hit:
            failures.append("adi repeat was not a cache hit")
        if np.asarray(again.u).tobytes() != np.asarray(first.u).tobytes():
            failures.append("adi repeat not bitwise-identical")
    except Exception as e:  # noqa: BLE001 — report, don't crash
        failures.append(f"adi request failed: {e!r}")

    f2, fail2 = _problems_workload(client)
    return fired + f2, failures + fail2


def _problems_workload(client):
    """Every problem family through the server (admission, bucketing,
    launch), and the capability matrix's rejection: reactdiff (nonlinear)
    x adi must come back as ``Rejected("unsupported_combination")`` naming
    the problem, never as a crash."""
    from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest
    from heat2d_tpu_torch.vocab import PROBLEMS

    fired = 0
    failures = []
    for fam in PROBLEMS:
        if fam == "heat5":
            continue    # the rest of the selftest is heat5
        req = SolveRequest(nx=16, ny=16, steps=5, cx=0.1, cy=0.1,
                           method="jnp", problem=fam)
        try:
            r = client.solve(req, timeout=120)
            fired += 1
            u = np.asarray(r.u)
            if u.shape != (16, 16) or not np.isfinite(u).all():
                failures.append(f"problem {fam}: bad result "
                                f"(shape {u.shape})")
        except Exception as e:  # noqa: BLE001 — report, don't crash
            failures.append(f"problem {fam} request failed: {e!r}")
    bad = SolveRequest(nx=16, ny=16, steps=5, cx=0.1, cy=0.1,
                       method="adi", problem="reactdiff")
    try:
        client.solve(bad, timeout=60)
        failures.append("reactdiff x adi was served (expected the "
                        "unsupported_combination rejection)")
    except Rejected as e:
        if e.code != "unsupported_combination":
            failures.append(f"reactdiff x adi rejected with {e.code!r}, "
                            f"expected 'unsupported_combination'")
        elif "reactdiff" not in e.message:
            failures.append("unsupported_combination rejection does not "
                            "name the problem")
    except Exception as e:  # noqa: BLE001 — report, don't crash
        failures.append(f"reactdiff x adi raised {e!r} instead of a "
                        f"structured rejection")
    return fired, failures


def run_selftest(args, registry) -> int:
    from heat2d_tpu_torch.serve.server import Client

    server = _server(args, registry, max(args.max_delay, 0.05))
    with server:
        fired, failures = _selftest_workload(Client(server))

    snap = registry.snapshot()
    occ = snap["histograms"].get("serve_batch_occupancy")
    launches = server.engine.launches
    if launches >= fired:
        failures.append(f"no batching: {launches} launches for {fired} "
                        f"requests")
    if not occ or occ["count"] < 1 or occ["sum"] < 1:
        failures.append("batch-occupancy metric is empty")
    elif occ["max"] < 2:
        failures.append("no launch held more than one member")
    hits = snap["counters"].get("serve_cache_hits_total", 0)
    if hits < 1:
        failures.append("no cache hit recorded")
    if "serve_e2e_latency_s" not in snap["histograms"]:
        failures.append("no end-to-end latency recorded")
    from heat2d_tpu_torch.vocab import DEFAULT_PROBLEM, PROBLEMS
    for fam in (f for f in PROBLEMS if f != DEFAULT_PROBLEM):
        if snap["counters"].get(
                f"problem_requests_total{{problem={fam}}}", 0) < 1:
            failures.append(f"no launch counted for problem {fam}")

    print(f"selftest: {fired} requests -> {launches} launches, occupancy "
          f"max {occ['max'] if occ else 0:.0f}, cache hits {hits:.0f}")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    _write_metrics(args, registry, server,
                   extra={"selftest_requests": fired,
                          "selftest_failures": failures})
    print("selftest " + ("FAILED" if failures else "passed"))
    return 1 if failures else 0


def run_requests(args, registry) -> int:
    from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest

    try:
        with open(args.requests) as f:
            dicts = [json.loads(line) for line in f if line.strip()]
    except (OSError, json.JSONDecodeError) as e:
        print(f"bad --requests file: {e}\nQuitting...", file=sys.stderr)
        return 1

    rc = 0
    lines = []
    server = _server(args, registry, args.max_delay)
    with server:
        futs = []
        for d in dicts:
            try:
                futs.append(server.submit(SolveRequest.from_dict(d)))
            except Rejected as e:   # from_dict validation
                futs.append(e)
        for fut in futs:
            if isinstance(fut, Rejected):
                row = fut.to_record()
            else:
                try:
                    row = fut.result(timeout=args.timeout + 60).summary()
                except Rejected as e:
                    rc, row = 1, e.to_record()
                except Exception as e:  # noqa: BLE001
                    rc, row = 1, {"rejected": "error", "message": repr(e)}
            lines.append(json.dumps(row))
            if not args.results_out:
                print(lines[-1], flush=True)
    if args.results_out:
        from heat2d_tpu_torch.io.binary import write_text_atomic
        write_text_atomic("".join(f"{x}\n" for x in lines),
                          args.results_out)
    _write_metrics(args, registry, server, extra={"requests": len(dicts)})
    return rc


def _write_metrics(args, registry, server, extra) -> None:
    from heat2d_tpu_torch.obs.record import write_run_jsonl

    extra = dict(extra)
    if args.slo_p99 is not None:
        # evaluated at export time, never on the serving path
        from heat2d_tpu_torch.obs import slo
        rows = slo.evaluate(
            registry, prefix="serve",
            default=slo.SLOPolicy(latency_p99_s=args.slo_p99,
                                  error_budget=args.slo_error_budget))
        slo.stamp_record(extra, rows)
        for r in rows:
            if not r.get("ok", True):
                print(f"SLO VIOLATION: {r['signature']}: p99 "
                      f"{r['p99_s']} vs target "
                      f"{r['latency_target_p99_s']}, burn rate "
                      f"{r['burn_rate']:.2f}", file=sys.stderr)
    if args.trace_dir:
        from heat2d_tpu_torch.obs import tracing
        t = tracing.tracer()
        extra["trace"] = {"dir": args.trace_dir,
                          "spans_emitted": (t.spans_emitted
                                            if t is not None else 0)}
    from heat2d_tpu_torch.obs import perf
    obs = perf.observer()
    if obs is not None:
        # the card book rides the record, and its file is closed
        extra["perf"] = obs.snapshot()
        perf.uninstall()
    write_run_jsonl(registry, args.metrics_out, "serve", {
        "launches": server.engine.launches,
        "launch_log": [dict(row, signature=list(map(str, row["signature"])))
                       for row in server.engine.launch_log],
        **extra}, device=args.device)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.mesh:
        # mesh flags without --mesh would serve on the single-device
        # engine while looking fault-armed or admission-priced: a usage
        # error (exit 2)
        for flag, armed in (
                ("--mesh-stall-deadline",
                 args.mesh_stall_deadline is not None),
                ("--mesh-abft", args.mesh_abft),
                ("--mesh-admission-mcells",
                 args.mesh_admission_mcells is not None),
                ("--host-device-count",
                 args.host_device_count is not None)):
            if armed:
                parser.error(f"{flag} requires --mesh")
    configure_logging(args.log_level)
    if args.trace_dir:
        # the explicit flag wins over a stale HEAT2D_TRACE_DIR
        os.environ["HEAT2D_TRACE_DIR"] = args.trace_dir
        from heat2d_tpu_torch.obs import tracing
        tracing.install(tracing.Tracer(args.trace_dir, service="serve"))
    from heat2d_tpu_torch.obs import MetricsRegistry, flight
    registry = MetricsRegistry()
    flight.maybe_install_from_env(service="serve", registry=registry)
    if args.perf:
        # the cards share the trace campaign's directory when one is armed
        # (heat2d-tpu-torch-trace --stats joins them on signature)
        from heat2d_tpu_torch.obs import perf
        perf.install(perf.PerfObserver(registry=registry,
                                       dir=args.trace_dir,
                                       service="serve"))
    try:
        if args.selftest:
            return run_selftest(args, registry)
        if args.requests:
            return run_requests(args, registry)
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    print("nothing to do: pass --selftest or --requests FILE.jsonl "
          "(embed SolveServer in your process for anything else)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
