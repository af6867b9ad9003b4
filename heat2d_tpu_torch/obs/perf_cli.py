"""``heat2d-tpu-torch-perf``: the performance observatory console (the
port's counterpart of ``heat2d-tpu-perf``).

- ``--card NXxNY``: one launch of the serve-batch runner the engine
  dispatches (``models.ensemble.batch_runner``) for one signature, on the
  card (``--device cpu`` for the plain versions), and its cost card:
  FLOPs and bytes from the roofline model at the launch's plan, argument,
  output, temp and peak bytes, registers and spills of its kernel.
  ``--gate-model-pct P`` exits 1 unless the launch's operand and result
  bytes agree with the analytic boundary model within P%.
- ``--roofline NXxNY[,NXxNY...]``: the analytic ledger per shape (route,
  kernel, bytes a cell-step, Mcells per device-memory byte, the bound on
  ``--device-kind``, by default the calibrated H100).
- ``--watch DIR``: live console over a trace directory a ``--perf`` serve
  run is writing: cost cards and launch-span duty per lane.
- ``--soak S``: an in-process serve soak on ``--device`` (the card by
  default) driving the anomaly sentinel through the control plane's real
  tick (``control.plane.ControlPlane``). ``--chaos-slow X`` arms a launch
  latency injection (``resil/chaos.py``) at the soak's midpoint;
  ``--expect-anomaly`` requires the sentinel to flag it within
  ``--max-detect-windows`` windows of arming, ``--expect-clean`` requires
  ZERO findings. A ``kind="perf"`` record (cards, findings, control
  decisions, duty cycle, verdict) goes to ``--metrics-out``. The soak's
  requests take ``--method`` (``auto``: on the card the hand kernels'
  route, H5 at the default 48^2 grid), where the JAX soak takes ``jnp``.

    heat2d-tpu-torch-perf --roofline 4096x4096,640x1024 --steps 240
    heat2d-tpu-torch-perf --card 640x1024 --batch 8 --steps 10000
    heat2d-tpu-torch-perf --soak 20 --chaos-slow 0.5 --expect-anomaly
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

USAGE_HINT = "one of --card, --roofline, --soak, --watch is required"


def _parse_shape(s: str) -> tuple:
    try:
        nx, ny = s.lower().split("x")
        return int(nx), int(ny)
    except ValueError:
        raise SystemExit(f"bad shape {s!r} (want NXxNY)") from None


def cmd_card(args) -> int:
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.obs import perf
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.utils.device import DeviceUnavailableError
    from heat2d_tpu_torch.utils.timing import _fence

    nx, ny = _parse_shape(args.card)
    reg = MetricsRegistry()
    try:
        runner = ensemble.batch_runner(nx, ny, args.steps, args.method,
                                       device=args.device)
        cxs, cys, u0 = ensemble._validated_batch(
            nx, ny, [0.1] * args.batch, [0.1] * args.batch, None,
            args.device)
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    meta = {"signature": f"card:{nx}x{ny}x{args.steps}:{args.method}",
            "nx": nx, "ny": ny, "steps": args.steps, "method": args.method,
            "convergence": False, "capacity": args.batch,
            "dtype": "float32", "problem": "heat5", "route": "batch"}
    watch = perf.LaunchWatch(u0.device)
    out = runner(u0, cxs, cys)
    _fence(out)
    card = perf.extract_cost_card(runner, (u0, cxs, cys), meta=meta,
                                  registry=reg, outputs=out, watch=watch)
    if card is None:
        print("cost-card extraction failed", file=sys.stderr)
        return 1
    print(json.dumps(card, indent=None if args.json else 2))
    if args.gate_model_pct is not None:
        agree = (card.get("model") or {}).get("boundary_agreement_pct")
        if agree is None:
            print("gate: no boundary agreement figure", file=sys.stderr)
            return 1
        if abs(agree - 100.0) > args.gate_model_pct:
            print(f"gate: boundary bytes {agree}% of model, outside "
                  f"+-{args.gate_model_pct}%", file=sys.stderr)
            return 1
        print(f"gate: boundary agreement {agree}% within "
              f"+-{args.gate_model_pct}%", file=sys.stderr)
    return 0


def cmd_roofline(args) -> int:
    from heat2d_tpu_torch.obs import roofline

    kind = args.device_kind or roofline.H100_KIND
    rows = []
    for shape in args.roofline.split(","):
        nx, ny = _parse_shape(shape)
        kw = dict(method=args.method, steps=args.steps, batch=args.batch,
                  problem=args.problem)
        m = roofline.analytic_bytes_per_cell_step(nx, ny, **kw)
        bound = roofline.roofline_bound(nx, ny, device_kind=kind, **kw)
        rows.append({
            "shape": f"{nx}x{ny}", "route": m["route"],
            "kernel": m["kernel"], "model": m["model"],
            "coarse": m["coarse"],
            "bytes_per_cell_step": round(m["bytes_per_cell_step"], 4),
            "mcells_per_hbm_byte": round(
                1.0 / (1e6 * m["bytes_per_cell_step"]), 9),
            "bound_mcells_per_s": (round(bound["bound_mcells_per_s"], 1)
                                   if bound else None),
            "bound_by": bound["bound_by"] if bound else None,
            "device_kind": kind,
        })
    if args.json:
        print(json.dumps(rows))
        return 0
    print("| shape | route | kernel | bytes/cell-step | Mcells/HBM-byte "
          "| bound Mcells/s (by) | model |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        b = (f"{r['bound_mcells_per_s']:.4g} ({r['bound_by']})"
             if r["bound_mcells_per_s"] else "—")
        print(f"| {r['shape']} | {r['route']} | {r['kernel'] or '—'} "
              f"| {r['bytes_per_cell_step']:.4g} "
              f"| {r['mcells_per_hbm_byte']:.3g} | {b} | {r['model']} |")
    return 0


class _StubFleet:
    """The minimal fleet surface ControlPlane touches, for a soak with
    no worker processes: shed is recorded, the generation book is empty
    (a vacuously valid serving invariant)."""

    class _Sup:
        @staticmethod
        def alive_slots():
            return []

        @staticmethod
        def generations_snapshot():
            return []

    def __init__(self):
        self.sup = self._Sup()
        self.shed = None

    def set_preemptive_shed(self, watermark):
        self.shed = watermark


def cmd_soak(args) -> int:
    from heat2d_tpu_torch.control.plane import ControlPlane
    from heat2d_tpu_torch.obs import perf, tracing
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.obs.record import write_run_jsonl
    from heat2d_tpu_torch.resil import chaos
    from heat2d_tpu_torch.serve.schema import SolveRequest
    from heat2d_tpu_torch.serve.server import SolveServer
    from heat2d_tpu_torch.utils.device import (DeviceUnavailableError,
                                               resolve_device)

    try:
        resolve_device(args.device)
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    reg = MetricsRegistry()
    observer = perf.PerfObserver(registry=reg, dir=args.trace_dir,
                                 service="perf-soak")
    perf.install(observer)
    sampler = None
    if args.trace_dir:
        tracing.install(tracing.Tracer(args.trace_dir, service="serve"))
        sampler = perf.DutyCycleSampler(reg, window_s=2.0)
        tracing.add_span_tap(sampler.feed)
        sampler.start()

    sentinel = perf.AnomalySentinel(
        warmup=args.warmup, sustain=args.sustain)
    fleet = _StubFleet()
    plane = ControlPlane(fleet, registry=reg, sentinel=sentinel)

    server = SolveServer(max_batch=4, registry=reg,
                         device=args.device).start()
    windows = max(int(args.soak / args.window), 2 * args.warmup + 4)
    arm_at = windows // 2 if args.chaos_slow else None
    detect_at = None
    n_req = 0
    try:
        for w in range(windows):
            if arm_at is not None and w == arm_at:
                chaos.install(chaos.ChaosConfig(
                    launch_latency_s=args.chaos_slow), registry=reg)
            for _ in range(args.per_window):
                # a cx jitter below any physical relevance keeps the
                # SIGNATURE constant (one sentinel series) while
                # defeating the result cache: every solve launches
                n_req += 1
                server.solve(SolveRequest(
                    nx=args.grid, ny=args.grid,
                    steps=args.grid_steps, method=args.method,
                    cx=0.1 + 1e-9 * n_req))
            before = len(sentinel.findings)
            plane.tick()
            if (detect_at is None
                    and len(sentinel.findings) > before):
                detect_at = w
            # pacing keeps the windowed rate metric meaningful: the
            # injected latency dominates when armed
            time.sleep(args.window if args.soak >= windows * args.window
                       else 0.05)
    finally:
        server.stop(drain=True)
        chaos.uninstall()
        if sampler is not None:
            tracing.remove_span_tap(sampler.feed)
            sampler.stop()
        tracing.install(None)
        perf.uninstall()

    findings = list(sentinel.findings)
    decisions = [d for d in plane.decisions
                 if d["action"] == "perf_anomaly"]
    detect_windows = (detect_at - arm_at + 1
                      if detect_at is not None and arm_at is not None
                      else None)
    verdict = {
        "windows": windows, "armed_at_window": arm_at,
        "findings": len(findings),
        "detection_windows": detect_windows,
    }
    print(json.dumps({"verdict": verdict, "findings": findings},
                     indent=None if args.json else 2))

    if args.metrics_out:
        write_run_jsonl(reg, args.metrics_out, "perf", {
            "soak": verdict, "findings": findings,
            "control_decisions": decisions,
            "duty": sampler.snapshot() if sampler else None,
            "cost_cards": observer.cards(),
        }, device=args.device)

    if args.expect_anomaly:
        if not findings or not decisions:
            print("expected an anomaly finding in the control plane "
                  "decision log; got none", file=sys.stderr)
            return 1
        if (detect_windows is None
                or detect_windows > args.max_detect_windows):
            print(f"detection took {detect_windows} windows "
                  f"(> {args.max_detect_windows})", file=sys.stderr)
            return 1
    if args.expect_clean and findings:
        print(f"expected a clean soak; sentinel flagged "
              f"{len(findings)} finding(s): {findings[0]}",
              file=sys.stderr)
        return 1
    return 0


def _recent_launch_duty(trace_dir: str, window_s: float) -> dict:
    """Per-lane launch duty over the trailing window, read cold from the
    span files (the offline twin of DutyCycleSampler's live tap)."""
    now = time.time()
    lo = now - window_s
    by_lane: dict = {}
    for path in glob.glob(os.path.join(trace_dir, "spans-*.jsonl")):
        try:
            with open(path, errors="replace") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if (rec.get("event") != "span"
                            or rec.get("kind") != "launch"
                            or rec.get("t1", 0) < lo):
                        continue
                    lane = (f"{rec.get('service', '?')}:"
                            f"{rec.get('pid', 0)}")
                    a = max(float(rec["t0"]), lo)
                    b = min(float(rec["t1"]), now)
                    if b > a:
                        by_lane[lane] = by_lane.get(lane, 0.0) + b - a
        except OSError:
            continue
    return {lane: min(1.0, busy / window_s)
            for lane, busy in by_lane.items()}


def cmd_watch(args) -> int:
    from heat2d_tpu_torch.obs.trace_cli import load_cost_cards

    ticks = 0
    try:
        while True:
            cards = load_cost_cards(args.watch)
            duty = _recent_launch_duty(args.watch, args.watch_window)
            out = ["\x1b[2J\x1b[H" if not args.json else "",
                   f"perf watch — {args.watch} ({len(cards)} card(s))"]
            for lane, d in sorted(duty.items()):
                out.append(f"  duty {lane}: {100 * d:5.1f}%")
            for sig, c in sorted(cards.items()):
                m = c.get("model") or {}
                out.append(
                    f"  {sig}: {c.get('kernel')} {c.get('plan')}, "
                    f"{c.get('bytes_accessed', 0):.3g} B moved, "
                    f"AI={c.get('arithmetic_intensity')}, peak "
                    f"{c.get('peak_bytes')} B, boundary "
                    f"{m.get('boundary_agreement_pct')}% of model")
            print("\n".join(filter(None, out)), flush=True)
            ticks += 1
            if args.watch_ticks and ticks >= args.watch_ticks:
                return 0
            time.sleep(args.watch_interval)
    except KeyboardInterrupt:
        return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-perf",
        description="cost cards, roofline ledger, sentinel soak, live watch")
    p.add_argument("--card", metavar="NXxNY",
                   help="run one serve-batch launch at this shape and "
                        "print its cost card")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--method", default="auto",
                   help="--card's and --soak's request method")
    p.add_argument("--batch", type=int, default=1,
                   help="members of the launch the card describes")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="--card's and --soak's device (default the card)")
    p.add_argument("--gate-model-pct", type=float, default=None,
                   help="exit 1 unless boundary bytes agree with the "
                        "analytic model within this percent")
    p.add_argument("--roofline", metavar="SHAPES",
                   help="comma-separated NXxNY list: analytic ledger")
    p.add_argument("--problem", default="heat5",
                   help="--roofline's problem family")
    p.add_argument("--device-kind", default=None,
                   help="--roofline's peaks (default: the calibrated "
                        "NVIDIA H100 80GB HBM3)")
    p.add_argument("--soak", type=float, default=None, metavar="S",
                   help="run an S-second serve soak with the sentinel")
    p.add_argument("--window", type=float, default=0.25,
                   help="sentinel window pacing during --soak")
    p.add_argument("--per-window", type=int, default=3,
                   help="requests per soak window")
    p.add_argument("--grid", type=int, default=48,
                   help="soak request grid edge")
    p.add_argument("--grid-steps", type=int, default=30,
                   help="soak request step count")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--sustain", type=int, default=2)
    p.add_argument("--chaos-slow", type=float, default=None,
                   metavar="SEC", help="inject this launch latency at "
                                       "the soak midpoint")
    p.add_argument("--expect-anomaly", action="store_true",
                   help="exit 1 unless the sentinel flags the "
                        "injection fast enough")
    p.add_argument("--expect-clean", action="store_true",
                   help="exit 1 if the sentinel flags anything")
    p.add_argument("--max-detect-windows", type=int, default=3)
    p.add_argument("--trace-dir", default=None,
                   help="soak trace/card dir (also arms the duty "
                        "sampler)")
    p.add_argument("--metrics-out", default=None,
                   help="write the kind=perf run record JSONL here")
    p.add_argument("--watch", metavar="DIR",
                   help="live console over a --perf run's trace dir")
    p.add_argument("--watch-interval", type=float, default=1.0)
    p.add_argument("--watch-window", type=float, default=5.0)
    p.add_argument("--watch-ticks", type=int, default=0,
                   help="stop after N refreshes (0 = until ^C)")
    p.add_argument("--json", action="store_true",
                   help="single-line JSON output")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.card:
        return cmd_card(args)
    if args.roofline:
        return cmd_roofline(args)
    if args.soak is not None:
        return cmd_soak(args)
    if args.watch:
        return cmd_watch(args)
    print(USAGE_HINT, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
