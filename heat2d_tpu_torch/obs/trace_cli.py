"""``heat2d-tpu-torch-trace``: merge per-process span files into one
timeline. The port's copy of ``heat2d_tpu/obs/trace_cli.py``: the span
schema and file names are the JAX package's, so this merger reads either
package's files and gives the report ``heat2d-tpu-trace`` gives.

The tracing layer (``obs/tracing.py``) leaves one ``spans-<service>-
<pid>.jsonl`` per process in the trace directory, and a process that died
violently may leave a ``flight-*.jsonl`` post-mortem (``obs/flight.py``)
holding the spans that died with it. This tool is the read side:

- **merge**: every span of every process (post-mortem spans included),
  deduped by span id, grouped by ``trace_id``;
- **causality check**: a trace is CONNECTED when exactly one root span
  exists and every other span's parent resolves inside the trace
  (``--assert-connected``);
- **critical path**: per request, queue wait vs compile (a signature's
  first launch, which builds its kernels) vs launch vs wire vs replay
  vs other;
- **export**: a Chrome trace-event file (``--perfetto-out``) loadable at
  ui.perfetto.dev, one lane per process, flow arrows on every
  cross-process parent/child edge;
- **stats** (``--stats``): per-segment p50/p99 over the merged traces,
  joined with the cost cards a ``--perf`` serve run leaves beside them.

``--require-postmortem`` fails unless a digest-valid, non-empty
post-mortem is present.

    heat2d-tpu-torch-trace DIR --assert-connected
    heat2d-tpu-torch-trace DIR --stats --perfetto-out trace.json
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

from heat2d_tpu_torch.obs import flight as flight_mod

MERGE_SCHEMA = "heat2d-tpu/trace-merge/v1"

#: critical-path segment order (md table column order)
SEGMENTS = ("queue", "compile", "launch", "wire", "replay", "other")


def load_dir(trace_dir: str, verify: bool = True) -> dict:
    """Read every span file + flight post-mortem under ``trace_dir``.
    Returns ``{"spans": [...], "postmortems": [...], "corrupt": [...],
    "files": n}``. Span files are torn-line tolerant (a killed
    process's final line may be cut); post-mortems are digest-verified
    unless ``verify=False`` — a corrupt one is REPORTED, never
    silently merged."""
    spans: dict = {}     # (trace_id, span_id) -> record (first wins)
    starts: dict = {}    # span_start records awaiting a matching end
    postmortems, corrupt = [], []

    def take(rec, source=None):
        key = (rec.get("trace_id"), rec.get("span_id"))
        if source is not None:
            rec = dict(rec, source=source)
        if rec.get("event") == "span":
            spans.setdefault(key, rec)
            return True
        if rec.get("event") == "span_start":
            starts.setdefault(key, rec)
        return False

    span_files = sorted(glob.glob(os.path.join(trace_dir,
                                               "spans-*.jsonl")))
    for path in span_files:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue    # torn tail line of a killed process
                take(rec)
    for path in flight_mod.find_postmortems(trace_dir):
        try:
            entries = flight_mod.load_postmortem(path, verify=verify)
        except flight_mod.PostmortemCorruptError as e:
            corrupt.append({"path": path, "error": str(e)})
            continue
        header = (entries[0] if entries
                  and entries[0].get("event") == "flight_header"
                  else {})
        n_spans = 0
        for rec in entries:
            # a span teed to both the live file and the black box
            # keeps the live copy; one that only survived in the
            # black box (killed before/without a span file) merges
            # from here
            if take(rec, source="flight"):
                n_spans += 1
        postmortems.append({
            "path": path, "reason": header.get("reason"),
            "service": header.get("service"), "pid": header.get("pid"),
            "entries": header.get("entries"), "spans": n_spans,
        })
    # A start with no end is a span the process never got to close —
    # usually because it DIED inside it (the chaos kill). Synthesize
    # an UNFINISHED zero-length span so its children stay connected
    # and the timeline shows exactly where the process stopped.
    for key, rec in starts.items():
        if key not in spans:
            spans[key] = dict(rec, event="span", t1=rec.get("t0"),
                              attrs=dict(rec.get("attrs") or {},
                                         unfinished=True))
    return {"spans": list(spans.values()), "postmortems": postmortems,
            "corrupt": corrupt,
            "files": len(span_files) + len(postmortems) + len(corrupt)}


def assemble(spans: list) -> dict:
    """{trace_id: spans sorted by t0}."""
    traces: dict = collections.defaultdict(list)
    for s in spans:
        if s.get("trace_id"):
            traces[s["trace_id"]].append(s)
    return {tid: sorted(ss, key=lambda s: (s.get("t0", 0.0),
                                           s.get("t1", 0.0)))
            for tid, ss in traces.items()}


def connectivity(trace_spans: list) -> dict:
    """roots/orphans of one trace; connected == one root, no orphans
    (every span's parent resolvable inside the merged trace)."""
    ids = {s["span_id"] for s in trace_spans}
    roots = [s for s in trace_spans if not s.get("parent_id")]
    orphans = [s for s in trace_spans
               if s.get("parent_id") and s["parent_id"] not in ids]
    return {"roots": len(roots), "orphans": len(orphans),
            "connected": len(roots) == 1 and not orphans}


def _dur(s: dict) -> float:
    return max(0.0, float(s.get("t1", 0.0)) - float(s.get("t0", 0.0)))


def critical_path(trace_spans: list) -> dict:
    """Per-request segment breakdown (seconds). Segments:

    - ``queue``   — batcher queue-wait spans;
    - ``compile`` — launch spans flagged ``first_launch`` (the first
      launch of a signature pays its kernels' build and load);
    - ``launch``  — warm launch spans;
    - ``wire``    — wire spans (a JAX fleet's dispatches; the port
      emits none) MINUS the request span each one carried;
    - ``replay``  — the gaps between consecutive wire spans;
    - ``other``   — the root's remaining unattributed time.
    """
    children: dict = collections.defaultdict(list)
    for s in trace_spans:
        if s.get("parent_id"):
            children[s["parent_id"]].append(s)
    seg = dict.fromkeys(SEGMENTS, 0.0)
    roots = [s for s in trace_spans if not s.get("parent_id")]
    total = _dur(roots[0]) if len(roots) == 1 else sum(
        _dur(s) for s in roots)
    wire_spans = []
    for s in trace_spans:
        kind = s.get("kind")
        if kind == "queue":
            seg["queue"] += _dur(s)
        elif kind == "launch":
            key = ("compile" if s.get("attrs", {}).get("first_launch")
                   else "launch")
            seg[key] += _dur(s)
        elif kind == "wire":
            wire_spans.append(s)
            nested = sum(_dur(c) for c in children[s["span_id"]]
                         if c.get("kind") == "request")
            seg["wire"] += max(0.0, _dur(s) - nested)
    wire_spans.sort(key=lambda s: s.get("t0", 0.0))
    for a, b in zip(wire_spans, wire_spans[1:]):
        seg["replay"] += max(0.0, b["t0"] - a["t1"])
    attributed = sum(v for k, v in seg.items() if k != "other")
    seg["other"] = max(0.0, total - attributed)
    seg["total"] = total
    return {k: round(v, 6) for k, v in seg.items()}


def summarize(trace_spans: list) -> dict:
    """One report row per trace."""
    conn = connectivity(trace_spans)
    roots = [s for s in trace_spans if not s.get("parent_id")]
    root = roots[0] if roots else {}
    attrs = root.get("attrs", {})
    return {
        "trace_id": trace_spans[0]["trace_id"],
        "content_hash": attrs.get("content_hash"),
        "signature": attrs.get("signature"),
        "tenant": attrs.get("tenant"),
        "root": root.get("name"),
        "service": root.get("service"),
        "t0": min(s.get("t0", 0.0) for s in trace_spans),
        "spans": len(trace_spans),
        "processes": len({(s.get("service"), s.get("pid"))
                          for s in trace_spans}),
        "replays": sum(1 for s in trace_spans
                       if s.get("name") == "fleet.replay"),
        "flight_spans": sum(1 for s in trace_spans
                            if s.get("source") == "flight"),
        "outcome": attrs.get("outcome"),
        **conn,
        "breakdown": critical_path(trace_spans),
    }


def merge_report(trace_dir: str, verify: bool = True,
                 loaded: dict = None) -> dict:
    """The full merged report (the library entry point). ``loaded``
    reuses a prior ``load_dir`` result — one read serves both the
    report and a Perfetto export."""
    if loaded is None:
        loaded = load_dir(trace_dir, verify=verify)
    traces = assemble(loaded["spans"])
    rows = sorted((summarize(ss) for ss in traces.values()),
                  key=lambda r: r["t0"])
    by_hash: dict = collections.defaultdict(list)
    for r in rows:
        if r["content_hash"]:
            by_hash[r["content_hash"]].append(r["trace_id"])
    return {
        "schema": MERGE_SCHEMA,
        "dir": trace_dir,
        "files": loaded["files"],
        "spans": len(loaded["spans"]),
        "traces": rows,
        "request_hashes": {h: tids for h, tids in sorted(by_hash.items())},
        "postmortems": loaded["postmortems"],
        "corrupt_postmortems": loaded["corrupt"],
    }


# -- per-segment statistics (--stats) ----------------------------------- #

def _seg_quantile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    from heat2d_tpu_torch.obs.metrics import quantile
    return quantile(sorted_vals, q)    # the registry's one convention


def load_cost_cards(trace_dir: str) -> dict:
    """{signature string: cost card} from the ``cost-cards-*.jsonl``
    sidecars a ``--perf`` serve run leaves beside its span files
    (obs/perf.PerfObserver). First card per signature wins — capacity
    rungs of one signature share the per-program shape figures the
    stats table renders. Torn-line tolerant like the span reader."""
    cards: dict = {}
    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "cost-cards-*.jsonl"))):
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                sig = rec.get("signature")
                if sig:
                    cards.setdefault(sig, rec)
    return cards


def segment_stats(report: dict, cards: dict = None) -> dict:
    """Per-segment distribution over every trace in a merged report:
    {segment: {count, mean, p50, p99, max, total}} across the
    per-trace critical-path breakdowns: the aggregate view of where
    requests spend time, which ``--stats`` renders.

    With ``cards`` (``load_cost_cards``), the program-executing
    segments (compile/launch) additionally carry ``hbm_bytes`` and
    ``arith_intensity``: the cost-card figures (``obs/perf.py``: the
    roofline model's bytes and FLOPs at the launch's plan) of the
    launches those spans ran, joined per trace through the root span's
    signature (mean over the traces a card matched). Launch-level
    properties, not span sums: one launch's bytes, not bytes x spans.
    """
    out = {}
    rows = report.get("traces", [])
    for seg in SEGMENTS + ("total",):
        vals = sorted(r["breakdown"].get(seg, 0.0) for r in rows)
        n = len(vals)
        out[seg] = {
            "count": n,
            "mean": round(sum(vals) / n, 6) if n else 0.0,
            "p50": round(_seg_quantile(vals, 0.50), 6),
            "p99": round(_seg_quantile(vals, 0.99), 6),
            "max": round(vals[-1], 6) if n else 0.0,
            "total": round(sum(vals), 6),
        }
    if cards:
        matched = [cards[r["signature"]] for r in rows
                   if r.get("signature") in cards]
        byt = [c["bytes_accessed"] for c in matched
               if c.get("bytes_accessed")]
        ai = [c["arithmetic_intensity"] for c in matched
              if c.get("arithmetic_intensity") is not None]
        for seg in ("compile", "launch"):
            if byt:
                out[seg]["hbm_bytes"] = round(sum(byt) / len(byt), 1)
            if ai:
                out[seg]["arith_intensity"] = round(
                    sum(ai) / len(ai), 4)
    return out


def stats_markdown(report: dict, cards: dict = None) -> str:
    stats = segment_stats(report, cards=cards)
    has_cards = any("hbm_bytes" in stats[seg] for seg in SEGMENTS)
    n = len(report.get("traces", []))
    lines = [
        f"# Segment statistics — {report['dir']} ({n} trace(s))", "",
        "| segment | mean | p50 | p99 | max | total (s) |"
        + (" hbm bytes | arith int |" if has_cards else ""),
        "|---|---|---|---|---|---|"
        + ("---|---|" if has_cards else ""),
    ]
    for seg in SEGMENTS + ("total",):
        s = stats[seg]
        line = (
            f"| {seg} | {s['mean']:.4g} | {s['p50']:.4g} "
            f"| {s['p99']:.4g} | {s['max']:.4g} | {s['total']:.4g} |")
        if has_cards:
            line += (f" {s['hbm_bytes']:.4g} |"
                     if "hbm_bytes" in s else " — |")
            line += (f" {s['arith_intensity']:.4g} |"
                     if "arith_intensity" in s else " — |")
        lines.append(line)
    return "\n".join(lines) + "\n"


# -- Chrome trace-event export ----------------------------------------- #

def to_chrome(spans: list) -> dict:
    """The merged spans as a Chrome trace-event JSON object (Perfetto/
    chrome://tracing loadable): one pid lane per (service, pid), an
    ``X`` event per span, and ``s``/``f`` flow arrows on every
    cross-process parent->child edge."""
    procs: dict = {}
    events = []
    by_id = {s["span_id"]: s for s in spans}

    def pid_of(s) -> int:
        key = (s.get("service") or "?", s.get("pid") or 0)
        if key not in procs:
            procs[key] = len(procs) + 1
            events.append({"ph": "M", "pid": procs[key], "tid": 0,
                           "name": "process_name",
                           "args": {"name": f"{key[0]} (pid {key[1]})"}})
        return procs[key]

    flow = 0
    for s in spans:
        pid = pid_of(s)
        ts = s.get("t0", 0.0) * 1e6
        dur = max(_dur(s) * 1e6, 1.0)   # sub-us events stay visible
        events.append({
            "ph": "X", "pid": pid, "tid": 0, "ts": ts, "dur": dur,
            "name": s.get("name"), "cat": s.get("kind", "internal"),
            "args": {"trace_id": s.get("trace_id"),
                     "span_id": s.get("span_id"),
                     "source": s.get("source", "live"),
                     **(s.get("attrs") or {})},
        })
        parent = by_id.get(s.get("parent_id") or "")
        if parent is not None and (
                (parent.get("service"), parent.get("pid"))
                != (s.get("service"), s.get("pid"))):
            flow += 1
            ppid = pid_of(parent)
            pts = max(parent.get("t0", 0.0) * 1e6, ts - 1.0)
            events.append({"ph": "s", "id": flow, "pid": ppid,
                           "tid": 0, "ts": pts, "name": "dispatch",
                           "cat": "flow"})
            events.append({"ph": "f", "bp": "e", "id": flow,
                           "pid": pid, "tid": 0, "ts": ts,
                           "name": "dispatch", "cat": "flow"})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": MERGE_SCHEMA}}


# -- rendering --------------------------------------------------------- #

def to_markdown(report: dict, top: int = 25) -> str:
    rows = report["traces"]
    lines = [
        f"# Merged trace — {report['dir']}", "",
        f"{report['spans']} spans in {report['files']} file(s); "
        f"{len(rows)} trace(s) over "
        f"{len(report['request_hashes'])} distinct request hash(es); "
        f"{len(report['postmortems'])} post-mortem(s)"
        + (f", {len(report['corrupt_postmortems'])} CORRUPT"
           if report["corrupt_postmortems"] else "") + ".", "",
        "| trace | request | spans | procs | replays | connected "
        "| queue | compile | launch | wire | replay | total (s) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows[:top]:
        b = r["breakdown"]
        lines.append(
            f"| {r['trace_id'][:8]} "
            f"| {(r['content_hash'] or '—')[:10]} | {r['spans']} "
            f"| {r['processes']} | {r['replays']} "
            f"| {'yes' if r['connected'] else 'NO'} "
            + "".join(f"| {b[k]:.4g} " for k in
                      ("queue", "compile", "launch", "wire", "replay"))
            + f"| {b['total']:.4g} |")
    if len(rows) > top:
        lines.append(f"| … {len(rows) - top} more | | | | | | | | | | | |")
    if report["postmortems"]:
        lines += ["", "## Flight-recorder post-mortems", "",
                  "| file | reason | service | spans |", "|---|---|---|---|"]
        for p in report["postmortems"]:
            lines.append(f"| {os.path.basename(p['path'])} "
                         f"| {p['reason']} | {p['service']} "
                         f"| {p['spans']} |")
    for c in report["corrupt_postmortems"]:
        lines.append(f"\nCORRUPT post-mortem: {c['path']}: {c['error']}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-trace",
        description="merge per-process span files (+ flight-recorder "
                    "post-mortems) from a HEAT2D_TRACE_DIR into one "
                    "cross-process timeline")
    p.add_argument("trace_dir", help="the span directory to merge")
    p.add_argument("--format", default="md", choices=["md", "json"])
    p.add_argument("--stats", action="store_true",
                   help="print per-segment (queue/compile/launch/"
                        "wire/replay) p50/p99 tables over the merged "
                        "timeline instead of per-trace rows")
    p.add_argument("--top", type=int, default=25,
                   help="trace rows in the markdown table")
    p.add_argument("--perfetto-out", default=None, metavar="PATH",
                   help="write a Chrome trace-event JSON (loadable at "
                        "ui.perfetto.dev / chrome://tracing)")
    p.add_argument("--no-verify", action="store_true",
                   help="skip post-mortem digest verification")
    p.add_argument("--assert-connected", action="store_true",
                   help="exit 1 unless every trace is one connected "
                        "timeline (and at least one trace exists)")
    p.add_argument("--require-postmortem", action="store_true",
                   help="exit 1 unless a digest-valid post-mortem with "
                        "at least one span is present")
    args = p.parse_args(argv)

    if not os.path.isdir(args.trace_dir):
        print(f"not a directory: {args.trace_dir}", file=sys.stderr)
        return 1
    loaded = load_dir(args.trace_dir, verify=not args.no_verify)
    report = merge_report(args.trace_dir, loaded=loaded)
    if args.perfetto_out:
        from heat2d_tpu_torch.io.binary import write_json_atomic
        write_json_atomic(to_chrome(loaded["spans"]), args.perfetto_out,
                          indent=None)
        print(f"wrote {args.perfetto_out} "
              f"({len(loaded['spans'])} spans)", file=sys.stderr)

    if args.stats:
        # Cost-card join (obs/perf.py): a --perf run's sidecars in the
        # same dir stamp the compile/launch rows with program bytes +
        # arithmetic intensity; absent sidecars, the table is as before.
        cards = load_cost_cards(args.trace_dir)
        if args.format == "json":
            print(json.dumps({"dir": report["dir"],
                              "traces": len(report["traces"]),
                              "segments": segment_stats(
                                  report, cards=cards),
                              "cost_cards": len(cards)},
                             indent=2))
        else:
            print(stats_markdown(report, cards=cards), end="")
    elif args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(to_markdown(report, top=args.top), end="")

    failures = []
    if args.assert_connected:
        bad = [r["trace_id"] for r in report["traces"]
               if not r["connected"]]
        if not report["traces"]:
            failures.append("no traces found")
        if bad:
            failures.append(f"{len(bad)} disconnected trace(s), e.g. "
                            f"{bad[0][:16]}")
    if args.require_postmortem:
        ok = [p for p in report["postmortems"] if p["spans"] > 0]
        if not ok:
            failures.append("no digest-valid post-mortem with spans "
                            "found")
        if report["corrupt_postmortems"]:
            failures.append(f"{len(report['corrupt_postmortems'])} "
                            f"corrupt post-mortem(s)")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
