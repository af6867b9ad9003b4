"""``heat2d-tpu-torch-prof``: the mpiP-style digest of a captured
``torch.profiler`` trace (the port's counterpart of
``heat2d_tpu/obs/trace_report.py``).

``utils.profiling.profile_span(LOGDIR)`` (the solver CLI's ``--profile``)
writes one Chrome-trace JSON per capture into LOGDIR
(``<host>_<pid>.<ns>.pt.trace.json``); this tool turns the latest capture
into the mpiP tables as markdown or JSON, with the JAX digest's schema
and keys (``heat2d_tpu.obs.trace_report.to_markdown`` renders it):

- **Top ops by self-time**: each device op (kernel, memcpy, memset) with
  total seconds, share and count, and ``kernel``, the hand kernel's label
  (H1-H14, ``td_coeffs``) or None for a library kernel. The labels read
  the demangled name's base and template arguments: ``k_tile`` is H2, or
  H3 when its ``RESID`` argument is true; ``k_ens_tile`` H6 or H7;
  ``k_shard_tile`` H12 or H13; the other ``k_*`` names map one to one
  (``csrc/*.cu``).
- **Per-lane category shares** (AppTime/MPITime): compute (kernels),
  collective (``nccl*`` kernels), host/transfer (Memcpy, Memset) per
  device lane (a CUDA stream), and each lane's **idle share** over the
  capture window: the gaps between its events, the longest of them with
  the host annotations (``phase``/``annotate``) open at each gap's middle.
- **Sync**: the host's waits on the card (``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaEventSynchronize``), per host thread.
  They are category ``sync`` and never device idle time: the waits of a
  persistent kernel (H4/H5/H8's error-word read) show here.
- **Kernels**: time, count, share and mean per hand-kernel label.

A capture without device lanes (a run on the CPU) digests the host
threads' outermost aten ops instead, as the JAX digest reads the CPU
backend's executor threads, so the workflow runs without a card.

    heat2d-tpu-torch --profile /tmp/prof --mode pallas ...   # capture
    heat2d-tpu-torch-prof /tmp/prof                          # markdown
    heat2d-tpu-torch-prof /tmp/prof --format json            # JSON
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys

DIGEST_SCHEMA = "heat2d-tpu/trace-digest/v1"

#: Chrome-trace categories of the device's own events: a stream holding
#: any of them is a device lane. (``gpu_user_annotation``, a host range
#: drawn on the stream, spans its kernels and is not counted.)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: Host runtime calls that wait for the card: category ``sync``.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")

#: Hand kernel base name -> its label, or (the label when the template
#: argument at that index is true, the label when false, the index).
KERNEL_LABELS = {
    "k_step": "H1",
    "k_tile": ("H3", "H2", 1),
    "k_resident": "H4",
    "k_ens_resident": "H5",
    "k_ens_tile": ("H7", "H6", 0),
    "k_fam_resident": "H8",
    "k_fam_tile": "H9",
    "k_td_rows": "H10",
    "k_td_lanes": "H11",
    "k_td_coeffs": "td_coeffs",
    "k_shard_tile": ("H13", "H12", 1),
    "k_shard_fused": "H14",
}

_KERNEL_NAME = re.compile(r"(?<![A-Za-z0-9_])(k_[a-z_]+)\b")

#: Longest gaps listed per device lane.
GAPS_LISTED = 5


def _template_args(name: str, at: int) -> list:
    """The top-level template arguments of the ``<...>`` that opens at
    ``name[at]`` (after spaces), or [] when none does."""
    while at < len(name) and name[at] == " ":
        at += 1
    if at >= len(name) or name[at] != "<":
        return []
    out, depth, cur = [], 0, ""
    for ch in name[at:]:
        if ch == "<":
            depth += 1
            if depth == 1:
                continue
        elif ch == ">":
            depth -= 1
            if depth == 0:
                break
        if ch == "," and depth == 1:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    out.append(cur.strip())
    return out


def _true(arg: str) -> bool:
    return arg in ("true", "1", "(bool)1")


def kernel_label(name: str):
    """The hand kernel's label of a demangled kernel name (base name and
    template arguments; the parameter list is ignored), or None."""
    for m in _KERNEL_NAME.finditer(name):
        spec = KERNEL_LABELS.get(m.group(1))
        if spec is None:
            continue
        if isinstance(spec, str):
            return spec
        on, off, i = spec
        args = _template_args(name, m.end())
        return on if i < len(args) and _true(args[i]) else off
    return None


def categorize(name: str, cat: str = "kernel") -> str:
    """The mpiP category of an event: ``collective`` (NCCL kernels),
    ``compute`` (other kernels and host ops), ``host/transfer`` (Memcpy,
    Memset), ``sync`` (the host's waits on the card)."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "host/transfer"
    if cat == "cuda_runtime" and name in SYNC_CALLS:
        return "sync"
    if "nccl" in name.lower():
        return "collective"
    return "compute"


def find_trace_files(logdir: str) -> list:
    return sorted(
        glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                  recursive=True)
        + glob.glob(os.path.join(logdir, "**", "*.pt.trace.json.gz"),
                    recursive=True))


def _read(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _span_of(events: list) -> tuple:
    ts = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
          if e.get("ph") == "X" and "ts" in e]
    if not ts:
        return None
    return min(a for a, _ in ts), max(b for _, b in ts)


def load_events(logdir: str) -> list:
    """Merged events of the LATEST capture: the newest file, and any
    other whose events overlap it in time (the processes of one world
    profiled together; one host's clock). Older captures in a reused
    logdir are skipped, with a note. Each file's pids are namespaced when
    several merge, so that same-numbered lanes stay distinct."""
    paths = find_trace_files(logdir)
    if not paths:
        raise FileNotFoundError(
            f"no *.pt.trace.json under {logdir}: is this a torch.profiler "
            f"logdir (heat2d-tpu-torch --profile)?")
    newest = max(paths, key=os.path.getmtime)
    loaded = {p: _read(p) for p in paths}
    lo_hi = _span_of(loaded[newest])
    run = [newest]
    for p in paths:
        if p == newest or lo_hi is None:
            continue
        s = _span_of(loaded[p])
        if s is not None and s[0] <= lo_hi[1] and lo_hi[0] <= s[1]:
            run.append(p)
    run.sort()
    if len(run) < len(paths):
        print(f"note: digesting the latest capture only ({len(run)} of "
              f"{len(paths)} trace files)", file=sys.stderr)
    events = []
    for i, path in enumerate(run):
        for e in loaded[path]:
            if len(run) > 1 and "pid" in e:
                e = dict(e, pid=f"h{i}:{e['pid']}")
                if e.get("ph") == "M" and e.get("name") in (
                        "process_name", "process_labels"):
                    # each file's lanes keep their own rows, as mpiP's
                    # per-rank rows
                    args = dict(e.get("args", {}))
                    key = "labels" if "labels" in args else "name"
                    args[key] = f"h{i}:{args.get(key, '')}"
                    e["args"] = args
            events.append(e)
    return events


def has_kernel_events(path: str) -> bool:
    """Whether a capture file holds a CUDA kernel event."""
    return any(e.get("cat") == "kernel" for e in _read(path))


def _lane_names(events: list) -> tuple:
    """(pid -> process label, (pid, tid) -> thread name)."""
    pids, tids = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        args = e.get("args", {})
        if e.get("name") == "process_labels":
            pids[e["pid"]] = args.get("labels", "")
        elif e.get("name") == "process_name":
            pids.setdefault(e["pid"], args.get("name", ""))
        elif e.get("name") == "thread_name":
            tids[(e["pid"], e.get("tid"))] = args.get("name", "")
    return pids, tids


def _merge(ivals: list) -> list:
    out = []
    for a, b in sorted(ivals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _outermost(ivals: list) -> list:
    """The (ts, end, event) triples not contained in an earlier one."""
    out, end = [], None
    for a, b, e in sorted(ivals, key=lambda x: (x[0], -x[1])):
        if end is None or a >= end:
            out.append((a, b, e))
            end = b
    return out


def _open_at(annots: list, t: float) -> list:
    """Names of the host annotations open at time t, outermost first."""
    hits = [(a, -(b - a), n) for a, b, n in annots if a <= t <= b]
    return [n for *_, n in sorted(hits)]


def digest(events: list, top: int = 25) -> dict:
    """Aggregate trace events into the mpiP-shaped digest dict."""
    pids, tids = _lane_names(events)
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]

    def lane_of(e) -> str:
        pid, tid = e["pid"], e.get("tid")
        p = pids.get(pid) or f"device {pid}"
        t = (tids.get((pid, tid)) or "").strip() or f"stream {tid}"
        return f"{p}/{t}"

    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if device:
        ops_ev = [(e, categorize(e.get("name", ""), e["cat"]))
                  for e in device if e.get("dur", 0) > 0]
    else:
        # no device lane: the host threads' outermost aten ops
        by_thread: dict = collections.defaultdict(list)
        for e in xs:
            if e.get("cat") == "cpu_op" and e.get("dur", 0) > 0:
                by_thread[(e["pid"], e.get("tid"))].append(
                    (e["ts"], e["ts"] + e["dur"], e))
        ops_ev = [(e, "compute") for ivals in by_thread.values()
                  for _, _, e in _outermost(ivals)]

    ops: dict = collections.defaultdict(lambda: [0.0, 0, None, None])
    lanes: dict = collections.defaultdict(
        lambda: collections.defaultdict(float))
    busy: dict = collections.defaultdict(list)
    for e, cat in ops_ev:
        name = e.get("name", "")
        dur_s = e["dur"] / 1e6
        row = ops[name]
        row[0] += dur_s
        row[1] += 1
        row[2] = cat
        row[3] = kernel_label(name) if e.get("cat") == "kernel" else None
        lane = lane_of(e)
        lanes[lane][cat] += dur_s
        busy[lane].append((e["ts"], e["ts"] + e["dur"]))

    annotations: dict = collections.defaultdict(lambda: [0.0, 0])
    annots = []
    sync: dict = collections.defaultdict(
        lambda: collections.defaultdict(lambda: [0.0, 0]))
    for e in xs:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and e.get("dur", 0) > 0:
            annotations[name][0] += e["dur"] / 1e6
            annotations[name][1] += 1
            annots.append((e["ts"], e["ts"] + e["dur"], name))
        elif cat == "cuda_runtime" and name in SYNC_CALLS:
            s = sync[lane_of(e)][name]
            s[0] += e.get("dur", 0) / 1e6
            s[1] += 1

    window = ((min(e["ts"] for e in xs),
               max(e["ts"] + e.get("dur", 0) for e in xs))
              if xs else (0.0, 0.0))
    span_us = window[1] - window[0]

    total = sum(r[0] for r in ops.values())
    top_ops = [
        {"op": name, "category": cat, "kernel": label,
         "total_s": round(s, 6), "count": n,
         "share_pct": round(100.0 * s / total, 2) if total else 0.0}
        for name, (s, n, cat, label) in sorted(ops.items(),
                                               key=lambda kv: -kv[1][0])
    ][:top]

    kern: dict = collections.defaultdict(lambda: [0.0, 0])
    for name, (s, n, _cat, label) in ops.items():
        if label is not None:
            kern[label][0] += s
            kern[label][1] += n
    kernels = [
        {"kernel": label, "total_s": round(s, 6), "count": n,
         "share_pct": round(100.0 * s / total, 2) if total else 0.0,
         "mean_ms": round(1e3 * s / n, 6)}
        for label, (s, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])]

    cat_totals: dict = collections.defaultdict(float)
    lane_rows = []
    for lane in sorted(lanes):
        cats = lanes[lane]
        lane_total = sum(cats.values())
        for c, s in cats.items():
            cat_totals[c] += s
        merged = _merge(busy[lane])
        busy_us = sum(b - a for a, b in merged)
        edges = [window[0]] + [x for iv in merged for x in iv] + [window[1]]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)
        lane_rows.append({
            "lane": lane,
            "total_s": round(lane_total, 6),
            "categories": {c: round(s, 6) for c, s in sorted(cats.items())},
            # mpiP's MPI% column: collective share of this lane's time.
            "collective_pct": round(
                100.0 * cats.get("collective", 0.0) / lane_total, 2)
            if lane_total else 0.0,
            "busy_s": round(busy_us / 1e6, 6),
            "idle_s": round((span_us - busy_us) / 1e6, 6),
            "idle_pct": (round(100.0 * (span_us - busy_us) / span_us, 2)
                         if span_us > 0 else 0.0),
            "gaps": [{"start_ms": round((t0 - window[0]) / 1e3, 6),
                      "dur_ms": round(d / 1e3, 6),
                      "annotations": _open_at(annots, t0 + d / 2)}
                     for d, t0 in gaps[:GAPS_LISTED]],
        })
    sync_rows = []
    for lane in sorted(sync):
        calls = sync[lane]
        s = sum(v[0] for v in calls.values())
        cat_totals["sync"] += s
        sync_rows.append({"lane": lane, "total_s": round(s, 6),
                          "count": sum(v[1] for v in calls.values()),
                          "calls": {k: round(v[0], 6)
                                    for k, v in sorted(calls.items())}})

    return {
        "schema": DIGEST_SCHEMA,
        "device_lanes": bool(device),
        "window_s": round(span_us / 1e6, 6),
        "total_op_s": round(total, 6),
        "n_lanes": len(lane_rows),
        "categories": {c: round(s, 6)
                       for c, s in sorted(cat_totals.items())},
        "top_ops": top_ops,
        "kernels": kernels,
        "lanes": lane_rows,
        "sync": sync_rows,
        "annotations": [
            {"name": n, "total_s": round(s, 6), "count": c}
            for n, (s, c) in sorted(annotations.items(),
                                    key=lambda kv: -kv[1][0])][:top],
    }


def to_markdown(d: dict, logdir: str = "") -> str:
    lines = [
        "# Trace digest, the mpiP analogue"
        + (f" ({logdir})" if logdir else ""),
        "",
        "Aggregated from the captured `torch.profiler` events: per-op "
        "self-time shares of the device lanes (CUDA streams), each "
        f"lane's idle share over the {d['window_s']:.4g} s capture "
        "window, and the host's waits on the card. "
        + ("" if d.get("device_lanes", True) else
           "No device lane in this capture: the host threads' outermost "
           "aten ops stand in for it. "),
        "",
        "## Per-lane category shares and idle time", "",
        "| lane | total (s) | collective % | idle % | breakdown |",
        "|---|---|---|---|---|",
    ]
    for row in d["lanes"]:
        br = ", ".join(f"{c}={s:.4g}s" for c, s in row["categories"].items())
        lines.append(f"| {row['lane']} | {row['total_s']:.4g} "
                     f"| {row['collective_pct']} | {row['idle_pct']} "
                     f"| {br} |")
    if d.get("kernels"):
        lines += ["", "## Hand kernels", "",
                  "| kernel | time (s) | share | count | mean (ms) |",
                  "|---|---|---|---|---|"]
        for k in d["kernels"]:
            lines.append(f"| {k['kernel']} | {k['total_s']:.4g} "
                         f"| {k['share_pct']}% | {k['count']} "
                         f"| {k['mean_ms']:.4g} |")
    lines += [
        "", "## Top ops by self-time (per-callsite analogue)", "",
        "| op | kernel | category | time (s) | share | count |",
        "|---|---|---|---|---|---|",
    ]
    for op in d["top_ops"]:
        lines.append(f"| `{op['op'][:80]}` | {op.get('kernel') or '—'} "
                     f"| {op['category']} | {op['total_s']:.4g} "
                     f"| {op['share_pct']}% | {op['count']} |")
    gaps = [(row["lane"], g) for row in d["lanes"] for g in row["gaps"]]
    if gaps:
        lines += ["", "## Longest idle gaps", "",
                  "| lane | start (ms) | gap (ms) | host annotations open |",
                  "|---|---|---|---|"]
        for lane, g in gaps:
            lines.append(f"| {lane} | {g['start_ms']:.4g} "
                         f"| {g['dur_ms']:.4g} "
                         f"| {' > '.join(g['annotations']) or '—'} |")
    if d.get("sync"):
        lines += ["", "## Host waits on the card (sync)", "",
                  "| host lane | time (s) | count | calls |",
                  "|---|---|---|---|"]
        for s in d["sync"]:
            calls = ", ".join(f"{k}={v:.4g}s" for k, v in s["calls"].items())
            lines.append(f"| {s['lane']} | {s['total_s']:.4g} "
                         f"| {s['count']} | {calls} |")
    if d.get("annotations"):
        lines += ["", "## Host annotations (profile_span / annotate)", "",
                  "| span | time (s) | count |", "|---|---|---|"]
        for a in d["annotations"]:
            lines.append(
                f"| {a['name']} | {a['total_s']:.4g} | {a['count']} |")
    return "\n".join(lines) + "\n"


def report(logdir: str, top: int = 25) -> dict:
    """Load and digest in one call (the library entry point)."""
    return digest(load_events(logdir), top=top)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-prof",
        description="mpiP-style digest of a torch.profiler logdir "
                    "(capture one with: heat2d-tpu-torch --profile "
                    "LOGDIR ...)")
    p.add_argument("logdir", help="profiler logdir to digest")
    p.add_argument("--top", type=int, default=25,
                   help="rows in the top-op table (default 25)")
    p.add_argument("--format", default="md", choices=["md", "json"],
                   help="stdout format (default markdown)")
    p.add_argument("--json-out", default=None,
                   help="also write the JSON digest to this path")
    args = p.parse_args(argv)
    try:
        d = report(args.logdir, top=args.top)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    if args.json_out:
        from heat2d_tpu_torch.io.binary import write_json_atomic
        write_json_atomic(d, args.json_out)
    if args.format == "json":
        print(json.dumps(d, indent=2))
    else:
        print(to_markdown(d, logdir=args.logdir), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
