"""Per-phase time shares of one run of the port: the mpiP analogue.

The counterpart of ``benchmarks/profile_phases.py``. The reference's
authors audited where time goes with mpiP (Report.pdf p.34-37: per
call-site MPI shares). This tool runs one configuration through the
port's CLI under ``--profile`` (``utils.profiling.profile_span``: the
whole run, warmup included), one process or each rank of a
``--world N`` world spawned by ``dist/harness.spawn_world``, cuts each
capture to its timed run (the ``timed_run`` range of ``utils/timing.
timed_call``), digests it with ``obs/trace_report.digest`` and splits it
into phases:

- **device** (per lane, summed): stencil compute (the hand kernels that
  advance the grid: H1, H2, H4-H6, H8, H9, H12, H14), the residual (H3,
  H7, H13, and PyTorch's reduction kernels), other PyTorch kernels
  (the plain loops' elementwise work), and copies (Memcpy/Memset: a
  world's strips staged through host buffers);
- **host** (the ``phase`` annotations of ``utils/profiling.py``, the JAX
  package's phase names): ``halo_exchange`` / ``halo_overlap`` (the
  exchange; across ranks split into ``halo_stage``, the waits on the
  card and the copies to pinned host buffers, ``halo_transfer``, gloo's
  sends and receives, and ``halo_unstage``, the copies back),
  ``stencil_chunk`` / ``interior_stencil`` (launching the kernels),
  ``residual_reduction``; and the synchronisation: the host's waits on
  the card (``cudaStreamSynchronize`` and its kind).

Each rank's split goes, with its run record's per-rank exchange totals
(``exchange_by_process``) and the card's name and power limit, to
``--out`` (default ``chiprun_out/phases``) as markdown and JSON.

    python3 tools/profile_phases_torch.py --mode pallas --nxprob 4096 \\
        --nyprob 4096 --steps 240
    python3 tools/profile_phases_torch.py --world 2 --mode hybrid \\
        --gridx 2 --gridy 2 --host-device-count 2 --nxprob 4096 \\
        --nyprob 4096 --steps 240       # a rank of the 2-process world
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: hand-kernel labels (``obs/trace_report.kernel_label``) by phase
STENCIL_KERNELS = {"H1", "H2", "H4", "H5", "H6", "H8", "H9", "H10", "H11",
                   "H12", "H14", "td_coeffs"}
RESIDUAL_KERNELS = {"H3", "H7", "H13"}

#: host annotation names (``utils.profiling.phase``/``annotate``) by
#: phase; the three ``halo_*`` parts lie inside an exchange that crosses
#: ranks (``parallel/halo.py``)
HOST_PHASES = {
    "halo_exchange": "halo exchange (host)",
    "halo_overlap": "halo exchange (host)",
    "halo_stage": "  of it: waits on the card + copies to host",
    "halo_transfer": "  of it: gloo sends and receives",
    "halo_unstage": "  of it: copies back to the card (enqueue)",
    "stencil_chunk": "stencil launches (host)",
    "interior_stencil": "stencil launches (host)",
    "residual_reduction": "residual reduction (host)",
}


def timed_window(events: list) -> list:
    """The events of the last ``timed_run`` range (``utils.timing.
    timed_call``) and the capture's metadata: the warmup run cut away.
    A capture without the range is returned whole."""
    runs = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name") == "timed_run"]
    if not runs:
        return events
    last = max(runs, key=lambda e: e["ts"])
    lo, hi = last["ts"], last["ts"] + last.get("dur", 0)
    return [e for e in events if e.get("ph") != "X"
            or lo <= e.get("ts", lo) <= hi]


def device_phase(op: dict) -> str:
    """The phase of one device op of a digest's ``top_ops``."""
    if op["category"] in ("host/transfer", "transfer"):
        return "copies (memcpy/memset)"
    if op["kernel"] in RESIDUAL_KERNELS:
        return "residual"
    if op["kernel"] in STENCIL_KERNELS:
        return "stencil compute"
    if "reduce" in op["op"].lower():
        return "residual"
    return "other PyTorch kernels"


def phase_split(d: dict) -> dict:
    """The device and host phase seconds of a digest (``trace_report.
    digest(events, top=...)`` with every op listed)."""
    device = {}
    for op in d["top_ops"]:
        key = device_phase(op)
        device[key] = device.get(key, 0.0) + op["total_s"]
    host, counts = {}, {}
    for a in d["annotations"]:
        key = HOST_PHASES.get(a["name"])
        if key is not None:
            host[key] = host.get(key, 0.0) + a["total_s"]
            counts[key] = counts.get(key, 0) + a["count"]
    host["synchronisation (host waits)"] = sum(
        s["total_s"] for s in d["sync"])
    counts["synchronisation (host waits)"] = sum(
        s["count"] for s in d["sync"])
    return {"window_s": d["window_s"], "device_s": d["total_op_s"],
            "device": device, "host": host, "host_counts": counts,
            "device_lanes": d["device_lanes"]}


def to_markdown(split: dict, title: str, provenance: str,
                exchange=None) -> str:
    lines = [f"## {title}", "", provenance, "",
             "| device phase | device-seconds | share of device time |",
             "|---|---|---|"]
    total = split["device_s"] or 1.0
    for k, s in sorted(split["device"].items(), key=lambda kv: -kv[1]):
        lines.append(f"| {k} | {s:.6f} | {100 * s / total:.1f}% |")
    lines.append(f"| **total** | **{split['device_s']:.6f}** | 100% |")
    lines += ["", "| host phase | seconds | spans | ms a span | share of "
              "the capture window |", "|---|---|---|---|---|"]
    win = split["window_s"] or 1.0
    for k, s in sorted(split["host"].items(), key=lambda kv: -kv[1]):
        n = split["host_counts"].get(k, 0)
        per = f"{1e3 * s / n:.4f}" if n else "—"
        lines.append(f"| {k} | {s:.6f} | {n} | {per} | "
                     f"{100 * s / win:.1f}% |")
    lines.append(f"| capture window | {split['window_s']:.6f} | | | 100% |")
    if exchange:
        ch = exchange.get("exchanges") or 0
        lines += ["", f"Timed run's cross-rank exchange (run record): "
                  f"{ch} exchanges, {exchange.get('phases')} phases, "
                  f"{exchange.get('bytes')} bytes, "
                  f"{exchange.get('seconds'):.6f} s"
                  + (f" ({1e3 * exchange['seconds'] / ch:.4f} ms an "
                     f"exchange)" if ch else "") + "."]
    return "\n".join(lines) + "\n"


def _cli_args(args, prof: str) -> list:
    out = ["--device", args.device, "--mode", args.mode,
           "--nxprob", str(args.nxprob), "--nyprob", str(args.nyprob),
           "--steps", str(args.steps), "--gridx", str(args.gridx),
           "--gridy", str(args.gridy), "--dat-layout", "none",
           "--profile", prof, "--outdir", os.path.join(args.out, "run")]
    if args.host_device_count:
        out += ["--host-device-count", str(args.host_device_count)]
    if args.convergence:
        out += ["--convergence"]
    return out


def run(args) -> list:
    """Run the configuration under ``--profile``; returns (rank,
    logdir, run record)."""
    rec_path = os.path.join(args.out, "record.json")
    if args.world > 1:
        from heat2d_tpu_torch.dist.harness import clean_env, spawn_world
        results = spawn_world(
            args.world, lambda i, coord: [
                sys.executable, "-m", "heat2d_tpu_torch.cli",
                "--coordinator", coord, "--num-processes", str(args.world),
                "--process-id", str(i), "--run-record", rec_path]
            + _cli_args(args, os.path.join(args.out, f"prof_rank{i}")),
            env=clean_env(), timeout=600)
        bad = [r for r in results if not r.ok]
        if bad:
            raise RuntimeError(f"the world failed: {bad[0].output[-2000:]}")
        ranks = list(range(args.world))
    else:
        from heat2d_tpu_torch import cli
        rc = cli.main(_cli_args(args, os.path.join(args.out, "prof_rank0"))
                      + ["--run-record", rec_path])
        if rc:
            raise RuntimeError(f"the run exited {rc}")
        ranks = [0]
    with open(rec_path) as f:
        rec = json.load(f)
    return [(r, os.path.join(args.out, f"prof_rank{r}"), rec)
            for r in ranks]


def main(argv=None) -> int:
    from heat2d_tpu_torch.obs import trace_report
    from tools.sweep_torch import card_line, write_atomic
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="pallas")
    p.add_argument("--nxprob", type=int, default=4096)
    p.add_argument("--nyprob", type=int, default=4096)
    p.add_argument("--steps", type=int, default=240)
    p.add_argument("--gridx", type=int, default=1)
    p.add_argument("--gridy", type=int, default=1)
    p.add_argument("--convergence", action="store_true")
    p.add_argument("--host-device-count", type=int, default=None)
    p.add_argument("--world", type=int, default=1,
                   help="processes of the world (1: this process)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "phases"))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    card = "cpu" if args.device == "cpu" else card_line()
    cmd = (f"`python3 tools/profile_phases_torch.py --mode {args.mode} "
           f"--nxprob {args.nxprob} --nyprob {args.nyprob} --steps "
           f"{args.steps} --gridx {args.gridx} --gridy {args.gridy}"
           + (f" --host-device-count {args.host_device_count}"
              if args.host_device_count else "")
           + (f" --world {args.world}" if args.world > 1 else "")
           + (" --convergence" if args.convergence else "")
           + f" --device {args.device}`")
    parts, out = [f"# Per-phase time shares ({card})", ""], []
    for rank, logdir, rec in run(args):
        d = trace_report.digest(
            timed_window(trace_report.load_events(logdir)), top=10 ** 6)
        split = phase_split(d)
        ex = (rec.get("exchange_by_process") or [None] * (rank + 1))[rank]
        el = (rec.get("elapsed_by_process") or [rec.get("elapsed_s")])
        prov = (f"Provenance: {cmd}; rank {rank} of {args.world}; "
                f"steps_done={rec.get('steps_done')}, timed elapsed "
                f"{el[rank] if rank < len(el) else el[0]} s; the split "
                f"reads the timed run's range of the capture.")
        parts.append(to_markdown(split, f"{args.mode} {args.nxprob}x"
                                 f"{args.nyprob}, rank {rank}", prov, ex))
        out.append({"rank": rank, "card": card, "split": split,
                    "exchange": ex, "record_elapsed": el})
    md = "\n".join(parts)
    write_atomic(os.path.join(args.out, "phases.md"), md)
    write_atomic(os.path.join(args.out, "phases.json"),
                 json.dumps(out, indent=2))
    print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
