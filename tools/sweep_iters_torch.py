"""The iteration axis on the port: Report.pdf Tables 10-11 on the H100.

The counterpart of ``benchmarks/sweep_iters.py``. The reference shows its
CUDA kernel's per-step cost is constant by sweeping iterations 10 ->
100,000 at fixed grids (Table 10 p.26: times; Table 11 p.27: the speedup
over 10 iterations tracks the iteration ratio). The two-point estimator
of the port's headline relies on that linearity; this sweep measures it
for a mode of the port's solver on ``--device`` (the card by default).

Protocol: one solver per step count, warmed up once (the build and the
first launch excluded, like the reference's cudaEvent placement), then
the minimum of 3 fenced wall-clocks. Columns:

- total (s): the minimum for the row's step count;
- per-step (s): total / steps, which the fence's fixed cost inflates at
  small counts;
- marginal (s/step): (total_k - total_{k-1}) / (steps_k - steps_{k-1})
  between consecutive decades, the fence cancelled, given only where the
  window clears ``NOISE_FLOOR_S``; its constancy is the linearity claim;
- x vs 10 iters: total / total_10, Table 11's diagnostic.

Sections merge by (mode, grid, platform) key into one file under
``--out`` (default ``chiprun_out/sweeps``): each run replaces its own
sections and renders the whole file.

    python3 tools/sweep_iters_torch.py 2560 2048 pallas
    python3 tools/sweep_iters_torch.py 640 1024 pallas --max-steps 10000
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STEP_COUNTS = [10, 100, 1_000, 10_000, 100_000]
REPS = 3
#: A decade's window below this many seconds gets no marginal: the card's
#: fence costs microseconds, but the host clock between two runs varies by
#: milliseconds (a shared host), so a 20 ms window bounds a marginal's
#: error at roughly +-10%.
NOISE_FLOOR_S = 0.02


def measure(nx: int, ny: int, mode: str = "pallas", gridx: int = 1,
            gridy: int = 1, device=None, counts=STEP_COUNTS, reps=REPS):
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    from heat2d_tpu_torch.parallel.mesh import host_devices

    devices = (host_devices(gridx * gridy, device)
               if mode in ("dist1d", "dist2d", "hybrid") else None)
    rows = []
    for steps in counts:
        cfg = HeatConfig(nxprob=nx, nyprob=ny, steps=steps, mode=mode,
                         gridx=gridx, gridy=gridy)
        solver = Heat2DSolver(cfg, device=device, devices=devices)
        ts = [solver.run(timed=True, warmup=(i == 0), gather=False).elapsed
              for i in range(reps)]
        rows.append({"steps": steps, "total_s": min(ts)})
        print(json.dumps(rows[-1]), file=sys.stderr)
    return finish(rows)


def finish(rows, floor=None):
    """Add per-step, x-vs-10 and the marginals to measured rows."""
    floor = NOISE_FLOOR_S if floor is None else floor
    for i, r in enumerate(rows):
        r["per_step_s"] = r["total_s"] / r["steps"]
        r["x_vs_10it"] = (r["total_s"] / rows[0]["total_s"]
                          if rows[0]["total_s"] else None)
        if i:
            p = rows[i - 1]
            dt = r["total_s"] - p["total_s"]
            if dt > floor:
                r["marginal_s"] = dt / (r["steps"] - p["steps"])
            else:
                r["marginal_noise"] = True
    return rows


def section_markdown(rows, key, floor=None) -> str:
    floor = NOISE_FLOOR_S if floor is None else floor
    lines = [
        f"## {key['mode']} {key['grid']} on {key['platform']}"
        + (f" (mesh {key['mesh']})" if key.get("mesh") else ""), "",
        "| steps | total (s) | per-step (s) | marginal (s/step) "
        "| x vs 10 iters | steps ratio |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        marg = r.get("marginal_s")
        if marg is not None:
            mcell = f"{marg:.3g}"
        elif r.get("marginal_noise"):
            mcell = "(window < noise floor)"
        else:
            mcell = "—"
        x10 = r["x_vs_10it"]
        lines.append(
            f"| {r['steps']} | {r['total_s']:.4g} "
            f"| {r['per_step_s']:.3g} "
            f"| {mcell} "
            f"| {'—' if x10 is None else format(x10, '.4g')} "
            f"| {r['steps'] // 10} |")
    margs = [r["marginal_s"] for r in rows if "marginal_s" in r]
    if margs:
        spread = max(margs) / min(margs)
        lines += [
            "",
            f"Marginal spread across the decades whose window clears "
            f"the {floor} s fence-noise floor: {spread:.3f}x "
            f"(min {min(margs):.3e}, max {max(margs):.3e} s/step).",
        ]
    return "\n".join(lines) + "\n"


def render(all_rows, floor=None) -> str:
    head = [
        "# Iteration-axis sweep: Tables 10-11 on the port", "",
        "Per-step cost across 10 -> 100k iterations per path: the "
        "linearity the two-point headline relies on (Report.pdf "
        "p.26-27). 'per-step' divides the fenced wall-clock; 'marginal' "
        "differences consecutive decades, cancelling the fence; a "
        "constant marginal is linear scaling; 'x vs 10 it' is Table 11's "
        "diagnostic.", "",
    ]
    groups = {}
    for r in all_rows:
        groups.setdefault(json.dumps(r["key"], sort_keys=True),
                          []).append(r)
    parts = []
    for key_s, rows in groups.items():
        rows = sorted(rows, key=lambda r: r["steps"])
        parts.append(section_markdown(rows, json.loads(key_s), floor))
    return "\n".join(head) + "\n" + "\n".join(parts)


def main(argv=None) -> int:
    from tools.sweep_torch import card_line, platform_of, write_atomic
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("nx", nargs="?", type=int, default=2560)
    p.add_argument("ny", nargs="?", type=int, default=2048)
    p.add_argument("modes", nargs="?", default="pallas")
    p.add_argument("--device", default=None)
    p.add_argument("--gridx", type=int, default=1)
    p.add_argument("--gridy", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=STEP_COUNTS[-1])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "sweeps"))
    args = p.parse_args(argv)

    platform, is_cpu = platform_of(args.device)
    card = "cpu" if is_cpu else card_line()
    label = f"{platform.rsplit(' x', 1)[0]} ({card})"
    counts = [c for c in STEP_COUNTS if c <= args.max_steps]
    path = os.path.join(args.out, "sweep_iters.jsonl")
    os.makedirs(args.out, exist_ok=True)
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = [json.loads(line) for line in f if line.strip()]
    new_keys, new_rows = [], []
    for mode in args.modes.split(","):
        key = {"mode": mode, "grid": f"{args.nx}x{args.ny}",
               "platform": label}
        if args.gridx * args.gridy > 1:
            key["mesh"] = f"{args.gridx}x{args.gridy}"
        new_keys.append(json.dumps(key, sort_keys=True))
        for r in measure(args.nx, args.ny, mode, args.gridx, args.gridy,
                         args.device, counts):
            r["key"] = key
            new_rows.append(r)
    kept = [r for r in existing
            if json.dumps(r.get("key"), sort_keys=True) not in new_keys]
    all_rows = kept + new_rows
    write_atomic(path, "".join(json.dumps(r) + "\n" for r in all_rows))
    md = render(all_rows)
    write_atomic(os.path.join(args.out, "sweep_iters.md"), md)
    print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
