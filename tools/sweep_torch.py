"""The Report.pdf sweep on the port: grid sizes x modes on the H100.

The counterpart of ``benchmarks/sweep.py``. The reference's protocol
(Report.pdf p.21-32) sweeps one problem over a grid-size axis (80x64 ...
2560x2048) and a parallelism axis, timing the step loop with setup
excluded. Here every point runs the port's solver (``models.solver.
Heat2DSolver``) on ``--device`` (the card by default):

- ``chip``: every reference size, plus 4096^2 (and 8192^2 in a full run),
  in mode serial (plain PyTorch) and pallas (H1-H4: H4 below the
  resident gate, H2 sweeps above it), hybrid (H12/H14 on one shard) at
  the large sizes; Tables 1 and 10/11's grid axis;
- ``conv``: convergence rows at the reference's sizes (Tables 4-6), and
  at the large sizes (fixed, sensitivity 0) pairs whose two-point
  marginals give the residual schedule's cost (pallas: H3);
- ``scaling``: strong scaling of dist2d over 1, 2, 4, ... slots
  (Tables 2-3);
- ``mesh``: dist1d / dist2d / hybrid on ``--slots`` shard slots of the
  card (``host_devices(n)``: slots on one card run one after another, so
  these rows measure the decomposition's cost, not a cluster's gain).

Fixed-step points report the two-point marginal step time
(``tune.measure.two_point_estimate``: the fence's fixed cost cancelled,
``hi`` grown x10 until two decades agree within ``AGREE_FACTOR``);
convergence points with a data-dependent exit report end-to-end
wall-clock. ``sanity_pass`` re-measures rows that ``suspect_rows``
flags, a decade higher. The rows print as JSON lines and go, with a
markdown table and the card's name and power limit, to ``--out``
(default ``chiprun_out/sweeps``).

    python3 tools/sweep_torch.py --suite chip            # on the card
    python3 tools/sweep_torch.py --suite chip --quick    # ~5 s
    python3 tools/sweep_torch.py --suite mesh --slots 4
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from heat2d_tpu_torch.tune.measure import (AGREE_FACTOR,  # noqa: E402
                                           two_point_estimate)

#: The reference's sweep sizes (Report.pdf Table 1) and 4096^2.
REF_SIZES = [(80, 64), (160, 128), (320, 256), (640, 512),
             (1280, 1024), (2560, 2048)]
NORTH_STAR = (4096, 4096)

#: The reference's own wall-clocks, 100 steps each (Report.pdf via
#: BASELINE.md): Table 1's serial (1 task) column, its best (160 tasks),
#: the CUDA table's Mcells/s; Tables 4/6 with convergence.
REF_SERIAL_S = {(80, 64): 2.53e-2, (160, 128): 9.87e-2, (320, 256): 7.52e-1,
                (640, 512): 3.01, (1280, 1024): 12.7, (2560, 2048): 50.9}
REF_BEST_S = {(80, 64): 9.30e-3, (160, 128): 2.91e-2, (320, 256): 1.04e-1,
              (640, 512): 2.13e-1, (1280, 1024): 2.52e-1,
              (2560, 2048): 5.18e-1}
REF_CUDA_MCELLS = {(1280, 1024): 705.0, (2560, 2048): 669.0}
REF_CONV_SERIAL_S = {(80, 64): 3.33e-2, (160, 128): 1.24e-1,
                     (320, 256): 8.51e-1, (640, 512): 3.39,
                     (1280, 1024): 15.8, (2560, 2048): 62.9}
REF_CONV_BEST_S = {(80, 64): 2.06e-1, (160, 128): 2.49e-1,
                   (320, 256): 2.29e-1, (640, 512): 2.42e-1,
                   (1280, 1024): 2.63e-1, (2560, 2048): 4.80e-1}

#: The two-point ceiling: the reference's CUDA tables amortize over up to
#: 100k iterations (Report.pdf p.26).
MAX_HI_STEPS = 100_000


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them ("not measured" where
    it is missing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        line = out.stdout.strip().splitlines()
        return line[0] if out.returncode == 0 and line else "not measured"
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"


def run_point(mode, nx, ny, steps, gridx=1, gridy=1, convergence=False,
              max_hi=MAX_HI_STEPS, min_hi=None, sensitivity=None,
              device=None):
    """One sweep row: the two-point marginal (fixed steps, or convergence
    at sensitivity 0, which checks on schedule and never exits) or the
    end-to-end wall-clock (convergence with an exit). The distributed
    modes run on gridx * gridy slots of ``device`` (``host_devices``)."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    from heat2d_tpu_torch.obs.record import attach_context
    from heat2d_tpu_torch.parallel.mesh import host_devices

    devices = None
    if mode in ("dist1d", "dist2d", "hybrid"):
        devices = host_devices(gridx * gridy, device)
    solvers = {}

    def timed_run(n):
        # the first call at a step count warms up; repeats run warm
        fresh = n not in solvers
        if fresh:
            kw = {} if sensitivity is None else dict(sensitivity=sensitivity)
            cfg = HeatConfig(nxprob=nx, nyprob=ny, steps=n, mode=mode,
                             gridx=gridx, gridy=gridy,
                             convergence=convergence, **kw)
            solvers[n] = Heat2DSolver(cfg, device=device, devices=devices)
        return solvers[n].run(timed=True, warmup=fresh, gather=False)

    rec = {"mode": mode, "grid": f"{nx}x{ny}", "mesh": f"{gridx}x{gridy}"}
    marginal_conv = convergence and sensitivity == 0.0
    step_time = None
    if convergence and not marginal_conv:
        result = timed_run(steps)
        rec.update(steps=int(result.steps_done),
                   elapsed_s=round(result.elapsed, 6),
                   mcells_per_s=round(result.mcells_per_s, 2),
                   method="end-to-end", convergence=True)
    else:
        lo = max(steps // 5, 1)
        hi0 = max(steps, min_hi or 0, lo + 1)
        step_time, hi, result = two_point_estimate(timed_run, lo, hi0,
                                                   max_hi)
        if step_time is not None:
            rec.update(steps=hi, elapsed_s=round(result.elapsed, 6),
                       step_time_s=round(step_time, 9),
                       mcells_per_s=round(nx * ny / step_time / 1e6, 2),
                       method="two-point")
        else:
            rec.update(steps=hi, elapsed_s=round(result.elapsed, 6),
                       mcells_per_s=round(result.mcells_per_s, 2),
                       method="end-to-end (two-point within noise)")
        if marginal_conv:
            rec.update(convergence=True, sensitivity=0.0)
    rec["route"] = result.route

    ref_serial = REF_CONV_SERIAL_S if convergence else REF_SERIAL_S
    ref_best = REF_CONV_BEST_S if convergence else REF_BEST_S
    ref_s = ref_serial.get((nx, ny))
    if ref_s is not None:
        # the reference's tables are 100-step wall-clocks: like for like
        # is the marginal step time x 100 (end-to-end for convergence
        # rows with an exit); noise-fallback rows get no ratio
        if convergence and not marginal_conv:
            ours_100 = rec["elapsed_s"]
        else:
            ours_100 = step_time * 100 if step_time is not None else None
        if ours_100:
            rec["ref_serial_100step_s"] = ref_s
            rec["speedup_vs_ref_serial"] = round(ref_s / ours_100, 2)
            rec["ref_best_160task_s"] = ref_best[(nx, ny)]
            rec["speedup_vs_ref_best"] = round(ref_best[(nx, ny)]
                                               / ours_100, 2)
    ref_mc = REF_CUDA_MCELLS.get((nx, ny))
    if ref_mc is not None:
        rec["ref_cuda_mcells_per_s"] = ref_mc
        rec["vs_ref_cuda"] = round(rec["mcells_per_s"] / ref_mc, 2)
    return attach_context(rec, "sweep-point", device)


def mesh_shapes(n_devices):
    """Closest-to-square factorization plus the 1D strip shape."""
    gx = int(n_devices ** 0.5)
    while n_devices % gx:
        gx -= 1
    shapes = [(gx, n_devices // gx)]
    if gx != 1:
        shapes.append((n_devices, 1))
    return shapes


def suite_chip(steps, quick):
    sizes = REF_SIZES[:2] if quick else REF_SIZES + [NORTH_STAR,
                                                     (8192, 8192)]
    for nx, ny in sizes:
        if nx >= 8192:
            modes = ("pallas", "hybrid")
        elif not quick and nx * ny >= 1280 * 1024:
            modes = ("serial", "pallas", "hybrid")
        else:
            modes = ("serial", "pallas")
        for mode in modes:
            yield dict(mode=mode, nx=nx, ny=ny, steps=steps)


def suspect_rows(records):
    """Indices of fixed-step rows whose accepted marginal is implausible
    and deserves one re-measure a decade higher:

    - an accelerated mode reporting over 10x slower than the same grid's
      serial marginal;
    - within one mode and mesh shape, a smaller grid slower per step than
      a bigger one by more than ``AGREE_FACTOR`` (small grids are
      latency-bound, so step times are flat there; only a violation
      beyond the estimator's own tolerance counts);
    - among the large grids (>= 1280x1024) of a kernel mode (pallas,
      hybrid) of one mesh shape, per-cell step times more than
      ``AGREE_FACTOR`` apart: every row of that group re-measures (two
      rows cannot say which is wrong).
    """
    def mesh(r):
        return r.get("mesh", "1x1")

    serial_st = {r["grid"]: r["step_time_s"] for r in records
                 if r["mode"] == "serial" and "step_time_s" in r}

    def cells(r):
        nx, ny = r["grid"].split("x")
        return int(nx) * int(ny)

    out = set()
    for i, r in enumerate(records):
        st = r.get("step_time_s")
        if st is None:
            continue
        base = serial_st.get(r["grid"])
        if r["mode"] != "serial" and base and st > 10 * base:
            out.add(i)
        for q in records:
            qt = q.get("step_time_s")
            if (qt is not None and q["mode"] == r["mode"]
                    and mesh(q) == mesh(r)
                    and cells(q) > cells(r) and st > AGREE_FACTOR * qt):
                out.add(i)
    big = {}
    for i, r in enumerate(records):
        st = r.get("step_time_s")
        if (st is not None and cells(r) >= 1280 * 1024
                and r["mode"] in ("pallas", "hybrid")):
            big.setdefault((r["mode"], mesh(r)), []).append(
                (i, st / cells(r)))
    for group in big.values():
        percell = [p for _, p in group]
        if len(group) > 1 and max(percell) > AGREE_FACTOR * min(percell):
            out.update(i for i, _ in group)
    return sorted(out)


def sanity_pass(records, points, max_hi, device=None):
    """Re-measure the suspect rows with the starting window a decade up;
    the re-measured row replaces the original, flagged ``rechecked``."""
    for i in suspect_rows(records):
        old = records[i]
        print(f"# suspect row (re-measuring): {json.dumps(old)}",
              file=sys.stderr)
        min_hi = min(int(old["steps"]) * 10, max_hi)
        rec = run_point(**points[i], max_hi=max_hi, min_hi=min_hi,
                        device=device)
        rec.update(suite=old.get("suite"), platform=old.get("platform"),
                   card=old.get("card"), rechecked=True)
        records[i] = rec
        print(json.dumps(rec))
    return records


def suite_conv(steps, quick):
    """Convergence rows at the reference's sizes (end to end, exits
    allowed) and, at the large sizes, (fixed, sensitivity 0) two-point
    pairs whose ratio is the residual schedule's cost
    (``add_conv_overhead``)."""
    sizes = REF_SIZES[:2] if quick else REF_SIZES
    for nx, ny in sizes:
        for mode in ("serial", "pallas"):
            yield dict(mode=mode, nx=nx, ny=ny, steps=steps,
                       convergence=True)
    big = [s for s in sizes if s[0] * s[1] >= 1280 * 1024]
    if not quick:
        big.append(NORTH_STAR)
    for nx, ny in big:
        for mode in ("serial", "pallas", "hybrid"):
            yield dict(mode=mode, nx=nx, ny=ny, steps=steps)
            yield dict(mode=mode, nx=nx, ny=ny, steps=steps,
                       convergence=True, sensitivity=0.0)


def add_conv_overhead(records):
    """% cost of the residual schedule from each (fixed, sensitivity 0)
    two-point pair."""
    fixed = {(r["mode"], r["grid"], r["mesh"]): r.get("step_time_s")
             for r in records if not r.get("convergence")}
    for r in records:
        if r.get("sensitivity") == 0.0 and r.get("step_time_s"):
            base = fixed.get((r["mode"], r["grid"], r["mesh"]))
            if base:
                r["conv_overhead_pct"] = round(
                    (r["step_time_s"] / base - 1) * 100, 1)
    return records


def suite_scaling(steps, quick, n_devices):
    """Strong scaling at a fixed size over power-of-two slot counts."""
    nx, ny = (320, 256) if quick else (2560, 2048)
    n = 1
    while n <= n_devices:
        gx, gy = mesh_shapes(n)[0]
        yield dict(mode="dist2d", nx=nx, ny=ny, steps=steps,
                   gridx=gx, gridy=gy)
        n *= 2


def add_scaling_columns(records):
    """Speedup against the one-slot row and parallel efficiency, from the
    marginal step times where there are any."""
    def cost(r):
        return r.get("step_time_s") or r["elapsed_s"]
    base = next((cost(r) for r in records if r["mesh"] == "1x1"), None)
    for r in records:
        gx, gy = map(int, r["mesh"].split("x"))
        if base:
            r["speedup_vs_1dev"] = round(base / cost(r), 2)
            r["efficiency"] = round(base / cost(r) / (gx * gy), 3)
    return records


def suite_mesh(steps, quick, n_devices):
    sizes = REF_SIZES[:2] if quick else REF_SIZES
    for nx, ny in sizes:
        for gx, gy in mesh_shapes(n_devices):
            mode = "dist1d" if gy == 1 and gx != 1 else "dist2d"
            if nx % gx or ny % gy:      # the reference's divisibility rule
                continue
            yield dict(mode=mode, nx=nx, ny=ny, steps=steps,
                       gridx=gx, gridy=gy)
            if mode == "dist1d":
                # Table 13's pair (Report.pdf p.28): row strips against
                # 2D blocks at the same grid and slot count
                yield dict(mode="dist2d", nx=nx, ny=ny, steps=steps,
                           gridx=gx, gridy=gy)
    gx, gy = mesh_shapes(n_devices)[0]
    for nx, ny in reversed(sizes):
        if nx % gx == 0 and ny % gy == 0:
            yield dict(mode="hybrid", nx=nx, ny=ny, steps=steps,
                       gridx=gx, gridy=gy)
            break


def redesign_payoff(records):
    """Table 13's pairs: for each grid where both decompositions ran on
    the same slot count, the cost ratio dist1d / dist2d. Returns [(grid,
    ndev, mesh1d, cost1d, mesh2d, cost2d, ratio)]."""
    def cost(r):
        return r.get("step_time_s") or r["elapsed_s"] / max(r["steps"], 1)

    rows = []
    by_grid = {}
    for r in records:
        gx, gy = map(int, r["mesh"].split("x"))
        by_grid.setdefault((r["grid"], gx * gy), {})[
            (r["mode"], r["mesh"])] = r
    for (grid, ndev), d in sorted(by_grid.items()):
        d1 = next((v for (m, _), v in d.items() if m == "dist1d"), None)
        d2 = next((v for (m, mesh), v in d.items()
                   if m == "dist2d" and "1" not in mesh.split("x")), None)
        if d1 and d2:
            rows.append((grid, ndev, d1["mesh"], cost(d1),
                         d2["mesh"], cost(d2),
                         round(cost(d1) / cost(d2), 2)))
    return rows


def to_markdown(records, platform, is_cpu_host, card="not measured"):
    scaling = any("speedup_vs_1dev" in r for r in records)
    conv_oh = any("conv_overhead_pct" in r for r in records)
    extra_hdr = " speedup vs 1 dev | efficiency |" if scaling else ""
    if conv_oh:
        extra_hdr += " conv overhead % |"
    lines = [f"# heat2d-tpu-torch sweep ({platform}; {card})", ""]
    if is_cpu_host:
        lines += [
            "**CPU run.** These wall-clocks check the harness and the "
            "port's programs end to end; they are not card numbers.", ""]
    lines += [
        "Reference columns: Report.pdf via BASELINE.md (100-step "
        "wall-clocks on the HellasGrid cluster, up to 160 MPI tasks, and "
        "a 2 GB GPU). Step time and Mcells/s are two-point marginals "
        "(the fence's fixed cost cancelled, amortized over the steps "
        "shown); 'elapsed' is the largest timed run end to end. Speedup "
        "columns compare the reference's 100-step wall-clock with our "
        "marginal step time x 100. Mesh rows run their shard slots on "
        "one card, one after another.", "",
        "| mode | grid | mesh | route | steps | step time (s) | Mcells/s | "
        "elapsed (s) | method | ref serial 100-step (s) | speedup vs ref "
        f"serial | vs ref best (160 tasks) | vs ref CUDA |{extra_hdr}",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|"
        + ("---|---|" if scaling else "") + ("---|" if conv_oh else ""),
    ]
    for r in records:
        st = r.get("step_time_s")
        mode_cell = r["mode"]
        if r.get("sensitivity") == 0.0:
            mode_cell += " +conv(sens=0)"
        elif r.get("convergence"):
            mode_cell += " +conv"
        row = (
            f"| {mode_cell} | {r['grid']} | {r['mesh']} "
            f"| {r.get('route', '—')} | {r['steps']} "
            f"| {f'{st:.3g}' if st else '—'} "
            f"| {r['mcells_per_s']:.6g} "
            f"| {r['elapsed_s']:.4g} "
            f"| {r['method']}{' +recheck' if r.get('rechecked') else ''} "
            f"| {r.get('ref_serial_100step_s', '—')} "
            f"| {r.get('speedup_vs_ref_serial', '—')} "
            f"| {r.get('speedup_vs_ref_best', '—')} "
            f"| {r.get('vs_ref_cuda', '—')} |")
        if scaling:
            row += (f" {r.get('speedup_vs_1dev', '—')} "
                    f"| {r.get('efficiency', '—')} |")
        if conv_oh:
            row += f" {r.get('conv_overhead_pct', '—')} |"
        lines.append(row)

    payoff = redesign_payoff(records)
    if payoff:
        lines += [
            "", "## Redesign payoff: Table 13's pairs", "",
            "Report.pdf p.28 measures the old row-strip program against "
            "the redesigned 2D-grid program at the same grid and task "
            "count (up to 7.89x). Here dist1d against dist2d on the same "
            "slots, per-step cost (marginal where the two-point window "
            "cleared noise, elapsed/steps otherwise).", "",
            "| grid | slots | dist1d mesh | dist1d step (s) | dist2d "
            "mesh | dist2d step (s) | dist1d/dist2d |",
            "|---|---|---|---|---|---|---|",
        ]
        for grid, ndev, m1, c1, m2, c2, ratio in payoff:
            lines.append(f"| {grid} | {ndev} | {m1} | {c1:.3g} "
                         f"| {m2} | {c2:.3g} | {ratio} |")
    return "\n".join(lines) + "\n"


def write_atomic(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def platform_of(device) -> tuple:
    """(label, is_cpu): the device kind times the count of its type."""
    import torch

    from heat2d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu x1", True
    return (f"{torch.cuda.get_device_name(dev)} "
            f"x{torch.cuda.device_count()}"), False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--suite", default="chip",
                   choices=["chip", "mesh", "conv", "scaling"])
    p.add_argument("--steps", type=int, default=100,
                   help="the reference's default (grad1612_mpi_heat.c:7); "
                        "fixed-step points grow it until the two-point "
                        "window clears the fence's jitter")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default: the card) or cpu")
    p.add_argument("--slots", type=int, default=4,
                   help="shard slots of the mesh and scaling suites "
                        "(host_devices(n) on --device)")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "sweeps"))
    args = p.parse_args(argv)

    platform, is_cpu = platform_of(args.device)
    card = "cpu" if is_cpu else card_line()
    print(f"# sweep on {platform} ({card})", file=sys.stderr)
    if args.suite == "chip":
        points = list(suite_chip(args.steps, args.quick))
    elif args.suite == "conv":
        points = list(suite_conv(args.steps, args.quick))
    elif args.suite == "scaling":
        points = list(suite_scaling(args.steps, args.quick, args.slots))
    else:
        points = list(suite_mesh(args.steps, args.quick, args.slots))

    max_hi = 1000 if args.quick else MAX_HI_STEPS
    records = []
    for pt in points:
        t0 = time.perf_counter()
        rec = run_point(**pt, max_hi=max_hi, device=args.device)
        rec.update(suite=args.suite, platform=platform, card=card)
        records.append(rec)
        print(json.dumps(rec))
        print(f"  [{time.perf_counter() - t0:.1f}s incl. warmup]",
              file=sys.stderr)

    records = sanity_pass(records, points, max_hi, device=args.device)
    if args.suite == "scaling":
        add_scaling_columns(records)
    elif args.suite == "conv":
        add_conv_overhead(records)

    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.suite}{'_quick' if args.quick else ''}"
    write_atomic(os.path.join(args.out, f"sweep_{tag}.jsonl"),
                 "".join(json.dumps(r) + "\n" for r in records))
    write_atomic(os.path.join(args.out, f"sweep_{tag}.md"),
                 to_markdown(records, platform, is_cpu, card))
    print(f"# wrote {args.out}/sweep_{tag}.jsonl and .md", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
