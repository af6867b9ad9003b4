#!/usr/bin/env python3
"""Time H10's split against its warm-up on one card: the table of the
warm-up's rule (``tridiag.WARM_BITS``) against the share of speculative
segments that joined without a replay and H10's time.

    python3 tools/time_td_split.py [--shapes 2560x2048,4096x4096]
                                   [--cs 12.5,25,50] [--bits 0,32,38,44,50]
                                   [--steps 40] [--reps 5]

For each shape and diffusion number c (cx = cy = c) a ``--steps`` CN-ADI
solve (``tridiag.batched_adi_kernel``) of ``inidat`` runs at each rule
(the planner's split with ``WARM_BITS`` set to each value in turn) and
unsplit (P = 1): ``solve_ms``, the mean of ``--reps`` solves by CUDA
events; ``x_half_ms``, one x half (H10's right-hand-side build) on the
solve's last grid, the mean of 40 launches; ``W``, the warm-up's rows at
that c; ``hit_share``, the speculative segments of the timed solves that
needed no replay, in %. Prints one JSON line with the card's name and
power limit, and writes it to ``--out`` when given. Exits 1 without a
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from checkout_timing import card, load, time_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="2560x2048,4096x4096")
    ap.add_argument("--cs", default="12.5,25,50")
    ap.add_argument("--bits", default="0,32,38,44,50")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    got = load(str(Path(__file__).resolve().parents[1]), "ops.tridiag",
               "time_td_split")
    if got is None:
        return 1
    torch, td = got
    from heat2d_tpu_torch.obs.metrics import get_registry
    from heat2d_tpu_torch.ops.init import inidat
    reg = get_registry()

    def counts():
        td.collect_split_replays()
        return [sum(reg.find_counters(k).values()) for k in
                ("td_split_segments_total", "td_split_replays_total")]

    rules = [("unsplit", None)] + [(f"bits={b}", int(b))
                                   for b in args.bits.split(",")]
    bits0, min_rows = td.WARM_BITS, td.SPLIT_MIN_ROWS
    table = []
    try:
        for shape in args.shapes.split(","):
            nx, ny = (int(v) for v in shape.split("x"))
            u0 = inidat(nx, ny, device="cuda")[None].contiguous()
            for cval in (float(v) for v in args.cs.split(",")):
                c = torch.full((1,), cval, device="cuda")
                coefs = td.adi_coeffs(u0, c, c)
                cp = float(coefs[0][0, 0, nx - 2])
                for key, bits in rules:
                    td.SPLIT_MIN_ROWS = 1 << 30 if bits is None else min_rows
                    td.WARM_BITS = bits0 if bits is None else bits
                    plan = td.plan_td_rows(1, nx, ny, "cuda", True)

                    def solve():
                        return td.batched_adi_kernel(
                            u0, c, c, steps=args.steps, coefs=coefs)
                    before = counts()
                    solve_ms = time_ms(torch, solve, args.reps)
                    segs, reps = (a - b for a, b in zip(counts(), before))
                    last = solve()
                    table.append({
                        "shape": shape, "c": cval, "rule": key,
                        "P": plan.segments, "seg_rows": plan.seg_rows,
                        "W": (min(plan.seg_rows, td.warm_rows(cp, bits))
                              if plan.segments > 1 else 0),
                        "solve_ms": solve_ms,
                        "x_half_ms": time_ms(torch, lambda: td.td_rows_rhs(
                            last, c, c, coefs[0]), 40),
                        "segments": segs, "replays": reps,
                        "hit_share": (100.0 * (1 - reps / segs) if segs
                                      else None)})
                    print(json.dumps(table[-1]), file=sys.stderr,
                          flush=True)
    finally:
        td.WARM_BITS, td.SPLIT_MIN_ROWS = bits0, min_rows
    line = json.dumps({"card": card(), "steps": args.steps,
                       "reps": args.reps, "table": table})
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
