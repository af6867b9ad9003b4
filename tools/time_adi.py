#!/usr/bin/env python3
"""Time Crank-Nicolson ADI solves of a checkout of the port on one card.

    python3 tools/time_adi.py [--root DIR] [--shapes 2560x2048,4096x4096]
                              [--steps 40] [--c 25.0] [--reps 5]

Imports ``heat2d_tpu_torch`` from the checkout at DIR (default: the one
this script sits in), whose kernels build there at first use, and times
``tridiag.batched_adi_kernel`` on each shape's ``inidat`` grid at cx =
cy = c, the (cp, mi) of both axes computed once beforehand (as a solve
of ``Heat2DSolver`` hoists them): one warm solve, then the mean of
``--reps`` back-to-back solves by CUDA events (``solve_ms``). A second
pass under ``torch.profiler`` sums the device time of every kernel and
copy of ``--reps`` solves by name (``device_ms``, per solve) and gives
its launches per solve. Run it on two checkouts one after the other to
compare two versions of the ADI step on the same card.

Prints one JSON line: the root, the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and per shape the numbers above. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from checkout_timing import card, load, time_ms


def device_ms(torch, fn, reps: int) -> dict:
    """{device op name: [ms per solve, launches per solve]} under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.device_type.name == "CUDA":
            out[e.key] = [dev_us / 1e3 / reps, e.count / reps]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1]
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--shapes", default="2560x2048,4096x4096")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--c", type=float, default=25.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    got = load(args.root, "ops.tridiag", "time_adi")
    if got is None:
        return 1
    torch, td = got
    from heat2d_tpu_torch.ops.init import inidat

    shapes = {}
    for shape in args.shapes.split(","):
        nx, ny = (int(v) for v in shape.split("x"))
        u = inidat(nx, ny, device="cuda")[None].contiguous()
        c = torch.full((1,), args.c, dtype=torch.float32, device="cuda")
        coefs = td.adi_coeffs(u, c, c)

        def solve():
            return td.batched_adi_kernel(u, c, c, steps=args.steps,
                                         coefs=coefs)
        shapes[shape] = {
            "solve_ms": time_ms(torch, solve, args.reps),
            "device_ms": device_ms(torch, solve, args.reps)}
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "card": card(), "steps": args.steps,
                      "c": args.c, "shapes": shapes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
