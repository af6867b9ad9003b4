#!/usr/bin/env python3
"""Time H4 ``resident`` of a checkout of the port on one card.

    python3 tools/time_resident.py [--root DIR] [--steps 20,10000]

Imports ``heat2d_tpu_torch`` from the checkout at DIR (default: the one
this script sits in), whose kernels build there at first use, and times
``cuda_stencil.resident`` on the reference CUDA program's 640x1024 grid
(``inidat``, cx = cy = 0.1, FMA form) for each step count, by CUDA
events as ``chip_smoke.py`` times it: one warm call, then the mean of
``--reps`` back-to-back calls. Run it on two checkouts one after the
other to compare two versions of H4 on the same card: 20 steps is the
chunk the resident route launches per convergence check, 10000 the
fixed run.

Prints one JSON line: the root, the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and the milliseconds per step count. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from checkout_timing import card, load, time_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1]
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--steps", default="20,10000")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    got = load(args.root, "ops.cuda_stencil", "time_resident")
    if got is None:
        return 1
    torch, cs = got
    from heat2d_tpu_torch.ops.init import inidat

    u = inidat(640, 1024, device="cuda")
    ms = {}
    for n in (int(s) for s in args.steps.split(",")):
        reps = max(1, min(args.reps, 20000 // n))
        ms[str(n)] = time_ms(
            torch, lambda: cs.resident(u, n, 0.1, 0.1), reps)
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "card": card(),
                      "shape": "640x1024", "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
