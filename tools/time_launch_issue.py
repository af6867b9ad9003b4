#!/usr/bin/env python3
"""Time the host's issue of H2 ``tile_multi`` launches of a checkout of
the port on one card.

    python3 tools/time_launch_issue.py [--root DIR]

Imports ``heat2d_tpu_torch`` from the checkout at DIR (default: the one
this script sits in), whose kernels build there at first use, and calls
``cuda_stencil.tile_multi`` at 2560x2048 (depth 8, cx = cy = 0.1) in
20 chunks of 500 launches, 10,000 in all. Only the issue loop of a chunk
is timed, on the host's clock, and the card is drained between chunks:
500 launches stay below the launch queue's depth, so the host never
waits on the card and the time is what the wrapper, the allocator and
the driver cost the host for a launch. Run it on two checkouts in turns (parent, change, change,
parent, ...) to compare two versions of the calling seam on one card.

Prints one JSON line: the root, the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), the microseconds a launch of each chunk in order, and their
median and minimum. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from checkout_timing import card, load

CHUNKS, PER_CHUNK = 20, 500


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1]
    ap.add_argument("--root", default=str(here))
    args = ap.parse_args(argv)
    got = load(args.root, "ops.cuda_stencil", "time_launch_issue")
    if got is None:
        return 1
    torch, cs = got

    u = torch.rand(2560, 2048, device="cuda")
    for _ in range(50):                 # build, plan and warm the pool
        cs.tile_multi(u, 8, 0.1, 0.1)
    torch.cuda.synchronize()
    us = []
    for _ in range(CHUNKS):
        t0 = time.perf_counter()
        for _ in range(PER_CHUNK):
            cs.tile_multi(u, 8, 0.1, 0.1)
        us.append((time.perf_counter() - t0) / PER_CHUNK * 1e6)
        torch.cuda.synchronize()
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "card": card(), "shape": "2560x2048",
                      "launches": CHUNKS * PER_CHUNK,
                      "us_per_launch": us,
                      "median_us": statistics.median(us),
                      "min_us": min(us)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
