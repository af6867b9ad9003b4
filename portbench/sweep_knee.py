"""Find the knee of a serving cell once, by a sweep on the card: one
process sets the cell up, then offers each rate open loop for the given
seconds and prints a JSON line per rate (offered and completed requests
a second, p50/p95/p99, how long the backlog took to drain after the
window, refusals, members a launch). The knee is the highest rate at
which nothing is refused and the backlog does not grow: the completed
rate keeps up with the offered one and the drain stays short.

    python3 portbench/sweep_knee.py --workload serve-640x1024 \\
        --seed 7 --seconds 10 --rates 80 100 120 140
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))

from portbench import harness, yardstick  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.prepare_environment(CHECKOUT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    drv = harness.driver_class(cell.traffic["driver"])(
        cell, args.seed, [torch.device("cuda", 0)])
    t = time.perf_counter()
    drv.setup()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "setup_s": time.perf_counter() - t}), flush=True)
    for rate in args.rates:
        r = drv.run_rate(rate, args.seconds)
        done = [v for v in r["latencies"] if v is not None]
        row = {"rate": rate, "attempted": r["attempted"],
               "completed_per_s": r["completed_in_window"] / args.seconds,
               "failed": r["failed"], "drain_s": r["drain_s"],
               "members_per_launch": (sum(drv.occupancy)
                                      / max(1, len(drv.occupancy)))}
        for q in (50, 95, 99):
            row[f"p{q}_ms"] = 1e3 * yardstick.percentile_missing_inf(
                r["latencies"], q)
        row["completed"] = len(done)
        print(json.dumps(row), flush=True)
    drv.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
