#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s load phase several times on one card.

    python3 tools/load_runs.py [--runs 3] [--measure-baseline]

Builds the kernels, runs the fleet phase once for the trace campaign
that the load phase replays, then the load phase ``--runs`` times in
one process: each run gates leg 2's gated surface against the committed
card baseline (``heat2d_tpu_torch/load/baseline_h100.json``), so that
the gate's verdict is seen on several runs of one card. With
``--measure-baseline`` each run measures instead: the committed file,
if any, is compared and reported but not required, the gated surface's
rates come from leg 2's probe, and the gated surface is written as a
baseline candidate to
``chiprun_out/load_baseline_h100.json``.

Prints each run's line and the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them); the runs go to ``chiprun_out/load_runs.json``. Exits 1 if any
run fails, 2 without a card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="load_runs.py")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--measure-baseline", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("load_runs.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from heat2d_tpu_torch.io.binary import write_json_atomic

    runs = []
    trace_dir = tempfile.mkdtemp(prefix="heat2d-fleet-")
    try:
        tool = cs.phase_toolchain(torch)
        cs.phase_build()
        name, power = tool["name"], tool["power_limit"]
        fleet = cs.phase_fleet(torch, name, power, trace_dir)
        for _ in range(args.runs):
            runs.append(cs.phase_load(torch, name, power, trace_dir,
                                      measure=args.measure_baseline))
    except cs.SmokeFailure as e:
        print(f"load_runs.py: FAILED after {len(runs)} run(s): {e}",
              file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
        write_json_atomic({"runs": runs}, cs._out_path("load_runs.json"))
    print(cs.smi("name,power.limit"))
    cs.emit({"runs": len(runs), "fleet_seconds": fleet["seconds"],
             "load_seconds": [r["seconds"] for r in runs],
             "committed_gate": [r["serve"].get("committed_gate")
                                for r in runs]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
