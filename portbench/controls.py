"""The control and the faults of each cell's check, each put in the
program's place under a whole run of the harness (``harness.run_cell``),
which has to come out not correct:

- ``control``: the plain reference computed one precision below the
  configuration's (bfloat16 for its float32; the stencil has no matrix
  product, so TF32 does not apply), in place of the solve or of the
  server's launch;
- ``half_steps``: the program run for half the steps, reporting them all;
- ``unchanged``: the program run, and its answer replaced by the initial
  field, as a step that returns its state unchanged gives;
- ``sound``: the program as it is, for the readings a limit's lower end
  is set from.

    python3 portbench/controls.py --workload solve-2560x2048 \\
        --seconds 2 --seeds 1 2 3 --variants sound control

runs each seed and variant in one process at the cell's own sizes on the
first card and prints one JSON line a run: the cell, seed, variant,
``correct``, every number the check read (also those the cell sets no
limit for) and the cell's limits. The benchmark's own runs do not run
it; ``tests/test_portbench_control.py`` and
``tests/test_portbench_faults.py`` run it on the CPU at small sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import harness  # noqa: E402

VARIANTS = ("sound", "control", "half_steps", "unchanged")


def _bf16():
    import torch
    return torch.bfloat16


def _control(drv) -> None:
    from portbench.reference import heat5
    c = drv.cell.config
    conv = getattr(drv, "conv", False)

    def solve(cxs, cys):
        grids, done = heat5.solve(
            drv.nx, drv.ny, drv.steps, cxs, cys, dtype=_bf16(),
            device=drv.devices[0], interval=c["interval"] if conv else 0,
            sensitivity=c["sensitivity"])
        return [(g.float().cpu().numpy(), k) for g, k in zip(grids, done)]

    if drv.kind == "serve":
        drv.wrap = lambda solve_batch: (
            lambda reqs: solve([r.cx for r in reqs], [r.cy for r in reqs]))
    else:
        def one(cx, cy):
            (u, k), = solve([cx], [cy])
            return types.SimpleNamespace(u=u, steps_done=k,
                                         residual_reads=0)
        drv._solve = one


def _half_steps(drv) -> None:
    if drv.kind == "serve":
        def wrap(solve_batch):
            def half(reqs):
                got = solve_batch([dataclasses.replace(r, steps=r.steps // 2)
                                   for r in reqs])
                return [(u, r.steps) for (u, _), r in zip(got, reqs)]
            return half
        drv.wrap = wrap
        return
    orig = drv._solve

    def half(cx, cy):
        full = drv.steps
        drv.steps = full // 2
        try:
            r = orig(cx, cy)
        finally:
            drv.steps = full
        r.steps_done = full
        return r
    drv._solve = half


def _unchanged(drv) -> None:
    import torch

    from portbench.reference import heat5
    init = heat5.inidat(drv.nx, drv.ny, torch.float32).numpy()
    if drv.kind == "serve":
        def wrap(solve_batch):
            def unchanged(reqs):
                return [(init.copy(), k) for _, k in solve_batch(reqs)]
            return unchanged
        drv.wrap = wrap
        return
    orig = drv._solve

    def unchanged(cx, cy):
        r = orig(cx, cy)
        r.u = init.copy()
        return r
    drv._solve = unchanged


HOOKS = {"sound": None, "control": _control, "half_steps": _half_steps,
         "unchanged": _unchanged}


def run_variant(name: str, variant: str, seed: int, seconds: float, *,
                device: str = "cuda", cell=None) -> dict:
    """One whole run of cell ``name`` with ``variant`` in the program's
    place: the run's result, with ``readings``, every number the check
    read."""
    readings = {}
    hook = HOOKS[variant]

    def on_driver(drv):
        if hook is not None:
            hook(drv)
        check = drv.check

        def recording():
            got = check()
            readings.update(got)
            return got
        drv.check = recording

    result = harness.run_cell(name, seed, seconds, False, device=device,
                              cell=cell, on_driver=on_driver)
    result["readings"] = readings
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    args = ap.parse_args(argv)
    harness.prepare_environment(CHECKOUT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for variant in args.variants:
            t = time.perf_counter()
            r = run_variant(cell.name, variant, seed, args.seconds,
                            cell=cell)
            print(json.dumps({
                "workload": cell.name, "seed": seed, "variant": variant,
                "correct": r["correct"], "readings": r["readings"],
                "limits": cell.limits, "attempted": r["attempted"],
                "failed": r["failed"], "metrics": r["metrics"],
                "card": torch.cuda.get_device_name(0),
                "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
