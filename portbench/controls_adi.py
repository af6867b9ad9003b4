"""The control and the faults of the ADI cells' check, as ``controls.py``
plants them for the explicit ones, each put in the program's place under
a whole run of the harness, which has to come out not correct:

- ``control``: the plain reference (``reference/adi.py``) computed in
  bfloat16, one precision below the configuration's float32 (there is no
  matrix product, so TF32 does not apply), in place of each solve;
- ``half_steps`` and ``unchanged``: ``controls.py``'s hooks as they are
  (half the steps reported as all; the answer replaced by the initial
  field);
- ``sound``: the program as it is.

    python3 portbench/controls_adi.py --workload adi-2560x2048 \\
        --seconds 2 --seeds 1 2 3 --variants sound control

prints one JSON line a run, as ``controls.py`` does. The benchmark's own
runs do not run it; ``tests/test_portbench_adi_controls.py`` runs it on
the CPU at small sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import controls, harness  # noqa: E402

VARIANTS = controls.VARIANTS


def _control(drv) -> None:
    import torch

    from portbench.reference import adi

    def one(cx, cy):
        grids, done = adi.solve(drv.nx, drv.ny, drv.steps, [cx], [cy],
                                dtype=torch.bfloat16, device=drv.devices[0])
        return types.SimpleNamespace(u=grids[0].float().cpu().numpy(),
                                     steps_done=done[0], residual_reads=0)
    drv._solve = one


HOOKS = dict(controls.HOOKS, control=_control)


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
