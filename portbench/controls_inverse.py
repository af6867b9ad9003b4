"""The control and the faults of the inverse cells' check, each put in
the program's place under a whole run of the harness, which has to come
out not correct:

- ``control``: the plain reference (``reference/inverse.py``) computed
  in bfloat16, one precision below the configuration's float32, as the
  loss and gradient of every job and of the check;
- ``half_pullback``: the loss of the whole forward, but the gradient
  pulled back over half the steps (the program's differentiable solve
  of ``steps // 2`` steps, whose pullback is ``(A^T)^(steps/2)``: the
  step is linear);
- ``zero_gradient``: the program's loss, and the gradient left at zero;
- ``half_forward``: the program's loss and gradient of the problem run
  for half the steps;
- ``unchanged``: the program's loss and gradient, and the Adam update
  dropped (the problem's projection hands back the first iterate), so
  every job ends where it started;
- ``sound``: the program as it is.

Each but ``unchanged`` replaces the problem's ``value_and_grad`` (what
``solve`` and the check both call) in the jobs the driver makes;
``unchanged`` replaces its ``project``.

    python3 portbench/controls_inverse.py --workload inverse-2560x2048 \\
        --seconds 10 --seeds 1 2 3 --variants sound control

prints one JSON line a run, as ``controls.py`` does. The benchmark's own
runs do not run it; ``tests/test_portbench_inverse.py`` runs it on the
CPU at small sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import harness  # noqa: E402

VARIANTS = ("sound", "control", "half_pullback", "zero_gradient",
            "half_forward", "unchanged")


def _f32(problem):
    import numpy as np
    import torch
    dev = torch.device(problem.device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return dev, f


def _control_vg(problem):
    import torch

    from portbench.reference import inverse
    dev, f = _f32(problem)
    mask = f(problem.obs_mask).bool()
    obs = f(problem.obs_values)

    def vg(params):
        lo, g = inverse.value_and_grad(
            params[None], problem.steps, [problem.cx], [problem.cy], mask,
            obs, dtype=torch.bfloat16)
        return lo[0].float(), g[0].float()
    return vg


def _half_pullback_vg(problem):
    import torch

    from heat2d_tpu_torch.diff.adjoint import make_diff_solve
    dev, f = _f32(problem)
    fwd = make_diff_solve(problem.nx, problem.ny, problem.steps,
                          device=dev)
    back = make_diff_solve(problem.nx, problem.ny, problem.steps // 2,
                           device=dev)
    mask, obs = f(problem.obs_mask), f(problem.obs_values)
    n_obs = mask.sum()
    cx, cy = f(problem.cx), f(problem.cy)

    def vg(params):
        u = fwd(params, cx, cy)
        r = (u - obs) * mask
        loss = torch.sum(r * r) / n_obs
        with torch.enable_grad():
            p = params.detach().requires_grad_()
            (g,) = torch.autograd.grad(back(p, cx, cy), p, 2 * r / n_obs)
        return loss, g
    return vg


def _zero_gradient_vg(problem):
    import torch
    sound = problem.value_and_grad()

    def vg(params):
        loss, g = sound(params)
        return loss, torch.zeros_like(g)
    return vg


def _half_forward_vg(problem):
    return dataclasses.replace(problem,
                               steps=problem.steps // 2).value_and_grad()


def _unchanged(problem):
    """The problem with its update dropped: each iterate projected back
    onto the first."""
    dev, f = _f32(problem)
    first = problem.initial_params()
    problem.project = lambda: (lambda params: f(first))
    return problem


def _with_vg(make_vg):
    def plant(problem):
        vg = make_vg(problem)
        problem.value_and_grad = lambda: vg
        return problem
    return plant


PLANTS = {"control": _with_vg(_control_vg),
          "half_pullback": _with_vg(_half_pullback_vg),
          "zero_gradient": _with_vg(_zero_gradient_vg),
          "half_forward": _with_vg(_half_forward_vg),
          "unchanged": _unchanged}


def _hook(variant: str):
    plant = PLANTS.get(variant)
    if plant is None:
        return None

    def hook(drv):
        orig = drv._problem
        drv._problem = lambda k: plant(orig(k))
    return hook


HOOKS = {v: _hook(v) for v in VARIANTS}


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
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    harness.prepare_environment(CHECKOUT)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    for seed in args.seeds:
        for variant in args.variants:
            t = time.perf_counter()
            r = run_variant(cell.name, variant, seed, args.seconds,
                            device=args.device, cell=cell)
            print(json.dumps({
                "workload": cell.name, "seed": seed, "variant": variant,
                "correct": r["correct"], "readings": r["readings"],
                "limits": cell.limits, "attempted": r["attempted"],
                "failed": r["failed"], "metrics": r["metrics"],
                "card": card, "seconds": time.perf_counter() - t}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
