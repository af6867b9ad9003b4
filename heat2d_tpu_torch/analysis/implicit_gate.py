"""The implicit-route acceptance gate, as a program: the port of
``heat2d_tpu/analysis/implicit_gate.py``.

    python -m heat2d_tpu_torch.analysis.implicit_gate             # card
    python -m heat2d_tpu_torch.analysis.implicit_gate --device cpu

Four legs:

1. **Algorithmic speed**: ADI reaches a fixed ``t_final`` at matched L2
   accuracy (against the analytic separable mode) in >= 100x fewer steps
   and >= 10x lower MODELED wall-clock than the explicit scheme
   (``models/solution.py``; the model is deterministic, so the verdict
   does not ride host jitter; the measured wall-clock is printed beside
   it). On the card the explicit leg runs H6 and the ADI leg H10/H11;
   the float64 twin (truncation-dominated: ADI's error at or below the
   explicit one's) runs the plain steps.
2. **Serve repeatability**: a ``method="adi"`` bucket answers bit for
   bit the same across independent engines AND across launch
   capacities.
3. **Mesh parity**: on ``host_devices(8)`` (8 slots of the device), the
   mesh runner's ADI answers are bit for bit the one-device runner's.
4. **Capacity ladder**: the build sentinel
   (``analysis/recompile.serve_compile_report``) holds the
   O(log max_batch) capacity contract and builds nothing twice for both
   implicit routes.

Exit 0 iff every leg passes; failures print as ``FAIL: ...`` lines.
"""

from __future__ import annotations

import argparse
import sys


def run_gate(device=None, out=sys.stdout) -> int:
    import numpy as np
    import torch

    from heat2d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    kernels = dev.type == "cuda"
    failures = []

    def check(name, ok, detail=""):
        line = f"{'PASS' if ok else 'FAIL'}: {name}"
        if detail:
            line += f" ({detail})"
        print(line, file=out if ok else sys.stderr)
        if not ok:
            failures.append(name)

    # -- leg 1: wall-clock to solution at matched accuracy ------------ #
    from heat2d_tpu_torch.models import solution

    tts = solution.time_to_solution(
        257, 257, steps_explicit=2560, step_ratio=256,
        methods=("explicit", "adi"), use_kernels=kernels, device=dev)
    s = tts["summary"]
    check("adi >= 100x fewer steps", s["adi_steps_ratio"] >= 100.0,
          f"ratio {s['adi_steps_ratio']:.0f}x")
    check("adi >= 10x modeled wall-clock-to-solution",
          s["adi_modeled_speedup"] >= 10.0,
          f"modeled {s['adi_modeled_speedup']:.1f}x, measured "
          f"{s['adi_wall_speedup']:.1f}x")
    rows = {r["method"]: r for r in tts["rows"]}
    check("adi matched L2 accuracy (f32)", s["adi_matched_accuracy"],
          f"adi {rows['adi']['accuracy']:.3e} vs explicit "
          f"{rows['explicit']['accuracy']:.3e}")
    tts64 = solution.time_to_solution(
        257, 257, steps_explicit=2560, step_ratio=256,
        methods=("explicit", "adi"), device=dev, dtype=np.float64)
    r64 = {r["method"]: r for r in tts64["rows"]}
    check("adi <= explicit L2 error (f64, truncation-dominated)",
          r64["adi"]["accuracy"] <= r64["explicit"]["accuracy"],
          f"adi {r64['adi']['accuracy']:.3e} vs explicit "
          f"{r64['explicit']['accuracy']:.3e}")

    # -- leg 2: serve-route bitwise repeatability --------------------- #
    from heat2d_tpu_torch.serve.engine import EnsembleEngine
    from heat2d_tpu_torch.serve.schema import SolveRequest

    req = SolveRequest(nx=24, ny=32, steps=4, cx=8.0, cy=6.0, method="adi")
    twin = SolveRequest(nx=24, ny=32, steps=4, cx=3.0, cy=2.0,
                        method="adi")
    a = EnsembleEngine(max_batch=8, device=dev).solve_batch([req])[0]
    b = EnsembleEngine(max_batch=8, device=dev).solve_batch([req])[0]
    check("adi answers bitwise-repeatably across engines",
          np.asarray(a[0]).tobytes() == np.asarray(b[0]).tobytes())
    # another occupancy pads to another capacity: the member must not
    # move a bit
    c = EnsembleEngine(max_batch=8, device=dev).solve_batch([req, twin])[0]
    check("adi bitwise across launch capacities",
          np.asarray(a[0]).tobytes() == np.asarray(c[0]).tobytes())

    # -- leg 3: mesh parity on 8 slots -------------------------------- #
    from heat2d_tpu_torch.mesh.runner import mesh_batch_runner, mesh_capacity
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.parallel.mesh import host_devices

    slots = tuple(host_devices(8, dev.type))
    nd = len(slots)
    b_ = mesh_capacity(nd, 4 * nd, nd)
    u0 = torch.from_numpy(np.random.default_rng(14).normal(
        size=(24, 32)).astype(np.float32)).to(dev).expand(b_, 24, 32) \
        .contiguous()
    cxs = torch.tensor([4.0 + i for i in range(b_)], dtype=torch.float32,
                       device=dev)
    cys = torch.tensor([2.0 + i for i in range(b_)], dtype=torch.float32,
                       device=dev)
    mesh_run = mesh_batch_runner(24, 32, 4, "adi", devices=slots)
    single = ensemble.batch_runner(24, 32, 4, "adi", device=str(dev))
    got = mesh_run(u0, cxs, cys).cpu().numpy()
    want = single(u0, cxs, cys).cpu().numpy()
    check(f"mesh({nd} slots) adi bitwise == one device",
          got.tobytes() == want.tobytes())

    # -- leg 4: the capacity ladder for both routes ------------------- #
    from heat2d_tpu_torch.analysis.recompile import serve_compile_report

    for method in ("adi", "mg"):
        rep = serve_compile_report(method=method, max_batch=8, device=dev)
        check(f"{method} capacity ladder O(log max_batch), no rebuild",
              rep["ok"],
              f"capacities {rep['capacities']} <= budget {rep['budget']}, "
              f"{rep['builds']} builds, {rep['loads']} loads, rebuilt "
              f"{rep['rebuilds']}")

    print("implicit-gate FAILED" if failures else "implicit-gate passed",
          file=out)
    return 1 if failures else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m heat2d_tpu_torch.analysis.implicit_gate",
        description="the implicit routes' acceptance gate (exit 0 iff "
                    "every leg passes)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (H6, H10/H11) or the CPU (the "
                        "plain versions)")
    args = p.parse_args(argv)
    from heat2d_tpu_torch.utils.device import DeviceUnavailableError
    try:
        return run_gate(args.device)
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
