"""``heat2d-tpu-torch-inverse``: the inverse-problem command of the port
(the counterpart of ``heat2d-tpu-inverse``).

- ``--selftest``: builds a known synthetic per-cell diffusivity field,
  observes the final state of its forward solve, submits the recovery as
  an ``InverseRequest`` to a running ``SolveServer`` (batcher, cache,
  inverse lane), and checks: the loss falls below the threshold, the
  recovered field beats the first guess 10x, a repeat is a cache hit
  with the same loss, the checkpointed adjoint equals the full-storage
  one bit for bit, and the per-iteration telemetry reached the registry.
  Exit 0 iff every check holds.
- direct mode: one inverse solve from flags, on observations either
  synthetic (``--observe-every``; the same bump field the selftest
  recovers) or read from ``save_field`` files (``--observations``,
  ``--obs-mask``); ``--save-recovered`` writes the result the same way.

``--metrics-out`` writes the registry snapshot and a ``kind="inverse"``
run record as JSONL, ``--run-record`` the record alone. ``--device cpu``
runs on the CPU (the band route, if taken, through H6's plain version);
without it the command runs on the card and refuses to start where there
is none.

    heat2d-tpu-torch-inverse --selftest --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from heat2d_tpu_torch.utils.device import DeviceUnavailableError
from heat2d_tpu_torch.utils.logs import add_log_level_flag, configure_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-inverse",
        description="differentiable-solve inverse problems on PyTorch/"
                    "CUDA: recover an initial condition or a per-cell "
                    "diffusivity field from sparse observations")
    p.add_argument("--selftest", action="store_true",
                   help="recover a known synthetic diffusivity field "
                        "through a running SolveServer and check the "
                        "differentiable-serving invariants; exit nonzero "
                        "on any failure")
    g = p.add_argument_group("problem")
    g.add_argument("--target", default="diffusivity",
                   choices=["init", "diffusivity"])
    g.add_argument("--nxprob", type=int, default=16)
    g.add_argument("--nyprob", type=int, default=16)
    g.add_argument("--steps", type=int, default=16)
    g.add_argument("--cx", type=float, default=0.1,
                   help="known x diffusivity (target=init)")
    g.add_argument("--cy", type=float, default=0.1,
                   help="known y diffusivity (target=init)")
    o = p.add_argument_group("optimization")
    o.add_argument("--iterations", type=int, default=300)
    o.add_argument("--lr", type=float, default=0.02)
    o.add_argument("--tol", type=float, default=None,
                   help="early-stop loss threshold (converged flag)")
    o.add_argument("--reg", type=float, default=0.0,
                   help="Tikhonov weight on the recovered field")
    o.add_argument("--adjoint", default="checkpoint",
                   choices=["checkpoint", "full"],
                   help="reverse-mode storage: checkpointed segments "
                        "(O(sqrt(T)) states) or the full trajectory")
    o.add_argument("--segment", type=int, default=None,
                   help="checkpoint segment length K (default ~sqrt(T))")
    d = p.add_argument_group("observations")
    d.add_argument("--observe-every", type=int, default=1, metavar="N",
                   help="synthetic mode: observe every N-th interior "
                        "cell of the final state")
    d.add_argument("--observations", default=None, metavar="PATH",
                   help="observed final-state values (a save_field "
                        "file); requires --obs-mask")
    d.add_argument("--obs-mask", default=None, metavar="PATH",
                   help="bool observation mask (a save_field file)")
    d.add_argument("--save-recovered", default=None, metavar="PATH",
                   help="write the recovered field with save_field "
                        "(digest sidecar; loadable with load_field)")
    p.add_argument("--run-record", default=None,
                   help="path for the JSON run record")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write telemetry JSONL (snapshot + the "
                        "kind='inverse' run record)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the CUDA card (default) or the CPU")
    add_log_level_flag(p)
    return p


def _interior_mean_abs_err(a, b) -> float:
    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(d[1:-1, 1:-1].mean())


def _forward(nx, ny, steps, u0, args, true_k=None):
    """The observed final state: the var route on ``true_k``, else the
    const route at (cx, cy)."""
    from heat2d_tpu_torch.diff.adjoint import make_diff_solve
    if true_k is not None:
        f = make_diff_solve(nx, ny, steps, coeff="var", device=args.device)
        u = f(u0, torch.as_tensor(true_k), torch.as_tensor(true_k))
    else:
        f = make_diff_solve(nx, ny, steps, device=args.device)
        u = f(u0, args.cx, args.cy)
    return u.cpu().numpy()


def run_selftest(args, registry) -> int:
    from heat2d_tpu_torch.diff.adjoint import make_diff_solve
    from heat2d_tpu_torch.diff.inverse import (observation_mask,
                                               synthetic_diffusivity,
                                               unit_reference_init)
    from heat2d_tpu_torch.diff.serving import InverseRequest
    from heat2d_tpu_torch.serve.server import SolveServer

    failures = []
    nx, ny, steps = args.nxprob, args.nyprob, args.steps
    tol = args.tol if args.tol is not None else 1e-8

    # The known target and its observations.
    true_k = synthetic_diffusivity(nx, ny)
    u0 = unit_reference_init(nx, ny)
    u_true = _forward(nx, ny, steps, u0, args, true_k)
    mask = observation_mask(nx, ny, every=args.observe_every)
    req = InverseRequest.from_fields(
        nx, ny, steps, mask, u_true, target="diffusivity",
        iterations=args.iterations, lr=args.lr, tol=tol,
        adjoint=args.adjoint, segment=args.segment)

    # 1) End to end through the serving path.
    server = SolveServer(registry=registry, max_delay=0.01,
                         device=args.device)
    with server:
        res = server.solve(req, timeout=600)
        again = server.solve(req, timeout=600)
    if not res.converged or not res.final_loss <= tol:
        failures.append(f"did not converge below tol={tol:g}: "
                        f"loss={res.final_loss:g} after "
                        f"{res.iterations} iterations")
    if not again.cache_hit:
        failures.append("repeat submission was not a cache hit")
    if again.final_loss != res.final_loss:
        failures.append("cache hit returned a different loss")
    err0 = _interior_mean_abs_err(np.full((nx, ny), 0.1), true_k)
    err = _interior_mean_abs_err(res.params, true_k)
    if not err < 0.1 * err0:
        failures.append(f"recovered field error {err:g} not < 10% of "
                        f"initial-guess error {err0:g}")

    # 2) Adjoint invariant: checkpointed == full storage, bit for bit.
    w = torch.as_tensor(np.random.RandomState(0).randn(nx, ny)
                        .astype(np.float32), device=args.device)
    uj = torch.as_tensor(u0, device=args.device)
    for name, argnum in (("u0", 0), ("cx", 1)):
        g = []
        for adjoint in ("checkpoint", "full"):
            f = make_diff_solve(nx, ny, steps, adjoint=adjoint,
                                device=args.device)
            ins = [uj.clone().requires_grad_(),
                   torch.tensor(0.1, device=args.device,
                                requires_grad=True),
                   torch.tensor(0.1, device=args.device)]
            (gi,) = torch.autograd.grad(torch.sum(w * f(*ins)),
                                        ins[argnum])
            g.append(gi.cpu().numpy())
        if g[0].tobytes() != g[1].tobytes():
            failures.append(f"checkpointed adjoint grad w.r.t. {name} "
                            f"not bitwise-identical to full storage")

    # 3) Telemetry landed.
    snap = registry.snapshot()
    if not any(k.startswith("inverse_loss") for k in snap["series"]):
        failures.append("no inverse_loss series recorded")
    if snap["counters"].get("inverse_iterations_total", 0) < 1:
        failures.append("inverse_iterations_total not recorded")

    print(f"selftest: {res.iterations} iterations -> "
          f"loss {res.final_loss:.3e} (tol {tol:g}), field error "
          f"{err:.2e} (from {err0:.2e}), cache_hit={again.cache_hit}")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    _write_outputs(args, registry, {
        "target": "diffusivity", "grid": f"{nx}x{ny}", "steps": steps,
        "iterations": res.iterations, "final_loss": res.final_loss,
        "converged": res.converged, "tol": tol,
        "field_error": err, "field_error_initial": err0,
        "cache_hit_repeat": again.cache_hit,
        "selftest_failures": failures})
    print("inverse selftest " + ("FAILED" if failures else "passed"))
    return 1 if failures else 0


def run_direct(args, registry) -> int:
    from heat2d_tpu_torch.diff.inverse import (InverseProblem,
                                               observation_mask,
                                               synthetic_diffusivity,
                                               unit_reference_init)
    from heat2d_tpu_torch.io.binary import (CheckpointCorruptError,
                                            load_field, save_field)

    nx, ny, steps = args.nxprob, args.nyprob, args.steps
    if (args.observations is None) != (args.obs_mask is None):
        print("--observations and --obs-mask go together\nQuitting...",
              file=sys.stderr)
        return 1
    true_k = None
    if args.observations is not None:
        try:
            values, _ = load_field(args.observations)
            mask, _ = load_field(args.obs_mask)
        except (CheckpointCorruptError, OSError, ValueError) as e:
            print(f"{e}\nQuitting...", file=sys.stderr)
            return 1
        mask = np.asarray(mask, bool)
        if mask.shape != (nx, ny) or values.shape != (nx, ny):
            print(f"observation files must be {nx}x{ny}, got "
                  f"{values.shape}/{mask.shape}\nQuitting...",
                  file=sys.stderr)
            return 1
    else:
        # Synthetic observations of the known bump field (or of the
        # reference init for target=init).
        u0 = unit_reference_init(nx, ny)
        if args.target == "diffusivity":
            true_k = synthetic_diffusivity(nx, ny)
        values = _forward(nx, ny, steps, u0, args, true_k)
        mask = observation_mask(nx, ny, every=args.observe_every)

    problem = InverseProblem(
        nx=nx, ny=ny, steps=steps, target=args.target,
        obs_mask=mask, obs_values=values, cx=args.cx, cy=args.cy,
        u0=(unit_reference_init(nx, ny)
            if args.target == "diffusivity" else None),
        reg=args.reg, adjoint=args.adjoint, segment=args.segment,
        device=args.device)
    sol = problem.solve(iterations=args.iterations, lr=args.lr,
                        tol=args.tol, registry=registry)

    print(f"Inverse ({args.target}) on {nx}x{ny}, {steps} steps: "
          f"{sol.iterations} iterations, final loss "
          f"{sol.final_loss:.6e}, grad norm {sol.grad_norm:.3e}"
          + (", converged" if sol.converged else ""))
    extra = {
        "target": args.target, "grid": f"{nx}x{ny}", "steps": steps,
        "iterations": sol.iterations, "final_loss": sol.final_loss,
        "converged": sol.converged, "grad_norm": sol.grad_norm,
        "n_observations": int(np.count_nonzero(mask)),
    }
    if true_k is not None:
        extra["field_error"] = _interior_mean_abs_err(sol.params, true_k)
        print(f"Recovered-field interior error vs known target: "
              f"{extra['field_error']:.3e}")
    if args.save_recovered:
        save_field(sol.params, args.save_recovered,
                   name=f"recovered_{args.target}",
                   extra={"final_loss": sol.final_loss,
                          "iterations": sol.iterations})
        print(f"Writing {args.save_recovered} ...")
    _write_outputs(args, registry, extra)
    return 0


def _write_outputs(args, registry, extra) -> None:
    from heat2d_tpu_torch.io.binary import write_json_atomic
    from heat2d_tpu_torch.obs.record import build_record, write_run_jsonl

    from heat2d_tpu_torch.tune import runtime as tune_runtime
    tuned = tune_runtime.applied_configs()
    if tuned:
        extra = {**extra, "tuned_config": tuned}
    write_run_jsonl(registry, args.metrics_out, "inverse", extra,
                    device=args.device)
    if args.run_record:
        write_json_atomic(build_record("inverse", extra=extra,
                                       device=args.device),
                          args.run_record)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure_logging(args.log_level)
    from heat2d_tpu_torch.obs import MetricsRegistry
    registry = MetricsRegistry()
    try:
        if args.selftest:
            return run_selftest(args, registry)
        return run_direct(args, registry)
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
