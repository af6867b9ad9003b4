"""``bench_serve``: serve-side strong scaling over the device slots, in
``parallel/scaling.py``'s ``kind="multichip"`` records. The port of
``heat2d_tpu/mesh/bench.py``.

Two numbers per run, both in the record:

- **Bitwise parity** (the correctness anchor): the mesh engine's results
  against the single-device engine's at every occupancy rung, byte for
  byte.
- **Throughput scaling**: on cards (``rate_source="wall"``) the wall-clock
  request rate of full-capacity launches on one slot and on n; on CPU
  slots, which share one host, the modeled surface
  (``rate_source="modeled"``): each slot advances its members in
  parallel, charged a per-launch dispatch overhead plus a collective tax
  on multi-slot meshes, the model's constants stated in the payload.
  Slots that share one card (``host_devices``) run one after another, so
  their wall rate measures what the split costs on that card, not
  scaling.

    serve_scaling_efficiency = rate_n / (n * rate_1)

``main`` (``heat2d-tpu-torch-mesh``) writes the record and exits nonzero
when parity breaks, the efficiency misses ``--min-efficiency``, or a
spatial signature fails to stamp its halo plan ``compiled: True``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

#: the modeled-surface constants (stated in every payload)
SERVE_SCALING_MODEL = "heat2d-tpu/serve-scaling-model/v1"
MODEL_LAUNCH_OVERHEAD_S = 1e-3
MODEL_COLLECTIVE_TAX_S = 2e-4
MODEL_PER_CHIP_MCELLS_PER_S = 1000.0


def modeled_launch_s(member_cells: float, capacity: int,
                     n_devices: int,
                     per_chip_cells_per_s: float) -> float:
    """Modeled wall time of one full-capacity launch: per-chip local
    members advance in parallel; multi-chip meshes pay a collective
    tax (dispatch + the batch axis's gather)."""
    local = -(-capacity // n_devices)
    t = MODEL_LAUNCH_OVERHEAD_S + local * member_cells \
        / per_chip_cells_per_s
    if n_devices > 1:
        t += MODEL_COLLECTIVE_TAX_S
    return t


def _reqs(nx, ny, steps, n, method="jnp", base=0.05):
    from heat2d_tpu_torch.serve.schema import SolveRequest

    return [SolveRequest(nx=nx, ny=ny, steps=steps, method=method,
                         cx=base + 0.01 * i, cy=0.1) for i in range(n)]


def _parity_rungs(mesh_engine, single_engine, nx, ny, steps,
                  method, rungs) -> list:
    """Serve every occupancy rung through BOTH engines; byte-compare
    each member. Returns the per-rung report (all must be True)."""
    import numpy as np

    out = []
    for n in rungs:
        reqs = _reqs(nx, ny, steps, n, method=method,
                     base=0.05 + 0.001 * n)
        got = mesh_engine.solve_batch(reqs)
        want = single_engine.solve_batch(reqs)
        ok = all(
            np.asarray(g[0]).tobytes() == np.asarray(w[0]).tobytes()
            and g[1] == w[1]
            for g, w in zip(got, want))
        out.append({"occupancy": n, "bitwise": bool(ok)})
    return out


def _wall_rate(engine, nx, ny, steps, method, capacity,
               launches: int = 3) -> float:
    """Measured requests/s of warm full-capacity launches."""
    reqs = _reqs(nx, ny, steps, capacity, method=method, base=0.3)
    engine.solve_batch(reqs)                   # warm (compile)
    t0 = time.monotonic()
    for i in range(launches):
        engine.solve_batch(_reqs(nx, ny, steps, capacity,
                                 method=method, base=0.4 + 0.01 * i))
    dt = max(time.monotonic() - t0, 1e-9)
    return launches * capacity / dt


def measure_serve_scaling(n_devices: Optional[int] = None,
                          nx: int = 48, ny: int = 64, steps: int = 8,
                          method: str = "jnp",
                          per_chip_mcells_per_s: Optional[float] = None,
                          wall: bool = True, devices=None) -> dict:
    """One serve strong-scaling measurement over ``n_devices`` slots of
    ``devices`` (default: the visible cards). Returns the
    ``kind="multichip"`` payload row."""
    from heat2d_tpu_torch.mesh.engine import MeshEnsembleEngine
    from heat2d_tpu_torch.mesh.runner import attached_devices
    from heat2d_tpu_torch.mesh.scheduler import tuned_rate_mcells
    from heat2d_tpu_torch.serve.engine import EnsembleEngine

    slots = attached_devices(n_devices, devices)
    nd = len(slots)
    single = EnsembleEngine(max_batch=8, device=slots[0])
    meshed = MeshEnsembleEngine(devices=slots)
    rungs = sorted({1, 2, 3, 5, 8})
    parity = _parity_rungs(meshed, single, nx, ny, steps, method,
                           rungs)
    cap_1, cap_n = 8, meshed.max_batch
    on_card = slots[0].type == "cuda"
    rate = (per_chip_mcells_per_s
            or tuned_rate_mcells(nx, ny, device=slots[0])
            or MODEL_PER_CHIP_MCELLS_PER_S)
    cells = float(nx) * ny * steps
    m1 = cap_1 / modeled_launch_s(cells, cap_1, 1, rate * 1e6)
    mn = cap_n / modeled_launch_s(cells, cap_n, nd, rate * 1e6)
    payload = {
        "bench": "serve",
        "n_devices": nd,
        "grid": [nx, ny], "steps": steps, "method": method,
        "max_batch_1chip": cap_1, "max_batch_nchip": cap_n,
        "parity": all(r["bitwise"] for r in parity),
        "parity_rungs": parity,
        "rate_source": "wall" if on_card else "modeled",
        "model": {
            "name": SERVE_SCALING_MODEL,
            "per_chip_mcells_per_s": rate,
            "launch_overhead_s": MODEL_LAUNCH_OVERHEAD_S,
            "collective_tax_s": MODEL_COLLECTIVE_TAX_S,
        },
        "modeled_rps_1chip": m1,
        "modeled_rps_nchip": mn,
        "modeled_scaling_efficiency": mn / (nd * m1),
    }
    if wall:
        w1 = _wall_rate(single, nx, ny, steps, method, cap_1)
        wn = _wall_rate(meshed, nx, ny, steps, method, cap_n)
        payload.update(wall_rps_1chip=w1, wall_rps_nchip=wn,
                       wall_scaling_efficiency=wn / (nd * w1))
    eff_key = ("wall_scaling_efficiency" if on_card and wall
               else "modeled_scaling_efficiency")
    payload["serve_scaling_efficiency"] = payload[eff_key]
    return payload


def measure_spatial_serve(n_devices: Optional[int] = None,
                          nx: int = 48, ny: int = 64,
                          steps: int = 8, devices=None) -> dict:
    """Serve one spatial-routed signature through the mesh engine (the
    split forced by a 1-byte threshold, so that the leg runs on small
    grids) and check that the halo plan is stamped ``compiled: True``
    with the mesh shape and that the results equal the single-device
    engine's bit for bit."""
    import numpy as np

    from heat2d_tpu_torch.mesh.engine import MeshEnsembleEngine
    from heat2d_tpu_torch.mesh.runner import attached_devices
    from heat2d_tpu_torch.mesh.scheduler import MeshScheduler
    from heat2d_tpu_torch.serve.engine import EnsembleEngine

    slots = attached_devices(n_devices, devices)
    nd = len(slots)
    if nd < 2:
        return {"bench": "serve_spatial", "skipped": "one_device"}
    sched = MeshScheduler(spatial_bytes_threshold=1, devices=slots)
    meshed = MeshEnsembleEngine(scheduler=sched, devices=slots)
    single = EnsembleEngine(max_batch=8, device=slots[0])
    reqs = _reqs(nx, ny, steps, 3, base=0.07)
    got = meshed.solve_batch(reqs)
    want = single.solve_batch(reqs)
    parity = all(
        np.asarray(g[0]).tobytes() == np.asarray(w[0]).tobytes()
        for g, w in zip(got, want))
    sig = reqs[0].signature()
    plan = meshed.halo_plans.get(sig) or {}
    decision = meshed.scheduler.decide(reqs[0])
    return {
        "bench": "serve_spatial",
        "n_devices": nd, "grid": [nx, ny], "steps": steps,
        "route": decision["route"],
        "parity": bool(parity),
        "halo_plan": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in plan.items()},
        "compiled": bool(plan.get("compiled")),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-mesh",
        description="bench_serve: mesh-serving strong scaling + "
                    "bitwise parity gate")
    p.add_argument("--devices", type=int, default=None,
                   help="slots to serve on (default: every visible card, "
                        "or --host-device-count)")
    p.add_argument("--host-device-count", type=int, default=None,
                   metavar="N",
                   help="N slots on --device, sharing its cards in turn "
                        "(parallel.mesh.host_devices)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="serve on the CUDA cards (default) or the CPU")
    p.add_argument("--nx", type=int, default=48)
    p.add_argument("--ny", type=int, default=64)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--method", default="jnp")
    p.add_argument("--min-efficiency", type=float, default=0.75,
                   help="gate: serve_scaling_efficiency floor")
    p.add_argument("--no-spatial", action="store_true",
                   help="skip the spatial-route leg")
    p.add_argument("--no-wall", action="store_true",
                   help="skip wall-clock rates (parity + model only)")
    p.add_argument("--out", default=None, metavar="JSON",
                   help="write the kind='multichip' run record here")
    args = p.parse_args(argv)

    from heat2d_tpu_torch.parallel.mesh import host_devices, visible_devices
    from heat2d_tpu_torch.parallel.scaling import scaling_record
    from heat2d_tpu_torch.utils.device import DeviceUnavailableError

    try:
        slots = (host_devices(args.host_device_count, args.device)
                 if args.host_device_count
                 else visible_devices(args.device))
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    failures = []
    payloads = [measure_serve_scaling(
        n_devices=args.devices, nx=args.nx, ny=args.ny,
        steps=args.steps, method=args.method, wall=not args.no_wall,
        devices=slots)]
    row = payloads[0]
    print(f"bench_serve: {row['n_devices']} devices, parity="
          f"{row['parity']}, {row['rate_source']} efficiency "
          f"{row['serve_scaling_efficiency']:.3f} "
          f"({row['serve_scaling_efficiency'] * row['n_devices']:.1f}x"
          f" at {row['n_devices']} slots)")
    if not row["parity"]:
        failures.append(f"mesh-vs-single-chip parity broke: "
                        f"{row['parity_rungs']}")
    if row["serve_scaling_efficiency"] < args.min_efficiency:
        failures.append(
            f"serve scaling efficiency "
            f"{row['serve_scaling_efficiency']:.3f} < "
            f"--min-efficiency {args.min_efficiency}")
    if not args.no_spatial:
        sp = measure_spatial_serve(n_devices=args.devices,
                                   nx=args.nx, ny=args.ny,
                                   steps=args.steps, devices=slots)
        payloads.append(sp)
        if sp.get("skipped"):
            print(f"bench_serve spatial: SKIP ({sp['skipped']})")
        else:
            print(f"bench_serve spatial: route={sp['route']} "
                  f"compiled={sp['compiled']} parity={sp['parity']}")
            if not sp["parity"]:
                failures.append("spatial route parity broke")
            if sp["route"] != "spatial" or not sp["compiled"]:
                failures.append(
                    "spatial signature did not compile a mesh "
                    f"program: {sp}")
    scaling_record(payloads, args.out, device=args.device)
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    print("bench_serve " + ("FAILED" if failures else "passed"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
