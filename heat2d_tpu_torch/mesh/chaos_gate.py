"""The mesh fault-tolerance gate: every device-level recovery path
measured. The port of ``heat2d_tpu/mesh/chaos_gate.py``.

Three scenarios, each injected by the chaos harness on a live mesh of
slots and each required to recover by itself to a bitwise-correct answer
(the single-device engine is the oracle):

- **device loss**: ``device_fail_at`` kills slot 3 at the second launch;
  the engine quarantines it, re-forms the batch mesh over the survivors,
  re-pads and relaunches the same batch;
- **silent bit flip**: ``flip_bit`` corrupts one exponent bit of the host
  result; the ABFT tier flags the launch, quarantines the owner slot and
  recomputes;
- **hung collective**: ``hang_collective`` wedges a warm launch; the
  stall watchdog fires within its deadline (detection must beat the
  hang), the probes convict the culprit, and the batch requeues on the
  survivors; the abandoned launch's late result is discarded and
  counted, never served.

Each scenario runs through a real ``SolveServer`` (admission, cache,
single-flight, micro-batch, the guarded mesh engine). The
``kind="mesh_chaos"`` record carries per-scenario detection and recovery
seconds, parity verdicts, quarantine sets, and the
``no_quarantined_serving`` invariant over every served launch.

    python -m heat2d_tpu_torch.mesh.chaos_gate --device cpu \\
        --host-device-count 8
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

NX, NY, STEPS = 24, 28, 8


def _requests(n: int, base: float):
    from heat2d_tpu_torch.serve.schema import SolveRequest

    return [SolveRequest(cx=base + 0.01 * i, cy=0.11, nx=NX, ny=NY,
                         steps=STEPS, method="jnp") for i in range(n)]


def _oracle_bytes(requests, device) -> list:
    """The single-device engine's answers (the bitwise oracle)."""
    import numpy as np

    from heat2d_tpu_torch.serve.engine import EnsembleEngine

    eng = EnsembleEngine(max_batch=len(requests), device=device)
    return [np.asarray(u).tobytes()
            for u, _ in eng.solve_batch(requests)]


def _run_scenario(name: str, chaos_cfg, policy, batch_base: float,
                  devices, hang_s: Optional[float] = None) -> dict:
    """One injected scenario through a live SolveServer; returns its
    record row and never leaves a campaign installed."""
    import numpy as np

    from heat2d_tpu_torch.mesh.engine import MeshEnsembleEngine
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.resil import chaos
    from heat2d_tpu_torch.serve.server import SolveServer

    registry = MetricsRegistry()
    chaos.install(chaos_cfg, registry)
    try:
        engine = MeshEnsembleEngine(registry=registry, fault=policy,
                                    devices=devices)
        server = SolveServer(registry=registry, engine=engine,
                             max_batch=engine.max_batch,
                             default_timeout=120.0)
        with server:
            # Warm the signature (mesh launch attempt 1): every campaign
            # here arms its fault at attempt 2, a warm launch.
            warm = _requests(engine.n_devices, 0.05)
            for f in [server.submit(r) for r in warm]:
                f.result(120)
            victims = _requests(engine.n_devices, batch_base)
            t0 = time.monotonic()
            futures = [server.submit(r) for r in victims]
            answers = [f.result(120) for f in futures]
            recovered_s = time.monotonic() - t0
        oracle = _oracle_bytes(victims, engine.devices[0])
        got = [np.asarray(res.u).tobytes() for res in answers]
        bitwise = got == oracle
        if hang_s is not None:
            # let the abandoned hung launch finish, so that its discard
            # shows in the counters
            time.sleep(hang_s + 0.5)
        snap = engine.fault_snapshot()
        counters = {
            k: v for k, v in registry.snapshot()["counters"].items()
            if k.startswith(("mesh_", "resil_chaos"))}
        recoveries = snap["recoveries"]
        row = {
            "scenario": name,
            "bitwise": bitwise,
            "recovered": bool(recoveries),
            "recovery_s": (recoveries[0]["recovery_s"]
                           if recoveries else None),
            "e2e_recovered_s": recovered_s,
            "requeues": (recoveries[0]["requeues"]
                         if recoveries else 0),
            "quarantined": snap["health"]["quarantined"],
            "invariant": snap["invariant"],
            "counters": counters,
        }
        if hang_s is not None:
            # detection must beat the hang, or it only waited it out
            row["detected_within_deadline"] = recovered_s < hang_s
        return row
    finally:
        chaos.uninstall()


def run_gate(devices=None) -> dict:
    """All three scenarios over the slots ``devices`` (default: the
    visible cards; at least 4); returns the ``kind="mesh_chaos"``
    payload."""
    from heat2d_tpu_torch.mesh.degrade import FaultPolicy
    from heat2d_tpu_torch.mesh.runner import attached_devices
    from heat2d_tpu_torch.resil.chaos import ChaosConfig

    devices = attached_devices(None, devices)
    # generous against the 0.4 s stall deadline: detection must beat the
    # hang with margin on a loaded host
    hang_s = 3.0
    scenarios = [
        _run_scenario(
            "device_loss",
            ChaosConfig(device_fail_at=2, device_fail_index=3),
            FaultPolicy(stall_deadline_s=30.0), 0.16, devices),
        _run_scenario(
            "bit_flip",
            ChaosConfig(flip_bit=2),
            FaultPolicy(abft=True), 0.2, devices),
        _run_scenario(
            "hung_collective",
            ChaosConfig(hang_collective=2, hang_collective_s=hang_s,
                        device_fail_index=1),
            FaultPolicy(stall_deadline_s=0.4, max_requeues=3), 0.24,
            devices, hang_s=hang_s),
    ]
    passed = all(
        s["bitwise"] and s["recovered"] and s["invariant"]["ok"]
        and s["recovery_s"] is not None and s["recovery_s"] > 0.0
        and s.get("detected_within_deadline", True)
        and s["quarantined"]
        for s in scenarios)
    return {"scenarios": scenarios, "passed": passed}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="heat2d_tpu_torch.mesh.chaos_gate",
        description="mesh fault-tolerance gate: device loss, silent "
                    "bit flip, hung collective — measured recovery "
                    "with bitwise parity")
    p.add_argument("--out", default=None,
                   help="write the kind='mesh_chaos' run record here")
    p.add_argument("--host-device-count", type=int, default=None,
                   metavar="N",
                   help="N slots on --device (parallel.mesh.host_devices;"
                        " default: the visible cards)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from heat2d_tpu_torch.parallel.mesh import host_devices, visible_devices
    from heat2d_tpu_torch.utils.device import DeviceUnavailableError

    try:
        devices = (host_devices(args.host_device_count, args.device)
                   if args.host_device_count
                   else visible_devices(args.device))
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    if len(devices) < 4:
        print(f"the mesh chaos gate needs at least 4 slots, have "
              f"{len(devices)} (pass --host-device-count 4)")
        return 2

    payload = run_gate(devices)
    from heat2d_tpu_torch.obs.record import build_record

    rec = build_record("mesh_chaos", extra=payload, device=args.device)
    if args.out:
        from heat2d_tpu_torch.io.binary import write_json_atomic
        write_json_atomic(rec, args.out, sort_keys=True)
    for s in payload["scenarios"]:
        print(f"  {s['scenario']:16s} bitwise={s['bitwise']} "
              f"recovery={s['recovery_s'] and round(s['recovery_s'], 3)}s "
              f"requeues={s['requeues']} "
              f"quarantined={s['quarantined']} "
              f"invariant={'ok' if s['invariant']['ok'] else 'VIOLATED'}")
    if payload["passed"]:
        print("mesh-chaos-gate passed: every device fault recovered "
              "automatically, measured, bitwise-correct")
        return 0
    print("mesh-chaos-gate FAILED")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
