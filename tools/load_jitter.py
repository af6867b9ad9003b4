#!/usr/bin/env python3
"""Where the in-process server's capacity past its knee moves on one card.

    python3 tools/load_jitter.py [--reps 3]

Builds the kernels, starts one ``ServeTarget(device="cuda")``, warms it
on ``chip_smoke.py``'s 640x1024 mix (``card_h5``, H5), then offers the
load phase's sweep points (base 400 and 800 req/s, 2 s) ``--reps`` times
under each variant, one after another so that a drift of the host shows
in every variant alike:

- ``default``: as the load phase runs them;
- ``gc_frozen``: after ``gc.collect(); gc.freeze()`` (no collection
  walks the heap built before the point);
- ``switch_0.5ms``: ``sys.setswitchinterval(0.0005)`` (the interpreter
  hands its lock over ten times as often);
- ``torch_threads_1``: ``torch.set_num_threads(1)``;
- ``dur_4s``: the 800 point over a 4 s schedule.

Per point: offered and achieved req/s, shed rate, submit skew p99 and
max, the garbage collector's passes and pause seconds by generation, the
process's CPU seconds, and the launch rows' setup, run and readback ms
(mean, p50, p90, p99). Prints a line a point and the card's name and
power limit (as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them); the points go to
``chiprun_out/load_jitter.json``. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _q(values, p):
    v = sorted(values)
    return round(v[min(len(v) - 1, int(p * len(v)))] * 1e3, 3)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="load_jitter.py")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("load_jitter.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from heat2d_tpu_torch.io.binary import write_json_atomic
    from heat2d_tpu_torch.load.runner import ServeTarget, warm_target
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry

    pauses, started = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           time.perf_counter() - started[0]))

    cs.phase_toolchain(torch)
    cs.phase_build()
    h5, _ = cs.load_mixes()
    target = ServeTarget(registry=MetricsRegistry(), device="cuda")
    log = target.server.engine.launch_log
    points = []

    def point(variant, rate, duration):
        del pauses[:]
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        r = cs._load_point(target, h5, rate, duration, log)
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        rows = log[len(log) - r["launch_rows"]["n"]:]
        row = {"variant": variant, "rate": rate, "duration_s": duration,
               "offered_rps": r["offered_rps"],
               "achieved_rps": r["achieved_rps"],
               "shed_rate": r["shed_rate"],
               "skew_p99_s": r["fidelity"]["p99_skew_s"],
               "skew_max_s": r["fidelity"]["max_skew_s"],
               "gc": {str(g): {"passes": sum(1 for k, _ in pauses if k == g),
                               "pause_s": round(sum(s for k, s in pauses
                                                    if k == g), 6)}
                      for g in (0, 1, 2)},
               "cpu_user_s": round(ru1.ru_utime - ru0.ru_utime, 3),
               "cpu_sys_s": round(ru1.ru_stime - ru0.ru_stime, 3),
               "launches": len(rows)}
        for key in ("setup_s", "run_s", "readback_s"):
            v = [x[key] for x in rows]
            row[key.replace("_s", "_ms")] = {
                "mean": round(sum(v) / len(v) * 1e3, 3) if v else None,
                "p50": _q(v, 0.5) if v else None,
                "p90": _q(v, 0.9) if v else None,
                "p99": _q(v, 0.99) if v else None}
        points.append(row)
        print(json.dumps(row), flush=True)

    gc.callbacks.append(on_gc)
    try:
        warm_target(target, cs._h5_warm_schedule(h5))
        threads = torch.get_num_threads()
        for _ in range(args.reps):
            for variant in ("default", "gc_frozen", "switch_0.5ms",
                            "torch_threads_1", "dur_4s"):
                if variant == "gc_frozen":
                    gc.collect()
                    gc.freeze()
                elif variant == "switch_0.5ms":
                    sys.setswitchinterval(0.0005)
                elif variant == "torch_threads_1":
                    torch.set_num_threads(1)
                try:
                    if variant == "dur_4s":
                        point(variant, 800.0, 4.0)
                    else:
                        point(variant, 800.0, 2.0)
                        point(variant, 400.0, 2.0)
                finally:
                    gc.unfreeze()
                    sys.setswitchinterval(0.005)
                    torch.set_num_threads(threads)
    finally:
        gc.callbacks.remove(on_gc)
        target.close()
        write_json_atomic({"points": points},
                          cs._out_path("load_jitter.json"))
    print(cs.smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
