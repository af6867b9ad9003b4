"""The cost of one entry of the port's hot-path hook,
``utils.profiling.phase``, on this host: off (no profiler records and
tracing is not armed), under a recording ``torch.profiler`` (CPU and,
with a card, CUDA activity; every thread's host events, as the
benchmark's traced slice records them), and with tracing armed (a span
to an in-memory sink, under an ambient context).

Each figure is the mean of ``--n`` entries of an empty ``with
phase(...)`` block in a tight loop, in microseconds, the best of
``--repeats``; the loop with nothing in it is given beside them. The
card's name and power limit come first, as every measurement of the
port names them. One JSON line on standard output.

    python3 tools/hook_cost_torch.py --n 200000
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _per_entry_us(body, n: int, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        body(n)
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from heat2d_tpu_torch.obs import tracing
    from heat2d_tpu_torch.utils.profiling import phase

    card = None
    if torch.cuda.is_available():
        card = torch.cuda.get_device_name(0)
        exe = shutil.which("nvidia-smi")
        if exe:
            card = subprocess.run(
                [exe, "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True, timeout=30).stdout.strip()

    def empty(n):
        for _ in range(n):
            pass

    def hooked(n):
        for _ in range(n):
            with phase("solver.residual_read"):
                pass

    out = {"card": card, "torch": torch.__version__, "n": args.n,
           "loop_us": _per_entry_us(empty, args.n, args.repeats),
           "off_us": _per_entry_us(hooked, args.n, args.repeats)}
    acts = [ProfilerActivity.CPU]
    if card is not None:
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        cfg = None
    # a tenth of the entries: the profiler keeps every range it records
    n_on = max(1, args.n // 10)
    with profile(activities=acts, experimental_config=cfg):
        out["profiled_us"] = _per_entry_us(hooked, n_on, args.repeats)
    tracing.install(tracing.Tracer(sink=lambda rec: None, service="cost"))
    root = tracing.begin("cost.root", kind="request")
    tracing.set_ambient(root.ctx)
    out["armed_us"] = _per_entry_us(hooked, n_on, args.repeats)
    tracing.set_ambient(None)
    tracing.uninstall()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
