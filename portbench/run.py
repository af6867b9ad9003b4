"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the program
(``heat2d_tpu_torch``) beside this folder, on a machine with as many CUDA
cards as the cell asks for; without them it exits 2 and prints no
result. The last line of standard output is the result's JSON object;
standard error carries the card's name, count and power limit first and
each number the check compared, beside its limit, last. A run that
finds the JAX stack or the JAX package loaded exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))

from portbench import harness  # noqa: E402


def _power_limits() -> list:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.prepare_environment(CHECKOUT)
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}; cards visible: "
          f"{torch.cuda.device_count()}; cell uses {cell.chips}",
          file=sys.stderr)
    for row in _power_limits():
        print(f"nvidia-smi name, power.limit: {row}", file=sys.stderr)

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START,
                                  cell=cell)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
