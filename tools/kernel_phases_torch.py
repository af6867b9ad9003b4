#!/usr/bin/env python3
"""Run only the kernel phases of ``chip_smoke.py`` on one card: every hand
kernel against its plain version (``phase_kernels``,
``phase_ensemble_kernels``, ``phase_family_kernels``,
``phase_tridiag_kernels``, ``phase_shard_kernels``), then the entry
points that are not launches (the card's caps, the builds' attributes and
tile info) and the launch counts they left.

    python3 tools/kernel_phases_torch.py [--out FILE]

Prints one line a phase (its name, whether it passed, its seconds) and
``ALL_OK`` last; with ``--out``, writes every phase's result or traceback
there as JSON. Exits 0 when every phase passed, 1 when one failed, 2
without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("phase_kernels", "phase_ensemble_kernels", "phase_family_kernels",
          "phase_tridiag_kernels", "phase_shard_kernels")


def queries() -> dict:
    from heat2d_tpu_torch.ops import _build
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    return {"caps": _build.device_caps("cuda")._asdict(),
            "stencil": {n: cs.func_attrs(n) for n in cs.FUNC_BUILDS},
            "tile_info": cs.tile_info(cs.tile_plan(2560, 2048, 8, "cuda")),
            "ensemble": {n: ce.func_attrs(n) for n in ce.FUNC_BUILDS},
            "fam_tile_info": cf.tile_info(
                "heat9", cf.tile_plan(4096, 4096, "heat9", "cuda", 4)),
            "launch_counts": _build.launch_counts()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("kernel_phases_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    out = {}
    steps = [(name, lambda name=name: getattr(chip_smoke, name)(torch))
             for name in PHASES] + [("queries", queries)]
    for name, run in steps:
        t0 = time.perf_counter()
        try:
            out[name] = {"ok": True, "result": run()}
        except Exception:   # noqa: BLE001 — report it and go on
            out[name] = {"ok": False, "error": traceback.format_exc()}
        out[name]["s"] = time.perf_counter() - t0
        print(name, out[name]["ok"], round(out[name]["s"], 1), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, default=str, indent=1))
    ok = all(v["ok"] for v in out.values())
    print("ALL_OK", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
