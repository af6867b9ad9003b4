"""What the tools that time a checkout of the port on one card share
(``time_resident.py``, ``time_adi.py``): the checkout's import, the
card's name and power limit, and a timer by CUDA events."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def load(root: str, module: str, tool: str):
    """(torch, ``heat2d_tpu_torch.<module>``) imported from the checkout
    at ``root``, whose kernels build there at first use; None, after a
    line on stderr naming ``tool``, without a card or where the module
    came from elsewhere."""
    import importlib
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device", file=sys.stderr)
        return None
    mod = importlib.import_module(f"heat2d_tpu_torch.{module}")
    if not Path(mod.__file__).resolve().is_relative_to(root):
        print(f"{tool}: imported {mod.__file__}, not from {root}",
              file=sys.stderr)
        return None
    return torch, mod


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, reps: int) -> float:
    """One warm call of ``fn``, then the mean of ``reps`` back-to-back
    calls by CUDA events, in ms."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
