"""The benchmark's tests: run from the repository's root,

    python -m pytest portbench/tests -q

on the CPU; the tests marked ``cuda`` decide inside the test whether a
card is there, and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
