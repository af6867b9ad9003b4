"""The readers of the program's span counters: a traced run on the CPU
gives each a finite value in the cells its ``BENCHMARK.json`` entry
lists and nothing in the others; an untraced run leaves the counters
empty."""

import json
import math
from pathlib import Path

import pytest

from heat2d_tpu_torch.obs.metrics import get_registry, reset_registry
from portbench.tests._small import run_small

ROOT = Path(__file__).resolve().parents[2]
NEW = ("solver.host_ms_per_solve", "solver.host_us_per_check",
       "serve.host_ms_per_launch", "serve.batch_delay_ms_per_launch")
CELLS = ("solve-2560x2048", "converge-2560x2048", "serve-640x1024")


def _listed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"]: set(m["workloads"]) for m in bench["per_layer"]
            if m["name"] in NEW}


@pytest.mark.parametrize("name", CELLS)
def test_span_metrics_read_in_their_cells_alone(name):
    reset_registry()
    extra = {"rate": 200.0} if name.startswith("serve") else {}
    r = run_small(name, trace=True, **extra)
    assert r["correct"], r["checks"]
    listed = _listed()
    assert set(listed) == set(NEW)
    for metric in NEW:
        if name in listed[metric]:
            got = r["metrics"][metric]
            assert math.isfinite(got["value"]) and got["value"] >= 0
        else:
            assert metric not in r["metrics"]


def test_untraced_run_counts_no_span():
    reset_registry()
    r = run_small("converge-2560x2048")
    assert r["correct"], r["checks"]
    assert not get_registry().find_counters("trace_spans_total")
