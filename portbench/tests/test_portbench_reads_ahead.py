"""The reader of the solver loop's reads ahead
(``metrics/solver.reads_ahead_share.py``): the share of the program's
counters in the converge cell, nothing where the convergence check is
off, and nothing where the program keeps no such counters (a parent
without the one-chunk pipeline)."""

import math

import pytest

from heat2d_tpu_torch.obs.metrics import get_registry, reset_registry
from portbench import harness
from portbench.tests._small import SMALL, run_small

NAME = "solver.reads_ahead_share"


def _total(name):
    return sum(get_registry().find_counters(name).values())


@pytest.mark.parametrize("cell", ["converge-2560x2048", "solve-2560x2048"])
def test_reads_ahead_share_in_the_converge_cell_alone(cell):
    reset_registry()
    r = run_small(cell, trace=True)
    assert r["correct"], r["checks"]
    if cell.startswith("solve"):
        assert NAME not in r["metrics"]
        return
    got = r["metrics"][NAME]
    assert got["unit"] == "%"
    reads = _total("solver_residual_reads_total")
    ahead = _total("solver_reads_ahead_total")
    assert math.isclose(got["value"], 100.0 * ahead / reads)
    # the small solves (40 steps, a residual every 20) never converge:
    # two reads a solve, the first of them ahead, and nothing dropped
    assert SMALL[2] // 20 == 2
    assert reads % 2 == 0 and got["value"] == 50.0
    assert _total("solver_chunks_discarded_total") == 0


def test_reads_ahead_share_is_empty_without_the_counters():
    reset_registry()
    reader = harness.metric_readers()[NAME]
    ctx = {"kind": "solve", "convergence": True, "residual_reads": [500]}
    assert reader.read(ctx) is None
    get_registry().counter("solver_residual_reads_total", 500)
    get_registry().counter("solver_reads_ahead_total", 499)
    get_registry().counter("solver_chunks_discarded_total", 0)
    value, note = reader.read(ctx)
    assert value == pytest.approx(99.8)
    assert "0 speculative" in note
    assert reader.read(dict(ctx, convergence=False)) is None
    assert reader.read(dict(ctx, kind="serve")) is None
