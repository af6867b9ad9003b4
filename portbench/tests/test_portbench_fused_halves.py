"""The reader of the ADI halves run as one launch each
(``metrics/adi.fused_halves_share.py``): the share of the program's
counters in the ADI cell (0 on the CPU, where each half runs the plain
composition), nothing in another cell, and nothing where the program
keeps no such counters (a parent without the right-hand-side builds)."""

import pytest

from heat2d_tpu_torch.obs.metrics import get_registry, reset_registry
from portbench import harness
from portbench.tests._small_adi import SMALL, run_small

NAME = "adi.fused_halves_share"


def _total(name):
    return sum(get_registry().find_counters(name).values())


def test_fused_halves_share_in_a_small_adi_run():
    reset_registry()
    r = run_small(trace=True)
    assert r["correct"], r["checks"]
    got = r["metrics"][NAME]
    assert got["unit"] == "%" and got["value"] == 0.0
    halves = _total("adi_halves_total")
    assert halves > 0 and halves % (2 * SMALL[2]) == 0
    assert _total("adi_halves_fused_total") == 0


def test_fused_halves_share_is_empty_without_the_counters():
    reset_registry()
    reader = harness.metric_readers()[NAME]
    ctx = {"kind": "adi"}
    assert reader.read(ctx) is None
    get_registry().counter("adi_halves_total", 80)
    get_registry().counter("adi_halves_fused_total", 80)
    value, note = reader.read(ctx)
    assert value == pytest.approx(100.0)
    assert note == "80 of 80 halves one launch each"
    assert reader.read(dict(ctx, kind="solve")) is None
