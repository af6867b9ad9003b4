"""The reader of H10's split joins that needed no replay
(``metrics/adi.split_hit_share.py``): nothing in a small ADI run on the
CPU (its halves run the plain versions, no split launch), nothing in
another cell or where the program keeps no such counters (a parent
without the split), and the share of the program's counters once a
split launch counted its segments, with the replays that
``tridiag.collect_split_replays`` reads in."""

import pytest
import torch

from heat2d_tpu_torch.obs.metrics import get_registry, reset_registry
from heat2d_tpu_torch.ops import tridiag
from portbench import harness
from portbench.tests._small_adi import run_small

NAME = "adi.split_hit_share"


def test_split_hit_share_is_empty_in_a_small_adi_run():
    reset_registry()
    r = run_small(trace=True)
    assert r["correct"], r["checks"]
    assert NAME not in r["metrics"]
    assert "adi.fused_halves_share" in r["metrics"]
    assert not get_registry().find_counters("td_split_segments_total")


def test_split_hit_share_reads_the_collected_counters(monkeypatch):
    reset_registry()
    reader = harness.metric_readers()[NAME]
    ctx = {"kind": "adi"}
    monkeypatch.setattr(tridiag, "_joins", {})
    monkeypatch.setattr(tridiag, "_replays_read", 0)
    assert reader.read(ctx) is None
    # a join buffer whose replay word counted 2, as a card's would
    words = torch.zeros(tridiag.SYNC_HEAD, dtype=torch.int64)
    words[0] = 2
    tridiag._joins[("cpu", 7)] = [words, 1]
    get_registry().counter("td_split_segments_total", 800)
    value, note = reader.read(ctx)
    assert value == pytest.approx(99.75)
    assert note == "2 replays in 800 speculative segments"
    assert reader.read(dict(ctx, kind="solve")) is None
