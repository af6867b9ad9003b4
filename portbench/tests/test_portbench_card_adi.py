"""On a card: one short run of each cell added beside the first three,
through the harness, comes out correct with its metrics. Skips where no
card is present."""

import pytest

from portbench import harness

CELLS = ["adi-2560x2048", "solve-640x1024"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(name, 2**31 + 3, 2.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["metrics"]["setup_s"]["value"] > 0
    assert r["metrics"]["mcells_per_s"]["value"] > 0
