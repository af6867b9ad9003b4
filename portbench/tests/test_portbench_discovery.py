"""A configuration, a cell and a per-layer metric are taken by adding
files alone; every entry of ``BENCHMARK.json`` has its files."""

import json
import shutil
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _tree(tmp: Path) -> Path:
    root = tmp / "bench"
    for d in ("drivers", "metrics", "configs", "traffic", "workloads"):
        shutil.copytree(HERE / d, root / d)
    return root


def test_new_config_cell_and_metric_from_files_alone(tmp_path):
    root = _tree(tmp_path)
    (root / "configs" / "tiny-20x30.json").write_text(json.dumps(dict(
        json.loads((HERE / "configs" / "report-2560x2048.json").read_text()),
        nxprob=20, nyprob=30, steps=60)))
    (root / "traffic" / "closed-two.json").write_text(json.dumps({
        "driver": "closed_loop", "convergence": True,
        "cx_range": [0.1, 0.15], "warm_solves": 1}))
    (root / "workloads" / "tiny.converge.json").write_text(json.dumps({
        "config": "tiny-20x30", "traffic": "closed-two", "chips": 1,
        "why": "a test's cell", "limits": {"grid_gap": 1e-4,
                                           "steps_gap": 0},
        "check": {"samples": 2, "block": 2}, "trace": {"solves": 2}}))
    (root / "metrics" / "solver.solves_in_window.py").write_text(
        'UNIT = "count"\n\n\ndef read(ctx):\n'
        '    reads = ctx.get("residual_reads")\n'
        '    return None if reads is None else float(len(reads))\n')

    cell = harness.load_cell("tiny.converge", root)
    assert cell.config["nxprob"] == 20
    assert cell.traffic["driver"] == "closed_loop"
    assert "solver.solves_in_window" in harness.metric_readers(root)

    r = harness.run_cell("tiny.converge", 5, 0.5, True, device="cpu",
                         root=root)
    assert r["correct"], r["checks"]
    got = r["metrics"]["solver.solves_in_window"]
    assert got["unit"] == "count" and got["value"] >= 1
    assert r["metrics"]["solver.residual_reads_per_solve"]["value"] == 3
    # a metric with nothing to read in this cell is left out
    assert "serve.members_per_launch" not in r["metrics"]


def test_benchmark_json_names_only_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    readers = harness.metric_readers()
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (cell.config_name, cell.traffic_name, cell.chips, cell.why) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in configs
    for m in bench["per_layer"]:
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].UNIT == m["unit"]
    # every reader has its entry
    assert {m["name"] for m in bench["per_layer"]} == set(readers)
