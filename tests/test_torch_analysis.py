"""The port's analysis tooling (``heat2d_tpu_torch/analysis``) on the CPU,
beside ``heat2d_tpu/analysis``: the linter's six rules on seeded trees,
its baseline and CLI, the real tree linting clean; the lock auditor
(inversions, guarded writes, conditions); the kernel-build sentinel and
the capacity ladder; the three "free when off" launch pins; the implicit
gate.
"""

import json
import math
import os
import threading
import textwrap

import pytest
import torch

from heat2d_tpu.analysis import locks as jlocks
from heat2d_tpu.analysis import recompile as jrecompile
from heat2d_tpu_torch.analysis import launch_pin, lint, locks, recompile
from heat2d_tpu_torch.analysis.cli import main as lint_main
from heat2d_tpu_torch.config import HeatConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_audit():
    """Each test starts and ends without the port's auditor (the
    HEAT2D_LOCK_AUDIT run installs its own per test elsewhere)."""
    locks.uninstall()
    yield
    locks.uninstall()


def _tree(root, files: dict):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


# ------------------------------------------------------------------ #
# the six rules, each made to fire on a seeded tree
# ------------------------------------------------------------------ #

RULE_TREES = {
    "R001": ({"pkg/io.py": '''
        import os

        def bad(path, data):
            with open(path, "w") as f:
                f.write(data)

        def staged(path, data):
            with open(path + ".tmp", "w") as f:
                f.write(data)

        def idiom(path, data):
            with open(path + "x", "wb") as f:
                f.write(data)
            os.replace(path + "x", path)
        '''}, ["bad"]),
    "R002": ({"pkg/mod.py": '''
        import time

        import torch

        def step(u):
            return u * time.time()

        compiled = torch.compile(step)

        def body(u):
            return u + time.perf_counter()

        def capture(g, u):
            with torch.cuda.graph(g):
                body(u)

        def host(u):
            return time.time()
        '''}, ["step", "body"]),
    "R003": ({"pkg/mod.py": '''
        from torch.fx import symbolic_trace

        def leak(u):
            if float(u.sum()) > 0:
                return u
            return u * u.mean().item()

        traced = symbolic_trace(leak)

        def host(u):
            return float(u.sum())
        '''}, ["leak", "leak"]),
    "R004": ({"pkg/resil/chaos.py": '''
        import os
        import torch

        def hook():
            return torch.zeros(1)
        ''',
              "pkg/resil/other.py": "import torch\n"},
             ["<module>", "hook"]),
    "R005": ({"pkg/serve/mod.py": '''
        def f(registry):
            registry.counter("serve_documented_total")
            registry.gauge("serve_missing_gauge", 1)
        ''',
              "README.md": '''
        # x

        ## Port metric families

        | families |
        |---|
        | `serve_documented_total`, `serve_stale_total` |

        ## Other

        `serve_not_in_the_table_total`
        '''}, ["metrics", "metrics"]),
    "R006": ({"pkg/serve/mod.py": '''
        import threading

        LOCK = threading.Lock()
        ''',
              "pkg/obs/mod.py": '''
        import threading

        LOCK = threading.Lock()
        '''}, ["<module>"]),
}


@pytest.mark.parametrize("rule", sorted(RULE_TREES))
def test_rule_fires_on_its_seeded_tree(tmp_path, rule):
    files, contexts = RULE_TREES[rule]
    fs = lint.lint_tree(_tree(tmp_path, files), rules=[rule])
    assert [f.rule for f in fs] == [rule] * len(contexts), \
        [f.render() for f in fs]
    assert sorted(f.context for f in fs) == sorted(contexts)
    if rule == "R005":
        assert {f.match for f in fs} == {"serve_missing_gauge",
                                         "serve_stale_total"}
    for f in fs:
        assert f.key.startswith(f"{rule}:") and str(f.line) not in f.key


def test_r005_name_keyword_names_a_metric_only_in_a_metric_call(tmp_path):
    """``name=`` is a metric slot in a registry call, not in any call:
    a traffic profile named like a metric family is no finding."""
    root = _tree(tmp_path, {"pkg/load/synth.py": '''
        def f(registry, MixProfile):
            MixProfile(name="inverse_heavy")
            registry.timer(name="serve_undocumented_s")
        ''', "README.md": '''
        ## Port metric families

        | families |
        |---|
        | `serve_documented_total` |
        '''})
    found = {f.match for f in lint.lint_tree(root, rules=["R005"])}
    assert found == {"serve_undocumented_s", "serve_documented_total"}


def test_tracing_entry_points_are_torch_only(tmp_path):
    """``re.compile`` and a bare ``trace`` are not torch's tracers; the
    decorator form and ``jit.script`` are."""
    root = _tree(tmp_path, {"pkg/mod.py": '''
        import re
        import time

        import torch

        PAT = re.compile("x")

        def host(u):
            return time.time()

        re.compile(host)

        @torch.jit.script
        def scripted(u):
            return u * time.time()
        '''})
    fs = lint.lint_tree(root, rules=["R002"])
    assert [f.context for f in fs] == ["scripted"]


def test_only_the_port_is_linted_in_a_checkout(tmp_path):
    """In a checkout the linter reads the port and its root scripts,
    never the JAX package."""
    root = _tree(tmp_path, {
        "heat2d_tpu_torch/serve/mod.py":
            "import threading\nL = threading.Lock()\n",
        "heat2d_tpu/serve/mod.py": "import threading\nL = threading.Lock()\n",
        "chip_smoke.py": "def f(p):\n    open(p, 'w').write('x')\n",
        "other_script.py": "def f(p):\n    open(p, 'w').write('x')\n"})
    fs = lint.lint_tree(root, rules=["R001", "R006"])
    assert sorted(f.path for f in fs) == ["chip_smoke.py",
                                          "heat2d_tpu_torch/serve/mod.py"]


# ------------------------------------------------------------------ #
# baseline and CLI
# ------------------------------------------------------------------ #

SEEDED = {"pkg/io.py": '''
    def dump(path, s):
        with open(path, "w") as f:
            f.write(s)
    '''}


@pytest.mark.parametrize("entry,error", [
    ({"key": "R001:x:y:z"}, "no justification"),
    ({"key": "R001:x:y:z", "justification": "  "}, "no justification"),
    ({"justification": "why"}, "missing 'key'"),
])
def test_baseline_requires_key_and_justification(tmp_path, entry, error):
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"findings": [entry]}))
    with pytest.raises(lint.BaselineError, match=error):
        lint.load_baseline(str(bl))


def test_baseline_grandfathers_and_reports_stale(tmp_path):
    root = _tree(tmp_path, SEEDED)
    key = lint.lint_tree(root, rules=["R001"])[0].key
    new, old, stale = lint.split_baselined(
        lint.lint_tree(root, rules=["R001"]),
        {key: "a staging write", "R001:gone:ctx:snippet": "was fixed"})
    assert new == [] and [f.key for f in old] == [key]
    assert stale == ["R001:gone:ctx:snippet"]


def test_cli_rc_and_json(tmp_path, capsys):
    root = _tree(tmp_path, SEEDED)
    assert lint_main([root, "--baseline", "none", "--rules", "R001"]) == 1
    assert "R001 pkg/io.py" in capsys.readouterr().out
    key = lint.lint_tree(root, rules=["R001"])[0].key
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"findings": [
        {"key": key, "justification": "seeded"}]}))
    assert lint_main([root, "--baseline", str(bl), "--rules", "R001",
                      "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["new"] == [] and out["rules"] == ["R001"]
    assert out["baselined"][0]["justification"] == "seeded"
    assert lint_main([root, "--rules", "R999"]) == 2
    bl.write_text(json.dumps({"findings": [{"key": key}]}))
    assert lint_main([root, "--baseline", str(bl)]) == 2


def test_repo_tree_lints_clean_with_bounded_baseline(capsys):
    """The gate: heat2d-tpu-torch-lint exits 0 on the checkout, with at
    most a few baselined findings, each justified and none stale."""
    from heat2d_tpu_torch.analysis.cli import default_baseline_path
    baseline = lint.load_baseline(default_baseline_path())
    assert len(baseline) <= 5
    new, _old, stale = lint.split_baselined(lint.lint_tree(REPO), baseline)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == []
    assert lint_main([REPO]) == 0
    assert capsys.readouterr().out.startswith("OK: 0 new finding(s)")


# ------------------------------------------------------------------ #
# the lock auditor
# ------------------------------------------------------------------ #

def _in_thread(fn, *args):
    t = threading.Thread(target=fn, args=args)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def test_audited_locks_are_plain_when_off(monkeypatch):
    monkeypatch.delenv(locks.ENV_VAR, raising=False)
    assert type(locks.AuditedLock()) is type(threading.Lock())
    assert type(locks.AuditedRLock()) is type(threading.RLock())
    assert isinstance(locks.AuditedCondition(), threading.Condition)
    assert locks.report().clean and not locks.enabled()
    assert locks.ENV_VAR == jlocks.ENV_VAR


def test_lock_order_inversion_detected():
    locks.install()
    a, b = locks.AuditedLock("A"), locks.AuditedLock("B")

    def order(first, second):
        with first:
            with second:
                pass

    _in_thread(order, a, b)
    assert locks.report().clean
    _in_thread(order, b, a)
    rep = locks.report()
    assert rep.cycles and sorted(rep.cycles[0]) == ["A", "B"]
    assert not rep.clean and "cycle" in rep.render()


def test_lock_outliving_an_install_still_reports():
    """A lock built under an earlier auditor feeds the live one."""
    locks.install()
    old = locks.AuditedLock("OLD")
    locks.install()
    new = locks.AuditedLock("NEW")

    def order(first, second):
        with first:
            with second:
                pass

    _in_thread(order, old, new)
    _in_thread(order, new, old)
    assert sorted(locks.report().cycles[0]) == ["NEW", "OLD"]


def test_guarded_write_without_its_lock_detected():
    @locks.guarded_by("_lock", "count")
    class Box:
        def __init__(self):
            self._lock = locks.AuditedLock("box")
            self.count = 0          # before the lock was ever held: fine

        def good(self):
            with self._lock:
                self.count += 1

        def bad(self):
            self.count += 1

    locks.install()
    box = Box()
    box.good()
    assert locks.report().clean
    box.bad()
    rep = locks.report()
    assert len(rep.violations) == 1
    v = rep.violations[0]
    assert (v.cls, v.attr, v.lock_attr) == ("Box", "count", "_lock")
    assert "test_torch_analysis.py" in v.where
    locks.uninstall()
    box.bad()                       # uninstalled: the class is unpatched
    assert "count" not in vars(type(box)) and box.count == 3


def test_condition_over_an_audited_lock():
    """A condition's mutex is audited: waiting and notifying work, writes
    under ``with cond`` count as holding the lock, and an inversion
    through a condition is a cycle."""
    @locks.guarded_by("_cond", "items")
    class Queue:
        def __init__(self):
            self._cond = locks.AuditedCondition("queue")
            self.items = []

        def put(self, x):
            with self._cond:
                self.items = self.items + [x]
                self._cond.notify()

        def get(self):
            with self._cond:
                self._cond.wait_for(lambda: self.items, timeout=5)
                x, self.items = self.items[0], self.items[1:]
                return x

    locks.install()
    q = Queue()
    got = []
    t = threading.Thread(target=lambda: got.append(q.get()))
    t.start()
    q.put(7)
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == [7] and locks.report().clean
    other = locks.AuditedLock("other")

    def inv(first, second):
        with first:
            with second:
                pass

    _in_thread(inv, q._cond, other)
    _in_thread(inv, other, q._cond)
    assert sorted(locks.report().cycles[0]) == ["other", "queue"]


# ------------------------------------------------------------------ #
# the kernel-build sentinel
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("max_batch", [1, 2, 3, 8, 13, 64])
def test_log2_capacity_budget_equals_jax(max_batch):
    assert recompile.log2_capacity_budget(max_batch) == \
        jrecompile.log2_capacity_budget(max_batch) == \
        int(math.floor(math.log2(max_batch))) + 1


@pytest.mark.parametrize("method", ["auto", "adi", "mg"])
def test_serve_capacity_ladder_on_the_cpu(method):
    """Every occupancy 1..8 of one signature launches the ladder 1, 2, 4,
    8, within the budget; the plain versions build and load nothing."""
    rep = recompile.serve_compile_report(method=method, max_batch=8,
                                         device="cpu")
    assert rep["capacities"] == [1, 2, 4, 8] and rep["budget"] == 4
    assert rep["launches"] == 8
    assert (rep["builds"], rep["loads"], rep["rebuilds"]) == (0, 0, [])
    assert rep["ok"]


def test_compile_watch_counts_builds_and_rebuilds(monkeypatch):
    """The watch reads ``_build.EVENTS``: a build and a load of a new
    library are within the contract; a library built or loaded again
    after its first load is a rebuild, and the budget raises."""
    from heat2d_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "EVENTS", [("load", "stencil")])
    with recompile.CompileWatch() as w:
        _build.EVENTS += [("build", "shard"), ("load", "shard")]
    assert (w.builds, w.loads, w.builds_after_first_load()) == (1, 1, [])
    recompile.assert_bounded(w, 2)
    with recompile.CompileWatch(match="^build:") as w2:
        _build.EVENTS += [("build", "stencil"), ("load", "ensemble")]
    assert w2.names == ["build:stencil"]
    assert w2.builds_after_first_load() == ["stencil"]
    with pytest.raises(recompile.RecompileBudgetError, match="again"):
        recompile.assert_bounded(w2, 5)
    with pytest.raises(recompile.RecompileBudgetError, match="budget"):
        with recompile.CompileWatch(limit=0):
            _build.EVENTS.append(("build", "family"))


# ------------------------------------------------------------------ #
# "free when off": the three launch pins
# ------------------------------------------------------------------ #

PIN_CFGS = {
    "pallas": HeatConfig(nxprob=24, nyprob=20, steps=12, mode="pallas"),
    "pallas_convergence": HeatConfig(nxprob=24, nyprob=20, steps=40,
                                     mode="pallas", convergence=True,
                                     interval=4, sensitivity=1e-3),
}


@pytest.mark.parametrize("name", sorted(PIN_CFGS))
@pytest.mark.parametrize("pin", ["chaos", "lock_audit", "checkpoint_every"])
def test_launch_pin(tmp_path, pin, name):
    cfg = PIN_CFGS[name]
    if pin == "chaos":
        out = launch_pin.pin_chaos(cfg, "cpu")
    elif pin == "lock_audit":
        out = launch_pin.pin_lock_audit(cfg, "cpu")
    else:
        out = launch_pin.pin_checkpoint_every(cfg, 8, str(tmp_path), "cpu")
        assert out["on"]["checkpoints_written"] >= 2
    assert out["off"]["sha256"] == out["on"]["sha256"]
    assert out["on"]["steps_done"] <= cfg.steps


def test_launch_pin_is_not_vacuous():
    """Two runs that differ do differ under the pin's fingerprint."""
    cfg = PIN_CFGS["pallas"]
    a = launch_pin.solver_fingerprint(cfg, "cpu")
    b = launch_pin.solver_fingerprint(cfg.replace(steps=13), "cpu")
    launch_pin.assert_differs(a, b)
    with pytest.raises(AssertionError, match="differ"):
        launch_pin.assert_same(a, b)
    with pytest.raises(AssertionError, match="vacuous"):
        launch_pin.assert_differs(a, dict(a))


# ------------------------------------------------------------------ #
# the implicit gate
# ------------------------------------------------------------------ #

def test_implicit_gate_passes_on_the_cpu(capsys):
    from heat2d_tpu_torch.analysis import implicit_gate
    assert implicit_gate.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "implicit-gate passed" in out and "FAIL" not in out
    assert out.count("PASS: ") == 9


def test_analysis_exports_equal_jax():
    import heat2d_tpu.analysis as ja
    import heat2d_tpu_torch.analysis as ta
    assert ta.__all__ == ja.__all__
