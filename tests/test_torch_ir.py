"""The port's IR verifier (``heat2d_tpu_torch/analysis/ir.py``) against
the JAX package's (``heat2d_tpu/analysis/ir.py``).

- **repo sweep**: ``verify_all()`` (every family's step, ``stencil_step``,
  every (family x route) batch program, the tile plans, the sharded
  programs on a 2x2 of CPU slots with both halo routes and hybrid fused)
  reports zero findings; every family's derived radius and reads equal
  the JAX verifier's rows, exactly (they are integers).
- **seeded violations**, one a pass, after ``tests/test_ir.py``: a
  widened stencil, a reads mismatch, an underivable op, an undeclared
  downcast, an injected ``all_gather``, a non-neighbour strip shift, a
  missing exchange, an exchange in a batch program, a wrong ring depth,
  a residual sum in a fixed program, an exchange outside H14 on tier
  ``ici``; each names its pass, program and op. The four cases that fail
  on the JAX side (offsets through slice and pad, roll, provenance paths,
  a collective in a batch program) are held to the port's own exact
  values here.
- **abstract domain**: exact offsets through slice, pad, cat, roll,
  index, copy_ into a slice, convolution, transpose; TOP for a broadcast
  dependent value; coefficient reads counted once across views.
- **observation only**: a traced step's graph returns the eager step's
  bits, and the eager step is bitwise the same after tracing.
- **the CLI**: ``heat2d-tpu-torch-lint --ir`` exits 0 on the tree and 1
  on a seeded family, naming its program and op.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from heat2d_tpu_torch.analysis import cli as tcli
from heat2d_tpu_torch.analysis import ir
from heat2d_tpu_torch.analysis.dtype_flow import (census_casts,
                                                  precision_card,
                                                  record_collectives)
from heat2d_tpu_torch.analysis.footprint import derive_footprint, trace
from heat2d_tpu_torch.ops import cuda_ensemble as ce
from heat2d_tpu_torch.parallel import halo
from heat2d_tpu_torch.parallel.mesh import host_devices, make_mesh
from heat2d_tpu_torch.parallel.sharded import COLLECTIVE_CONTRACT
from heat2d_tpu_torch.problems import registry
from heat2d_tpu_torch.problems.registry import family_names, get_family

FAMILIES = ("heat5", "varcoef", "heat9", "advdiff", "reactdiff")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def report():
    """One full sweep shared by the gate tests (tracing is observation
    only, so sharing is sound)."""
    return ir.verify_all()


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX verifier's footprint rows (no sharded programs)."""
    from heat2d_tpu.analysis import ir as jir
    rep = jir.verify_all(include_sharded=False)
    return {r["program"]: r for r in rep.footprint_rows}


def _u(nx=24, ny=24):
    return torch.zeros(nx, ny)


# --------------------------------------------------------------------- #
# The repo sweep
# --------------------------------------------------------------------- #

def test_family_names_are_the_five_families():
    assert family_names() == FAMILIES


def test_repo_sweep_zero_findings(report):
    assert report.ok, "\n".join(f.describe() for f in report.findings)


@pytest.mark.parametrize("name", FAMILIES)
def test_footprint_rows_equal_the_jax_verifier(report, jax_rows, name):
    rows = {r["program"]: r for r in report.footprint_rows}
    mine, theirs = rows[f"{name}/step"], jax_rows[f"{name}/step"]
    spec = get_family(name).spec
    assert mine["derived"] == tuple(theirs["derived"]) \
        == (spec.halo_width, spec.halo_width)
    assert mine["derived_reads"] == theirs["derived_reads"] \
        == spec.reads_per_step
    assert mine["declared_width"] == theirs["declared_width"]


def test_stencil_step_row_equals_the_jax_heat5_row(report, jax_rows):
    rows = {r["program"]: r for r in report.footprint_rows}
    assert rows["stencil_step"]["derived"] == tuple(
        jax_rows["heat5/step"]["derived"]) == (1, 1)
    assert rows["stencil_step"]["derived_reads"] == 1


def test_sweep_covers_every_registered_route(report):
    progs = {c.program for c in report.cards}
    for name in FAMILIES:
        for route in get_family(name).spec.kernel_routes:
            assert f"{name}/{route}" in progs
    sharded = {r["program"] for r in report.collective_rows
               if r["program"].startswith("sharded/")}
    assert sharded == {"sharded/collective[collective]/fixed",
                       "sharded/collective[collective]/conv",
                       "sharded/fused[overlap]/fixed",
                       "sharded/fused[overlap]/conv",
                       "sharded/fused[ici]/fixed"}


def test_sharded_census_matches_contract(report):
    rows = {r["program"]: r for r in report.collective_rows
            if r["program"].startswith("sharded/")}
    for prog, row in rows.items():
        if "[ici]" in prog:
            assert row["exchanges"] == 0 and row["shifts"] == 0, row
            assert any(c.startswith("shard_fused") for c in row["census"])
        else:
            assert row["exchanges"] > 0 and \
                row["shifts"] == 4 * row["exchanges"], (prog, row)
        sums = any(c.startswith("allreduce") for c in row["census"])
        assert sums == prog.endswith("/conv"), (prog, row)


def test_varcoef_card_lists_its_allowlisted_narrowing(report):
    cards = {c.program: c for c in report.cards}
    casts = cards["varcoef/jnp"].casts
    assert casts and all((c.src, c.dst) == ("float64", "float32")
                         for c in casts)
    assert all(c.path[-1] == "varcoef_profiles" for c in casts)
    assert all(c.site.startswith("heat2d_tpu_torch/problems/kernels.py:")
               for c in casts)
    assert cards["heat5/band"].casts == []


def test_band_plans_carry_the_declared_ring():
    for name, w in (("heat5", 1), ("heat9", 2)):
        plan, t = ir._band_plan(name, 32, 64)
        assert plan.tsteps == w * t
        assert ir.check_band_strips(f"{name}/band", plan, w * t, w) == []


# --------------------------------------------------------------------- #
# Seeded violations: each pass fires and names the culprit
# --------------------------------------------------------------------- #

def test_seeded_widened_stencil_names_program_and_op():
    fam = get_family("heat9")
    findings, _ = ir.check_kernel_footprint(
        "seeded/widened", lambda v: fam.step(v, 0.1, 0.1), _u(),
        declared_width=1)
    assert findings
    msg = findings[0].describe()
    assert msg.startswith("[footprint] seeded/widened:")
    assert "derived access radius 2 != declared halo_width 1" in msg
    assert "op 'copy_'" in msg


def test_seeded_reads_mismatch_detected():
    fam = get_family("varcoef")
    findings, row = ir.check_kernel_footprint(
        "seeded/reads", lambda v: fam.step(v, 0.1, 0.1), _u(),
        declared_width=1, declared_reads=1)
    assert row["derived_reads"] == 3
    assert any("derived HBM reads/step 3" in f.message
               and "declared reads_per_step 1" in f.message
               for f in findings)


def test_seeded_underivable_footprint_is_a_finding():
    findings, _ = ir.check_kernel_footprint(
        "seeded/strided", lambda v: v[::2, :], _u(), declared_width=1)
    assert [f.pass_name for f in findings] == ["footprint"]
    assert "underivable: op 'slice[strided]'" in findings[0].message


def test_seeded_undeclared_downcast_named_and_allowlistable():
    def kern(v):
        out = v.clone()
        out[1:-1, 1:-1] = v[1:-1, 1:-1].to(torch.bfloat16).to(torch.float32)
        return out

    gm = trace(kern, _u())
    findings, card = ir.check_dtypes("seeded/downcast", gm)
    msgs = [f.describe() for f in findings]
    assert len(msgs) == 2
    assert all(m.startswith("[dtype-flow] seeded/downcast: undeclared "
                            "cast ") for m in msgs)
    assert any("float32 ⤓ bfloat16 at <top> (tests/test_torch_ir.py:" in m
               for m in msgs)
    allow = (("float32", "bfloat16"), ("bfloat16", "float32"))
    assert ir.check_dtypes("seeded/downcast", gm, allow)[0] == []
    assert ir.check_dtypes("seeded/downcast", gm,
                           allow + (("float64", "float16"),))[0] == []


def test_integer_index_casts_are_carded_but_not_findings():
    def kern(v):
        idx = torch.arange(v.shape[0], dtype=torch.int32).to(torch.int64)
        return v + idx[:, None].to(v.dtype) * 0

    findings, card = ir.check_dtypes("seeded/intcast", trace(kern, _u()))
    assert any(c.src == "int32" and c.dst == "int64" for c in card.casts)
    assert not any(c.src == "int32" and c.dst == "int64"
                   for c in card.findings())
    # the int64 -> float32 cast of the index is precision-relevant
    assert [(c.src, c.dst) for c in card.findings()] == [("int64",
                                                          "float32")]


@pytest.fixture
def one_process_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_seeded_injected_all_gather_is_forbidden(one_process_group):
    import torch.distributed as dist

    def program(u):
        out = [torch.empty_like(u)]
        dist.all_gather(out, u)          # the classic regression
        return u + out[0]

    _, census = record_collectives(program, _u(8, 8))
    findings, _ = ir.check_collectives("seeded/gather", census,
                                       COLLECTIVE_CONTRACT,
                                       require_exchange=False)
    assert any(f.pass_name == "collective"
               and "forbidden collective all_gather at <top>" in f.message
               for f in findings)
    assert all(f.program == "seeded/gather" for f in findings)


def _blocks(gx, gy, n=8):
    return [[torch.full((n, n), float(i * gy + j)) for j in range(gy)]
            for i in range(gx)]


def test_seeded_non_neighbor_strip_shift_detected():
    mesh = make_mesh(3, 1, host_devices(3, "cpu"))
    blocks = _blocks(3, 1)

    def teleport(b):
        return halo._phase(mesh, [(b, 2, 0)] * 4)   # skips a neighbour

    _, census = record_collectives(teleport, blocks)
    findings, _ = ir.check_collectives("seeded/teleport", census,
                                       COLLECTIVE_CONTRACT)
    assert any("(0, 0) -> (2, 0) is not a nearest-neighbor" in f.message
               for f in findings)


def test_neighbor_exchange_passes_and_missing_exchange_detected():
    blocks = _blocks(2, 2)
    _, census = record_collectives(
        lambda b: halo.exchange_halo_strips(b, 2), blocks)
    findings, row = ir.check_collectives("ok", census, COLLECTIVE_CONTRACT,
                                         convergence=False)
    assert findings == [] and row["shifts"] == 4
    _, silent = record_collectives(
        lambda b: [[x * 2 for x in r] for r in b], blocks)
    findings, _ = ir.check_collectives("seeded/silent", silent,
                                       COLLECTIVE_CONTRACT)
    assert any("no strip halo exchange" in f.message for f in findings)


def test_collective_in_batch_program_detected():
    blocks = _blocks(2, 2)
    _, census = record_collectives(
        lambda b: halo.exchange_halo_strips(b, 1), blocks)
    findings, _ = ir.check_no_collectives("seeded/batch", census)
    assert findings and all(f.pass_name == "collective" for f in findings)
    assert any("unexpected collective exchange at <top>" in f.message
               for f in findings)
    assert any("strip_shift at exchange" in f.message for f in findings)


def test_residual_sum_in_a_fixed_program_and_ici_exchange_detected():
    from heat2d_tpu_torch.parallel import sharded
    blocks = _blocks(2, 2)

    def program(b):
        halo.exchange_halo_strips(b, 1)
        return sharded._total([x.sum() for r in b for x in r])

    _, census = record_collectives(program, blocks)
    findings, _ = ir.check_collectives("seeded/fixed", census,
                                       COLLECTIVE_CONTRACT,
                                       convergence=False)
    assert [f.message for f in findings] == [
        "residual all-reduce ×1 in a fixed-step program"]
    findings, _ = ir.check_collectives("seeded/ici", census,
                                       COLLECTIVE_CONTRACT,
                                       convergence=True, tier="ici")
    assert [f.message for f in findings] == [
        "tier 'ici' exchanged strips outside its kernel (1 exchange(s))"]


def test_seeded_wrong_band_ring_depth_detected():
    plan = ce.tile_plan(32, 64, "cpu", tsteps=8)
    assert ir.check_band_strips("band/ok", plan, 8, 1) == []
    bad = ir.check_band_strips("band/bad", plan, 16, 2)
    assert bad and bad[0].pass_name == "footprint"
    assert "tile plan ships a 8-deep ring" in bad[0].message
    assert "halo_width*tsteps = 16" in bad[0].message


# --------------------------------------------------------------------- #
# The abstract domain: exact offsets through the covered ops
# --------------------------------------------------------------------- #

def test_offsets_through_slice_and_pad():
    # out[i, j] = v[i + 2, j - 1] where data exists
    fp = derive_footprint(
        lambda v: torch.nn.functional.pad(v[2:, :-1], (1, 0, 0, 2)), _u())
    assert fp.derivable
    assert fp.lo == (2, -1) and fp.hi == (2, -1)
    assert fp.radius(0) == 2 and fp.radius(1) == 1
    assert fp.witness(0) == "slice" and fp.witness(1) == "constant_pad_nd"


def test_offsets_through_roll():
    # out[j] = v[j - 1], and out[0] = v[23] across the wraparound
    fp = derive_footprint(lambda v: torch.roll(v, 1, 0), _u())
    assert fp.derivable
    assert fp.lo == (-1, 0) and fp.hi == (23, 0)
    assert fp.witness(0) == "roll"


def test_offsets_through_cat_and_index():
    fp = derive_footprint(lambda v: torch.cat([v[:, 1:], v[:, :1]], 1),
                          _u())
    assert fp.lo == (0, -23) and fp.hi == (0, 1)
    fp = derive_footprint(lambda v: v[:, [2, 3, 4]], _u())
    assert fp.lo == (0, 2) and fp.hi == (0, 2) and fp.witness(1) == "index"


def test_offsets_through_copy_into_a_slice():
    def kern(v):
        out = v.clone()
        out[1:-1, 1:-1] = v[:-2, 1:-1] + v[2:, 1:-1]
        return out

    fp = derive_footprint(kern, _u())
    assert fp.derivable and fp.radii() == (1, 0)
    assert fp.witness(0) == "copy_"


def test_offsets_through_conv():
    k = torch.ones(1, 1, 5, 3)

    def kern(v):
        return torch.nn.functional.conv2d(v[None, None], k,
                                          padding=(2, 1))[0, 0]

    fp = derive_footprint(kern, _u())
    assert fp.derivable and fp.radii() == (2, 1)
    assert fp.witness(0) == "convolution"


def test_offsets_through_transpose():
    fp = derive_footprint(lambda v: v[2:, :].T, _u())
    assert fp.derivable and fp.lo == (0, 2) and fp.hi == (0, 2)


def test_elementwise_broadcast_of_dep_value_is_top():
    fp = derive_footprint(lambda v: v * v.mean(), _u())
    assert not fp.derivable and fp.top == "mean"
    fp = derive_footprint(lambda v: v * v[:1, :], _u())
    assert not fp.derivable and fp.top == "mul"


def test_coefficient_reads_counted_once_across_views():
    cxf = torch.linspace(0.1, 0.2, 24 * 24).reshape(24, 24)

    def kern(v):
        # two slices of one field: one read, not two
        return v[1:-1, :] * cxf[1:-1, :] + v[:-2, :] * cxf[:-2, :]

    assert derive_footprint(kern, _u()).coef_reads == 1


# --------------------------------------------------------------------- #
# Precision cards
# --------------------------------------------------------------------- #

def test_precision_card_provenance_paths():
    def inner(v):
        return v.to(torch.float64)

    def outer(v):
        return inner(v).to(torch.float32)

    card = precision_card("prov", outer, _u())
    by_dst = {c.dst: c for c in card.casts}
    assert by_dst["float64"].path == ("inner",)
    assert by_dst["float32"].path == ()
    assert all(c.site.startswith("tests/test_torch_ir.py:")
               for c in card.casts)
    assert "float64 ⤓ float32 at <top> (tests/test_torch_ir.py:" in \
        by_dst["float32"].describe()


def test_census_casts_aggregates_counts():
    def kern(v):
        a = v.to(torch.float64).to(torch.float32)
        return a + a

    def twice(v):
        return kern(v) + kern(v)

    up = [c for c in census_casts(trace(twice, _u())) if c.dst == "float64"]
    assert len(up) == 1 and up[0].count == 2


# --------------------------------------------------------------------- #
# Observation only
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", FAMILIES)
def test_tracing_leaves_the_step_bitwise_unchanged(name):
    fam = get_family(name)
    u = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 100, (20, 28)).astype(np.float32))
    before = fam.step(u, 0.1, 0.1)
    gm = trace(lambda v: fam.step(v, 0.1, 0.1), u)
    after = fam.step(u, 0.1, 0.1)
    assert torch.equal(before, after)
    assert torch.equal(gm(u), before)


def test_render_report_names_programs(report):
    text = ir.render_report(report, verbose=True)
    assert "heat9/step: declared w=2, derived radii (2, 2)" in text
    assert "varcoef/step: declared w=1, derived radii (1, 1), reads 3 " \
           "(declared 3)" in text
    assert "sharded/fused[ici]/fixed: collectives: " in text
    assert "no IR findings" in text


# --------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------- #

def test_lint_ir_exits_zero_on_the_tree(capsys):
    assert tcli.main(["--ir", "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["findings"] == []
    assert len(out["footprint_rows"]) == 6


def test_lint_ir_exits_one_on_a_seeded_family(monkeypatch, capsys):
    fam = get_family("heat9")
    narrowed = dataclasses.replace(
        fam, spec=dataclasses.replace(fam.spec, halo_width=1))
    monkeypatch.setitem(registry._FAMILIES, "heat9", narrowed)
    assert tcli.main(["--ir"]) == 1
    out = capsys.readouterr().out
    assert "[footprint] heat9/step: axis 0: derived access radius 2 != " \
           "declared halo_width 1" in out
    assert "op 'copy_'" in out


# --------------------------------------------------------------------- #
# The linter's scope over the new modules
# --------------------------------------------------------------------- #

def _tree(tmp_path, files):
    import textwrap
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(tmp_path)


def test_the_port_tools_are_linted_in_a_checkout(tmp_path):
    from heat2d_tpu_torch.analysis import lint
    root = _tree(tmp_path, {
        "heat2d_tpu_torch/__init__.py": "",
        "tools/sweep_x_torch.py": "def f(p):\n    open(p, 'w').write('x')\n",
        "tools/other.py": "def f(p):\n    open(p, 'w').write('x')\n"})
    fs = lint.lint_tree(root, rules=["R001"])
    assert [f.path for f in fs] == ["tools/sweep_x_torch.py"]


def test_make_fx_scopes_are_traced_scopes(tmp_path):
    from heat2d_tpu_torch.analysis import lint
    root = _tree(tmp_path, {"pkg/mod.py": '''
        import time

        from torch.fx.experimental.proxy_tensor import make_fx

        def step(u):
            return u * time.time()

        def host(u):
            return time.time()

        def run(u):
            host(u)
            return make_fx(step)(u)
        '''})
    fs = lint.lint_tree(root, rules=["R002"])
    assert [f.context for f in fs] == ["step"]
