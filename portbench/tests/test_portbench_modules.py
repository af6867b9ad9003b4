"""No run loads the JAX stack or the JAX package, compared by whole
top-level names; the reference imports nothing of the program."""

import ast
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parents[1]


def test_forbidden_names_are_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "heat2d_tpu",
            "heat2d_tpu.ops", "flax.linen"]
    assert harness.forbidden_loaded(mods) == ["flax", "heat2d_tpu", "jax",
                                              "jaxlib"]
    ok = ["heat2d_tpu_torch", "heat2d_tpu_torch.models.solver", "jaxtyping",
          "numpy", "torch", "portbench.harness", "heat2d_tpu2"]
    assert harness.forbidden_loaded(ok) == []


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_neither_jax_nor_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tops = _imports(path)
        assert not tops & {"jax", "jaxlib", "flax", "heat2d_tpu",
                           "heat2d_tpu_torch"}, (path, tops)


def test_no_file_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        tops = _imports(path)
        assert not tops & {"jax", "jaxlib", "flax", "heat2d_tpu"}, path


def test_no_file_of_the_benchmark_reads_the_jax_sweeps():
    for path in HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert "benchmarks/" not in path.read_text(), path
