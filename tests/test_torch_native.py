"""The port's native ``.dat`` formatter (``heat2d_tpu_torch/native``)
against its Python formatter and the JAX package's writers, after
``tests/test_native.py``: byte for byte in both layouts, on random
values, on every class of float32 bit pattern and on the cases the
rounding turns on (``-0.0``, ties such as ``.05`` and ``.25``, ``1e8``,
subnormals, the largest floats, infinities and NaN: a NaN is written
"nan" whatever its sign bit, as Python writes it). The library builds
from the repo's source into ``build/native/`` at first use; a failed
build with a compiler present raises; only without a compiler do the
writers use the Python formatter, and the run record names the one that
ran."""

import json
import os

import numpy as np
import pytest

from heat2d_tpu.io import writers as jw
from heat2d_tpu_torch import cli as tcli
from heat2d_tpu_torch.io import writers as tw
from heat2d_tpu_torch.native import lib as native_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ("rowmajor", "baseline")

SPECIAL = np.array(
    [0.0, -0.0, 0.05, -0.05, 0.15, 0.25, -0.25, 0.35, 0.45, 0.95, 9.95,
     -2.25, 99999.95, 1e8, -1e8, 123456789.0, 2.0 ** 40, 2.0 ** 59,
     2.0 ** 62, 3.4e38, -3.4e38, 1e-45, -1e-45, 1.17549435e-38, np.inf,
     -np.inf, np.nan, 0.04999, 0.050001, -0.04, 1234.5678],
    dtype=np.float32)


@pytest.fixture(scope="module")
def native():
    assert native_lib.available(), "this host has a C++ compiler"
    return native_lib.load()


def _python(layout, a):
    """The reference's bytes by Python's own ``format`` (test_native.py's
    oracle)."""
    if layout == "rowmajor":
        return "".join("".join(format(float(v), "6.1f") + " " for v in row)
                       + "\n" for row in a)
    nx, ny = a.shape
    return "".join(" ".join(format(float(a[ix, iy]), "6.1f")
                            for ix in range(nx)) + "\n"
                   for iy in range(ny - 1, -1, -1))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_special_values_match_python_and_jax(native, layout):
    a = SPECIAL.reshape(1, -1) if layout == "rowmajor" \
        else SPECIAL.reshape(-1, 1)
    a = np.concatenate([a, -a], axis=0 if layout == "rowmajor" else 1)
    want = _python(layout, a)
    assert getattr(native, f"format_{layout}")(a) == want
    assert getattr(tw, f"python_format_{layout}")(a) == want
    # the JAX package's native formatter writes a NaN with its sign bit
    # set as "-nan" (snprintf), where Python and the port write "nan":
    # the JAX writers are held on the rest
    a = np.where(np.isnan(a), np.float32(0.0), a)
    assert getattr(jw, f"format_grid_{layout}")(a) == _python(layout, a)
    assert getattr(tw, f"format_grid_{layout}")(a) == _python(layout, a)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_random_values_match_python(native, layout, rng):
    a = np.concatenate([rng.uniform(-1e6, 1e6, 97),
                        rng.uniform(-1, 1, 97),
                        np.round(rng.uniform(-100, 100, 96) * 20) / 20]
                       ).astype(np.float32).reshape(10, 29)
    assert getattr(tw, f"format_grid_{layout}")(a) == _python(layout, a)
    assert getattr(tw, f"format_grid_{layout}")(a) == \
        getattr(jw, f"format_grid_{layout}")(a)


def test_every_kind_of_bit_pattern_matches_python(native, rng):
    bits = rng.integers(0, 2 ** 32, size=40_000, dtype=np.uint64)
    a = bits.astype(np.uint32).view(np.float32).reshape(200, 200)
    assert native.format_rowmajor(a) == tw.python_format_rowmajor(a)
    assert native.format_baseline(a) == tw.python_format_baseline(a)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_written_files_equal_the_jax_writers(tmp_path, layout):
    from heat2d_tpu_torch.ops.init import inidat
    u = inidat(12, 9).numpy()
    getattr(tw, f"write_grid_{layout}")(u, tmp_path / "t.dat")
    getattr(jw, f"write_grid_{layout}")(u, tmp_path / "j.dat")
    assert (tmp_path / "t.dat").read_bytes() == \
        (tmp_path / "j.dat").read_bytes()


def test_library_builds_into_build_native(native):
    path = native_lib.library_path()
    assert path.parent == native_lib.BUILD_DIR
    assert str(native_lib.BUILD_DIR) == os.path.join(REPO, "build",
                                                     "native")
    assert path.exists() and native.path == path
    pkg = os.path.join(REPO, "heat2d_tpu_torch", "native")
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert tw.dat_writer() == "native"


def test_a_failed_build_with_a_compiler_raises(tmp_path, monkeypatch):
    bad = tmp_path / "heat2d_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_lib, "SOURCE", bad)
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(native_lib.NativeBuildError, match="failed to build"):
        native_lib.load()
    with pytest.raises(native_lib.NativeBuildError):
        tw.format_grid_rowmajor(np.zeros((2, 2), np.float32))
    assert not list((tmp_path / "native").glob("*.so"))


def test_without_a_compiler_the_python_formatter_runs(monkeypatch, rng):
    monkeypatch.setattr(native_lib, "compiler", lambda: None)
    assert tw.dat_writer() == "python"
    with pytest.raises(native_lib.NativeBuildError, match="no C\\+\\+"):
        native_lib.load()
    a = rng.uniform(-50, 50, (7, 5)).astype(np.float32)
    assert tw.format_grid_rowmajor(a) == _python("rowmajor", a)
    assert tw.format_grid_baseline(a) == _python("baseline", a)


@pytest.mark.parametrize("writer", ("native", "python"))
def test_run_records_name_the_writer(tmp_path, monkeypatch, writer):
    if writer == "python":
        monkeypatch.setattr(native_lib, "compiler", lambda: None)
    for kind, extra in (("run", []),
                        ("ensemble", ["--ensemble-cx", "0.1,0.2",
                                      "--ensemble-cy", "0.1,0.1"])):
        out = tmp_path / kind
        rec = tmp_path / f"{kind}.json"
        assert tcli.main(["--device", "cpu", "--nxprob", "12", "--nyprob",
                          "10", "--steps", "3", "--outdir", str(out),
                          "--run-record", str(rec)] + extra) == 0
        assert json.loads(rec.read_text())["dat_writer"] == writer
    none = tmp_path / "none.json"
    assert tcli.main(["--device", "cpu", "--nxprob", "12", "--nyprob", "10",
                      "--steps", "3", "--dat-layout", "none", "--outdir",
                      str(tmp_path / "n"), "--run-record", str(none)]) == 0
    assert "dat_writer" not in json.loads(none.read_text())
