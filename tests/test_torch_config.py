"""The port's HeatConfig against the JAX package's: same fields, same
defaults, same properties, and the same invalid configs refused in both
stacks."""

import dataclasses

import pytest
import torch

from heat2d_tpu import config as jcfg
from heat2d_tpu import vocab as jvocab
from heat2d_tpu_torch import config as tcfg
from heat2d_tpu_torch import vocab as tvocab
from heat2d_tpu_torch.interop import config_from_dict


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_fields_and_defaults_equal():
    assert _fields(tcfg.HeatConfig) == _fields(jcfg.HeatConfig)
    assert tcfg.HeatConfig().to_dict() == jcfg.HeatConfig().to_dict()


def test_vocabularies_equal():
    assert tcfg.MODES == jcfg.MODES
    assert tcfg.HALO_ROUTES == jcfg.HALO_ROUTES
    assert tvocab.TIME_METHODS == jvocab.TIME_METHODS
    assert tvocab.IMPLICIT_METHODS == jvocab.IMPLICIT_METHODS
    assert tvocab.EXPLICIT_ROUTES == jvocab.EXPLICIT_ROUTES
    assert tvocab.SERVE_METHODS == jvocab.SERVE_METHODS
    assert tvocab.PROBLEMS == jvocab.PROBLEMS
    assert tvocab.DEFAULT_PROBLEM == jvocab.DEFAULT_PROBLEM
    assert tcfg.CUDA_DEFAULTS == jcfg.CUDA_DEFAULTS
    assert tcfg.BASELINE_DEFAULTS == jcfg.BASELINE_DEFAULTS
    assert tvocab.ADVECTION_VELOCITY == jvocab.ADVECTION_VELOCITY
    assert tvocab.REACTION_RATE == jvocab.REACTION_RATE


@pytest.mark.parametrize("problem", jvocab.PROBLEMS)
def test_family_specs_equal(problem):
    """Every FamilySpec field, the derived grid floor, the capability
    matrix and each method's (ok, reason) equal the JAX package's."""
    from heat2d_tpu.problems import base as jbase
    from heat2d_tpu_torch.problems import base as tbase
    t, j = tbase.FAMILY_SPECS[problem], jbase.FAMILY_SPECS[problem]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.min_grid == j.min_grid
    assert tbase.capability_matrix()[problem] == \
        jbase.capability_matrix()[problem]
    assert tbase.state_arrays(problem) == jbase.state_arrays(problem)
    for method in ("explicit", "auto") + jvocab.SERVE_METHODS + ("rk4",):
        assert tbase.supports_method(problem, method) == \
            jbase.supports_method(problem, method)
    with pytest.raises(ValueError) as te:
        tbase.spec_for("wave")
    with pytest.raises(ValueError) as je:
        jbase.spec_for("wave")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(nxprob=640, nyprob=1024, steps=10000, mode="pallas"),
    dict(mode="dist2d", gridx=2, gridy=5, convergence=True, interval=7),
    dict(accum_dtype="float64", bitwise_parity=True, cx=0.2, cy=0.05),
])
def test_one_dict_builds_both_stacks(kw):
    j = jcfg.HeatConfig(**kw)
    t = config_from_dict(j.to_dict())
    assert t.to_dict() == j.to_dict()
    assert jcfg.HeatConfig.from_dict(t.to_dict()) == j
    for prop in ("shape", "xcell", "ycell", "n_shards"):
        assert getattr(t, prop) == getattr(j, prop)


@pytest.mark.parametrize("kw", [
    dict(mode="gpu"),
    dict(nxprob=2),
    dict(nyprob=1),
    dict(steps=-1),
    dict(accum_dtype="float16"),
    dict(gridx=0),
    dict(mode="dist2d", nxprob=10, gridx=3),
    dict(mode="dist1d", numworkers=2, strict_baseline=True),
    dict(convergence=True, interval=0),
    dict(halo_depth=0),
    dict(halo="ring"),
    dict(method="rk4"),
    dict(problem="wave"),
    dict(problem="heat9", mode="pallas"),
    dict(problem="heat9", method="mg"),
    dict(problem="reactdiff", method="adi"),
    dict(problem="heat9", nxprob=4),
    dict(problem="heat9", cx=0.2, cy=0.2),
    dict(problem="advdiff", cx=0.001),
    dict(cx=0.3, cy=0.3),
    dict(cx=-0.1),
    dict(method="adi", mode="dist2d", gridx=2),
])
def test_invalid_configs_raise_in_both(kw):
    with pytest.raises(jcfg.ConfigError) as je:
        jcfg.HeatConfig(**kw)
    with pytest.raises(tcfg.ConfigError) as te:
        tcfg.HeatConfig(**kw)
    assert str(te.value) == str(je.value)
