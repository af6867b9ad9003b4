"""A whole run on the CPU, the harness's look for a card skipped, with
the timed path broken underneath: each fault a cell can have makes
``correct`` come out false, and the sound path makes it true."""

import time

import numpy as np
import pytest
import torch

import heat2d_tpu_torch.ops.cuda_stencil as cs
from heat2d_tpu_torch.models.solver import Heat2DSolver
from portbench.tests._small import run_small

SOLVE_CELLS = ["solve-2560x2048", "converge-2560x2048"]
SERVE = "serve-640x1024"


def _unchanged(monkeypatch):
    # every plain step returns its state unchanged
    monkeypatch.setattr(cs, "step_plain", lambda u, cx, cy, form=0: u)


def _alter(u):
    u = np.array(u, copy=True)
    u[u.shape[0] // 2, u.shape[1] // 2] *= 1.01
    return u


@pytest.mark.parametrize("name", SOLVE_CELLS + [SERVE])
def test_sound_run_is_correct(name):
    extra = {"rate": 200.0} if name == SERVE else {}
    r = run_small(name, **extra)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", SOLVE_CELLS + [SERVE])
def test_state_left_unchanged_is_caught(name, monkeypatch):
    _unchanged(monkeypatch)
    extra = {"rate": 200.0} if name == SERVE else {}
    r = run_small(name, **extra)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", SOLVE_CELLS)
def test_altered_grid_is_caught(name, monkeypatch):
    run = Heat2DSolver.run

    def altered(self, *a, **kw):
        r = run(self, *a, **kw)
        r.u = _alter(r.u)
        return r

    monkeypatch.setattr(Heat2DSolver, "run", altered)
    assert not run_small(name)["correct"]


def _serve_fault(wrap):
    def on_driver(drv):
        drv.wrap = wrap
    return run_small(SERVE, rate=400.0, on_driver=on_driver)


def test_serving_half_the_batch_left_out_is_caught():
    def wrap(solve_batch):
        def half(reqs):
            # a slow launch, so that the requests arriving meanwhile
            # fill the next batch
            time.sleep(0.02)
            k = (len(reqs) + 1) // 2
            got = solve_batch(reqs[:k])
            return got + got[:len(reqs) - k]
        return half

    r = _serve_fault(wrap)
    assert not r["correct"], r["checks"]


def test_serving_altered_answer_is_caught():
    def wrap(solve_batch):
        def altered(reqs):
            return [(_alter(u), k) for u, k in solve_batch(reqs)]
        return altered

    r = _serve_fault(wrap)
    assert not r["correct"], r["checks"]
