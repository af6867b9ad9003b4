"""The CUDA kernels on the card, against their plain PyTorch versions on
the same card. Marked ``cuda``: they skip where no card is present, and
run on the H100 with

    python -m pytest tests/test_torch_cuda.py -m cuda

Literal form: bitwise. FMA form: within ``n * 2**-21 * max|plain|``
after n steps (the kernel contracts each update into FMAs, the plain
version rounds every operation)."""

import pytest
import torch

from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.models.solver import Heat2DSolver
from heat2d_tpu_torch.ops import cuda_stencil as cs

pytestmark = pytest.mark.cuda

FORMS = [cs.FORM_FMA, cs.FORM_LITERAL]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _close(got, ref, n, form):
    err = float((got.double() - ref.double()).abs().max())
    tol = 0.0 if form == cs.FORM_LITERAL else (
        n * 2.0 ** -21 * float(ref.abs().max()))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(37, 53), (130, 257)])
def test_kernels_match_plain(card, shape, form):
    g = torch.Generator(device=card)
    g.manual_seed(7)
    u = torch.rand(shape, generator=g, device=card)
    cs.reset_launch_counts()
    _close(cs.step(u, 0.1, 0.1, form), cs.step_plain(u, 0.1, 0.1, form),
           1, form)
    for t, nsub in [(1, 1), (3, 2), (8, 8), (8, 5)]:
        _close(cs.tile_multi(u, nsub, 0.1, 0.1, form, t),
               cs.multi_step_plain(u, nsub, 0.1, 0.1, form), nsub, form)
        got, r = cs.tile_multi_resid(u, nsub, 0.1, 0.1, form, t)
        ref, r_ref = cs.tile_multi_resid_plain(u, nsub, 0.1, 0.1, form)
        _close(got, ref, nsub, form)
        assert float(r) == pytest.approx(float(r_ref), rel=1e-4)
    for n in (1, 2, 9):
        _close(cs.resident(u, n, 0.1, 0.1, form),
               cs.multi_step_plain(u, n, 0.1, 0.1, form), n, form)
    assert set(cs.launch_counts().values()) != {0}
    assert min(cs.launch_counts().values()) > 0


@pytest.mark.parametrize("streamed", [False, True])
def test_pallas_solver_on_the_card(card, monkeypatch, streamed):
    if streamed:
        monkeypatch.setattr(cs, "fits_resident", lambda shape, dev: False)
    cfg = HeatConfig(nxprob=96, nyprob=160, steps=57, mode="pallas",
                     convergence=True, interval=7, sensitivity=1e3,
                     bitwise_parity=True)
    got = Heat2DSolver(cfg).run(timed=False)
    want = Heat2DSolver(cfg.replace(mode="serial")).run(timed=False)
    assert got.steps_done == want.steps_done
    assert (got.u == want.u).all()
