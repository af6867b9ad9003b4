"""Batched ensemble runners of the problem families: the port of
``heat2d_tpu/problems/runners.py``.

One fixed-step runner per explicit route, ``(u0, cxs, cys, *, steps) ->
batch`` like ``models.ensemble._BATCH_RUNNERS``, so the pair-tracked
convergence loop wraps any of them:

- jnp: the family's plain step on the whole batch, (B, 1, 1) coefficients;
- pallas: H8 ``fam_resident``, every step in one cooperative launch;
- band: H9 ``fam_tile_multi`` sweeps, a ``W * T``-deep ring per sweep.

``pick_route`` decides route legality from the declared spec: a route
the family does not declare is a ``ConfigError`` naming the combination,
and 'auto' resolves to pallas when a member passes ``fits_resident``,
else band, else jnp, restricted to the declared routes (for heat5 the
resolution of ``ensemble._pick_method``).
"""

from __future__ import annotations

import functools

from heat2d_tpu_torch.config import ConfigError
from heat2d_tpu_torch.ops import cuda_family as cf
from heat2d_tpu_torch.ops.cuda_stencil import fits_resident
from heat2d_tpu_torch.problems.base import spec_for
from heat2d_tpu_torch.problems.registry import get_family
from heat2d_tpu_torch.utils.profiling import phase
from heat2d_tpu_torch.vocab import DEFAULT_PROBLEM


def pick_route(problem: str, method: str, nx: int, ny: int,
               device) -> str:
    """Resolve a serve/config ``method`` to a route for ``problem`` on
    ``device``, enforcing the capability matrix; raises ``ConfigError``
    naming an unsupported combination."""
    spec = spec_for(problem)
    ok, reason = spec.supports_method(method)
    if not ok:
        raise ConfigError(reason)
    if method != "auto":
        return method
    routes = spec.kernel_routes
    if "pallas" in routes and fits_resident((nx, ny), device):
        return "pallas"
    if "band" in routes:
        return "band"
    return "jnp"


def _run_batch_jnp_family(u0, cxs, cys, *, steps, family):
    cx, cy = cxs.reshape(-1, 1, 1), cys.reshape(-1, 1, 1)
    u = u0
    for _ in range(steps):
        u = family.step(u, cx, cy)
    return u


def _run_batch_pallas_family(u0, cxs, cys, *, steps, family):
    scal = cf.scalar_block(family.name, cxs, cys)
    with phase("stencil_chunk"):
        return cf.fam_resident(u0, steps, scal, family.name)


def _run_batch_band_family(u0, cxs, cys, *, steps, family):
    scal = cf.scalar_block(family.name, cxs, cys)
    with phase("stencil_chunk"):
        return cf.fam_tiled_chunk(u0, steps, scal, family.name)


_ROUTE_RUNNERS = {
    "jnp": _run_batch_jnp_family,
    "pallas": _run_batch_pallas_family,
    "band": _run_batch_band_family,
}


def fixed_runner(problem: str, route: str):
    """The fixed-step batch runner of ``problem`` on a resolved route,
    signature-compatible with ``ensemble._BATCH_RUNNERS`` (heat5 returns
    those runners themselves, so it still runs H5/H6)."""
    if problem == DEFAULT_PROBLEM:
        from heat2d_tpu_torch.models import ensemble
        return ensemble._BATCH_RUNNERS[route]
    try:
        base = _ROUTE_RUNNERS[route]
    except KeyError:
        raise ValueError(
            f"no generic batch runner for route {route!r} "
            f"(explicit routes: {tuple(_ROUTE_RUNNERS)})") from None
    return functools.partial(base, family=get_family(problem))
