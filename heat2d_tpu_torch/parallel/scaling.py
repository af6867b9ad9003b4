"""Strong scaling: the port of ``heat2d_tpu/parallel/scaling.py``.

The same fixed global problem is advanced on one slot and on an n-slot
near-square mesh, and

    strong_scaling_efficiency = rate_n / (n * rate_1)

is 1.0 at perfect scaling. Records are ``kind="multichip"`` run records
with the JAX package's payload keys.

A slot is a ``torch.device`` (``parallel.mesh``): with
``host_devices(n)`` several slots share one card, and then the ratio
measures what the decomposition (the exchanges, the per-shard launches,
the shards run one after another on one card) costs on that card, not a
gain from more cards; a caller reports how many cards the slots span
(``Mesh.distinct``).
"""

from __future__ import annotations


def square_mesh(n: int) -> tuple[int, int]:
    """The closest-to-square (gx, gy) factorization of ``n``, the mesh
    shape the reference hardcodes as GRIDX x GRIDY."""
    gx = int(n ** 0.5)
    while n % gx:
        gx -= 1
    return gx, n // gx


def _rate(cfg, devices) -> float:
    """Mcells/s of one sharded run under the reference timing protocol
    (the warmup run excluded)."""
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    return Heat2DSolver(cfg, devices=devices).run(gather=False).mcells_per_s


def measure_strong_scaling(n_devices: int | None = None,
                           nx: int = 64, ny: int = 64, steps: int = 32,
                           halo: str = "collective", halo_depth=None,
                           mode: str = "dist2d", devices=None,
                           device=None) -> dict:
    """One strong-scaling measurement: the fixed (nx, ny) grid advanced
    ``steps`` steps on the first slot of ``devices`` (default: the
    visible devices of ``device``) and on an ``n_devices`` near-square
    mesh of them, same mode and halo route. The one-slot baseline is the
    collective program for every route, as in the JAX package (on one
    slot there is no exchange to overlap, so a route-specific baseline
    would let a route raise its ratio by being slower at n = 1). Returns
    the ``kind="multichip"`` payload, with the halo route and tier
    resolved against the program that runs (in hybrid mode the kernel
    route: H12 for collective, H14 for fused)."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.parallel.mesh import make_mesh, visible_devices
    from heat2d_tpu_torch.parallel.sharded import resolve_halo_route

    devices = list(devices if devices is not None
                   else visible_devices(device))
    n = n_devices or len(devices)
    if len(devices) < n:
        raise ValueError(f"strong scaling at n={n} needs {n} devices; "
                         f"have {len(devices)}")
    gx, gy = square_mesh(n)
    base = dict(nxprob=nx, nyprob=ny, steps=steps, mode=mode,
                halo_depth=halo_depth)
    cfg1 = HeatConfig(gridx=1, gridy=1, halo="collective", **base)
    cfgn = HeatConfig(gridx=gx, gridy=gy, halo=halo, **base)
    route = resolve_halo_route(cfgn, make_mesh(gx, gy, devices[:n]),
                               kernel=mode == "hybrid")
    rate_1 = _rate(cfg1, devices[:1])
    rate_n = _rate(cfgn, devices[:n])
    eff = (rate_n / (n * rate_1)) if rate_1 > 0 else float("nan")
    return {
        "n_devices": n, "mesh": [gx, gy], "grid": [nx, ny],
        "steps": steps, "mode": mode,
        "halo": halo, "halo_route": route["route"],
        "halo_tier": route["tier"], "halo_depth": route["depth"],
        "mcells_per_s_1chip": rate_1,
        "mcells_per_s_nchip": rate_n,
        "per_chip_mcells_per_s_1chip": rate_1,
        "per_chip_mcells_per_s_nchip": rate_n / n,
        "strong_scaling_efficiency": eff,
    }


def scaling_record(payloads: list, out_path: str | None = None,
                   device=None) -> dict:
    """The scaling payloads in the run-record envelope
    (``kind="multichip"``), written as JSON to ``out_path`` if given."""
    from heat2d_tpu_torch.obs.record import build_record

    rec = build_record("multichip", extra={"scaling": payloads},
                       device=device)
    if out_path:
        from heat2d_tpu_torch.io.binary import write_json_atomic
        write_json_atomic(rec, out_path, sort_keys=True)
    return rec
