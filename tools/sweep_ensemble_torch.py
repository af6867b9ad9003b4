"""Ensemble batching efficiency on the port: Report.pdf Tables 4-6's
parameter studies as one launch, on the H100.

The counterpart of ``benchmarks/sweep_ensemble.py``. The reference runs
one (cx, cy) configuration per launch; the port's ensembles batch B of
them. This sweep measures what batching buys: eff = B x t_single /
t_batch, from two-point per-step marginals (``tune.measure.
two_point_estimate``, the fence's fixed cost cancelled), for

- a resident class, 640x512 on route pallas (H5 ``ens_resident``: every
  step of every member in one cooperative launch), and
- a streamed class, 2560x2048 on route band (H6 ``ens_tile_multi``
  sweeps; with convergence H7 ``ens_tile_multi_conv``),

fixed-step and with convergence at sensitivity 0 (the residual is
checked every ``INTERVAL`` steps and never fires, so every member runs
the whole budget: this measures the batched convergence machinery, not
early exit). The JAX sweep's window-against-legacy route delta has no
counterpart: the port has one band route.

``--scale`` multiplies every span (1 by default: windows of ~1 s at the
batched points; ``chip_smoke.py`` runs 0.2). A point whose window stays
inside the fence's noise is recorded with no marginal. Rows print as
JSON lines and go with a markdown table, beside the card's name and
power limit, to ``--out`` (default ``chiprun_out/sweeps``).

    python3 tools/sweep_ensemble_torch.py
    python3 tools/sweep_ensemble_torch.py --scale 0.2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from heat2d_tpu_torch.tune.measure import two_point_estimate  # noqa: E402

INTERVAL = 20

#: (label, nx, ny, route, B, {convergence: ((lo, hi) single, (lo, hi)
#: batched)}): spans sized for ~1 s at hi on the H100 (H5 at 640x512 ~1.3
#: us a step alone, ~21 us with convergence: one host read a chunk of
#: INTERVAL steps; H6 at 2560x2048 ~9 us alone, H7 ~17 us)
CLASSES = [
    ("resident 640x512", 640, 512, "pallas", 8,
     {False: ((200_000, 1_000_000), (50_000, 250_000)),
      True: ((10_000, 50_000), (10_000, 50_000))}),
    ("band 2560x2048", 2560, 2048, "band", 4,
     {False: ((30_000, 150_000), (6_000, 30_000)),
      True: ((10_000, 50_000), (6_000, 30_000))}),
]


def _batch(nx, ny, b, device):
    import torch

    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    cxs = torch.tensor([0.05 + 0.1 * i / max(b - 1, 1) for i in range(b)],
                       dtype=torch.float32, device=dev)
    cys = torch.full((b,), 0.1, dtype=torch.float32, device=dev)
    u0 = inidat(nx, ny, device=dev).expand(b, nx, ny).contiguous()
    return u0, cxs, cys


class _Timed:
    def __init__(self, elapsed):
        self.elapsed = elapsed


def marginal(nx, ny, b, route, conv, lo, hi, device=None):
    """The two-point per-step marginal of a B-member launch on ``route``
    (None when the window stays inside the fence's noise)."""
    from heat2d_tpu_torch.models.ensemble import batch_runner
    from heat2d_tpu_torch.utils.timing import timed_call
    u0, cxs, cys = _batch(nx, ny, b, device)
    warm = set()

    def timed_run(steps):
        fn = batch_runner(nx, ny, steps, route, convergence=conv,
                          interval=INTERVAL, sensitivity=0.0,
                          device=str(u0.device))
        fresh = steps not in warm
        warm.add(steps)
        _, el = timed_call(fn, u0, cxs, cys, warmup=fresh)
        return _Timed(el)

    step, _, _ = two_point_estimate(timed_run, lo, hi, hi)
    return step


def sweep(scale: float = 1.0, device=None, classes=CLASSES) -> list:
    rows = []
    for label, nx, ny, route, b, spans in classes:
        for conv in (False, True):
            s1, sb = (tuple(max(1, int(x * scale)) for x in span)
                      for span in spans[conv])
            t1 = marginal(nx, ny, 1, route, conv, *s1, device=device)
            tb = marginal(nx, ny, b, route, conv, *sb, device=device)
            cells = nx * ny
            row = {"class": label, "route": route, "convergence": conv,
                   "B": b, "single_span": s1, "batch_span": sb,
                   "single_step_s": t1, "batch_step_s": tb,
                   "single_mcells": cells / t1 / 1e6 if t1 else None,
                   "batch_mcells_per_member":
                       cells / (tb / b) / 1e6 if tb else None,
                   "batching_efficiency": b * t1 / tb if t1 and tb
                   else None}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def to_markdown(rows, platform, card) -> str:
    md = [
        f"# Ensemble batching efficiency ({platform}; {card})", "",
        "Report.pdf Tables 4-6's parameter studies ran one (cx, cy) a "
        "launch; the port's ensembles batch B of them. eff = B x t_single "
        "/ t_batch (two-point per-step marginals; convergence at "
        f"sensitivity 0 runs the whole budget, INTERVAL={INTERVAL}).", "",
        "| class | conv | B | single (s/step) | batch (s/step) "
        "| per-member Mcells/s | efficiency |",
        "|---|---|---|---|---|---|---|",
    ]

    def f(x, spec):
        return "within noise" if x is None else format(x, spec)
    for r in rows:
        md.append(
            f"| {r['class']} ({r['route']}) "
            f"| {'yes' if r['convergence'] else 'no'} | {r['B']} "
            f"| {f(r['single_step_s'], '.4e')} "
            f"| {f(r['batch_step_s'], '.4e')} "
            f"| {f(r['batch_mcells_per_member'], ',.0f')} "
            f"| {f(r['batching_efficiency'], '.3f')} |")
    return "\n".join(md) + "\n"


def main(argv=None) -> int:
    from tools.sweep_torch import card_line, platform_of, write_atomic
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scale", type=float, default=1.0,
                   help="multiply every two-point span")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "sweeps"))
    args = p.parse_args(argv)
    platform, is_cpu = platform_of(args.device)
    card = "cpu" if is_cpu else card_line()
    rows = sweep(args.scale, args.device)
    os.makedirs(args.out, exist_ok=True)
    write_atomic(os.path.join(args.out, "sweep_ensemble.jsonl"),
                 "".join(json.dumps({**r, "card": card}) + "\n"
                         for r in rows))
    md = to_markdown(rows, platform, card)
    write_atomic(os.path.join(args.out, "sweep_ensemble.md"), md)
    print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
