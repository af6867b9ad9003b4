"""The port's headline benchmark: prints bench.py's ONE JSON line for the
PyTorch/CUDA package (``heat2d_tpu_torch``).

    python bench_torch.py                    # on the card: 4096^2
    BENCH_QUICK=1 python bench_torch.py --device cpu

Metric: Mcell-updates/s on a 4096x4096 grid (1024x1024 with
``BENCH_QUICK=1``), mode ``pallas`` (``BENCH_MODE`` picks another), by
bench.py's two-point protocol: fixed-step runs at 4800 and 24000 steps
(20 and 100 when quick), 3 timed runs at the low count and 2 at the high
one, the first of each after a warmup, and the marginal step time
between them, so that the fixed fence and launch costs cancel; the
marginal is believed only past the noise floor and jitter rules of
``tune.measure.two_point_estimate``, else the line reports the high
run's end-to-end figure and says so. The timing code is
``models.solver.two_point_headline``, which ``chip_smoke.py``'s headline
phase calls too. ``vs_baseline`` is the ratio against the reference's
best published per-chip figure, its CUDA kernel at 2560x2048, 669
Mcells/s (``bench.py``'s ``BASELINE_MCELLS``). ``time_to_solution`` is
``models.solution.bench_tts``: explicit against ADI at 513^2 (257^2
when quick) to matched accuracy.

The roofline rows are bench.py's, from the port's ``obs/roofline``:
``bytes_per_cell_step`` and ``mcells_per_hbm_byte`` (the route's analytic
device-memory bytes a cell update, at the high step count), and, for mode
pallas's two-point marginal on a card with calibrated peaks,
``pct_of_calibrated_bound`` with its ``bound_source`` (the card's
published bandwidth and float32 rate).

Runs on the card unless ``--device cpu``; a number from the CPU is a
smoke of the command, not a measurement of the card.
"""

import argparse
import json
import os
import sys

QUICK = os.environ.get("BENCH_QUICK") == "1"
NX = NY = 1024 if QUICK else 4096
# bench.py's step counts: hi = STEPS, lo = STEPS // 5.
STEPS = 100 if QUICK else 24000
STEPS_LO = max(STEPS // 5, 1)
BASELINE_MCELLS = 669.0  # reference CUDA, 2560x2048 (BASELINE.md)


def build_record(value: float, method: str, elapsed: float, tts: dict,
                 mode: str, device) -> dict:
    """The one JSON line: bench.py's keys, the port's record envelope
    (schema, timestamp, the card's name and power limit)."""
    from heat2d_tpu_torch.obs.record import build_record as envelope
    rec = {
        "metric": f"Mcells/s/chip {NX}x{NY}x{STEPS} ({mode})",
        "value": round(value, 1),
        "unit": "Mcells/s",
        "vs_baseline": round(value / BASELINE_MCELLS, 2),
        "method": method,
        "end_to_end_s": round(elapsed, 4),
        "time_to_solution": tts,
    }
    return envelope("bench", extra=rec, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the CUDA card (default) or the CPU")
    args = p.parse_args(argv)
    from heat2d_tpu_torch.models.solution import bench_tts
    from heat2d_tpu_torch.models.solver import two_point_headline
    from heat2d_tpu_torch.utils.device import DeviceUnavailableError

    mode = os.environ.get("BENCH_MODE", "pallas")
    try:
        tp = two_point_headline(NX, NY, STEPS_LO, STEPS, mode=mode,
                                device=args.device)
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    # A time-to-solution failure degrades to an error string, never a
    # lost headline (bench.py's guard).
    try:
        tts = bench_tts(quick=QUICK, device=args.device)
    except Exception as e:  # noqa: BLE001 — record, don't lose bench
        tts = {"error": f"{type(e).__name__}: {e}"}
    result = tp["result"]
    # The physics must not be vacuous: the interior evolved, the
    # boundary held at zero.
    if not (float(result.u[1:-1, 1:-1].max()) > 0.0
            and float(abs(result.u[0]).max()) == 0.0):
        print("bench_torch.py: vacuous run (interior zero or boundary "
              "not held)", file=sys.stderr)
        return 1
    if tp["step_s"] is not None:
        value = NX * NY / tp["step_s"] / 1e6
        method = "two-point"
    else:
        # The two points lie within noise: the end-to-end figure of the
        # high run, said as such.
        value = result.mcells_per_s
        method = "single-run (two-point within noise)"
    rec = build_record(value, method, result.elapsed, tts, mode,
                       args.device)
    rec.update(roofline_rows(value, method, mode, args.device))
    print(json.dumps(rec))
    return 0


def roofline_rows(value: float, method: str, mode: str, device) -> dict:
    """bench.py's roofline rows (``obs/roofline``), guarded as bench.py
    guards them: a model gap never loses the headline."""
    from heat2d_tpu_torch.obs import roofline
    out = {}
    model_method = "serial" if mode == "serial" else "auto"
    try:
        m = roofline.analytic_bytes_per_cell_step(
            NX, NY, method=model_method, steps=STEPS, device=device)
        out["bytes_per_cell_step"] = round(m["bytes_per_cell_step"], 4)
        out["mcells_per_hbm_byte"] = round(
            1.0 / (1e6 * m["bytes_per_cell_step"]), 9)
    except Exception as e:  # noqa: BLE001 — record, don't lose bench
        out["bytes_per_cell_step"] = {"error": f"{type(e).__name__}: {e}"}
        return out
    bound = roofline.roofline_bound(
        NX, NY, method=model_method, steps=STEPS, device=device,
        device_kind=roofline.device_kind(device))
    if bound is not None and method == "two-point" and mode == "pallas":
        # only mode pallas's two-point marginal is comparable with the
        # bound: the single-run fallback is fence-dominated
        out["pct_of_calibrated_bound"] = round(
            100.0 * value / bound["bound_mcells_per_s"], 1)
        out["bound_source"] = (f"{bound['source']}, bound by "
                               f"{bound['bound_by']}")
    return out


if __name__ == "__main__":
    sys.exit(main())
