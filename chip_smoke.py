#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``heat2d_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. toolchain: torch, CUDA, nvcc and driver versions, the card's name and
   power limit;
2. build: every ``heat2d_tpu_torch/csrc/*.cu`` with nvcc, in parallel;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at ragged and full sizes (literal form bitwise, FMA form
   within ``n * 2**-21 * max|plain|`` after n steps);
4. main path: ``Heat2DSolver`` in mode ``pallas`` against mode ``serial``
   on the card: 4096^2 x 240 steps fixed, the same with convergence
   (interval 20) in both step forms, and 640x1024x10000 on the resident
   route; launch counters, zeroed just before, show every kernel ran;
5. the ``kernels`` line: time, bound, plain and library times of each
   kernel at the main path's shapes;
6. headline: Mcells/s at 4096^2 by the two-point protocol of bench.py.

The last line of standard output is ``{"ok": true, "device": ...}``. The
full results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: The card's published peaks (H100 SXM at 700 W): device memory bytes/s
#: and float32 FLOP/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: FLOPs of one FMA-form cell update: a multiply, two adds, two FMAs.
FLOPS_PER_CELL_STEP = 7

SOURCE = "heat2d_tpu_torch/csrc/stencil.cu"
REPLACES = {
    "step": "heat2d_tpu/ops/pallas_stencil.py:509",
    "tile_multi": "heat2d_tpu/ops/pallas_stencil.py:993",
    "tile_multi_resid": "heat2d_tpu/ops/pallas_stencil.py:1064",
    "resident": "heat2d_tpu/ops/pallas_stencil.py:275",
}


class SmokeFailure(RuntimeError):
    pass


def fail_unless(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader``."""
    from heat2d_tpu_torch.utils.device import nvidia_smi_query
    out = nvidia_smi_query(fields)
    fail_unless(out is not None, f"nvidia-smi could not read {fields}")
    return out


# ------------------------------------------------------------------ #
# helpers
# ------------------------------------------------------------------ #

def fma_tol(n: int, ref) -> float:
    """FMA-form tolerance after n steps: the kernel contracts each update
    into FMAs where the plain version rounds every operation, at most a
    couple of ulp per step."""
    return max(1, n) * 2.0 ** -21 * float(ref.abs().max())


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after one warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ #
# phases
# ------------------------------------------------------------------ #

def phase_toolchain(torch) -> dict:
    from heat2d_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    info = {"phase": "toolchain", "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc, "driver": smi("driver_version"),
            "name": torch.cuda.get_device_name(0),
            "power_limit": smi("power.limit"),
            "device_count": torch.cuda.device_count()}
    emit(info)
    return info


def phase_build() -> dict:
    from heat2d_tpu_torch.ops import _build, cuda_stencil as cs
    t0 = time.perf_counter()
    libs = _build.build_all()
    caps = cs.device_caps("cuda")
    info = {"phase": "build", "seconds": time.perf_counter() - t0,
            "libraries": [str(p.name) for p in libs],
            "caps": caps._asdict()}
    emit(info)
    return info


def phase_kernels(torch) -> dict:
    """Every kernel against its plain version on the same inputs."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    g = torch.Generator(device="cuda")
    g.manual_seed(1612)
    shapes = [(4099, 4097), (4096, 4096), (640, 1024), (37, 53), (10, 10)]
    forms = (cs.FORM_FMA, cs.FORM_LITERAL)
    cx, cy = 0.1, 0.1
    worst = {k: 0.0 for k in cs.LAUNCHES}
    checks = 0

    def judge(name, got, ref, n, form, what):
        nonlocal checks
        err = max_err(got, ref)
        worst[name] = max(worst[name], err)
        tol = 0.0 if form == cs.FORM_LITERAL else fma_tol(n, ref)
        fail_unless(err <= tol, f"{name} {what}: max_abs_err {err} > {tol}")
        checks += 1

    for shape in shapes:
        u = torch.rand(shape, generator=g, device="cuda")
        for form in forms:
            judge("step", cs.step(u, cx, cy, form),
                  cs.step_plain(u, cx, cy, form), 1, form,
                  f"{shape} form {form}")
            for t, nsub in [(1, 1), (3, 3), (3, 2), (8, 8), (8, 5), (8, 1)]:
                judge("tile_multi", cs.tile_multi(u, nsub, cx, cy, form, t),
                      cs.multi_step_plain(u, nsub, cx, cy, form), nsub, form,
                      f"{shape} T={t} nsub={nsub} form {form}")
            for t, nsub in [(1, 1), (3, 2), (8, 8), (8, 3)]:
                got, r = cs.tile_multi_resid(u, nsub, cx, cy, form, t)
                ref, r_ref = cs.tile_multi_resid_plain(u, nsub, cx, cy, form)
                what = f"{shape} T={t} nsub={nsub} form {form}"
                judge("tile_multi_resid", got, ref, nsub, form, what)
                # Per-tile partials summed in another order than
                # torch.sum: a relative tolerance, tighter for the
                # literal form whose deltas are bitwise equal.
                rtol = 1e-5 if form == cs.FORM_LITERAL else 1e-4
                rerr = abs(float(r) - float(r_ref))
                fail_unless(rerr <= rtol * abs(float(r_ref)),
                            f"tile_multi_resid residual {what}: "
                            f"{float(r)} vs {float(r_ref)}")
    for shape in [(10, 10), (37, 53), (256, 256), (640, 1024)]:
        u = torch.rand(shape, generator=g, device="cuda")
        for form in forms:
            for n in (1, 2, 7, 100):
                judge("resident", cs.resident(u, n, cx, cy, form),
                      cs.multi_step_plain(u, n, cx, cy, form), n, form,
                      f"{shape} n={n} form {form}")
    torch.cuda.synchronize()
    info = {"phase": "kernels", "checks": checks, "max_abs_err": worst}
    emit(info)
    return info


def phase_main_path(torch) -> dict:
    """The port's main path through its entry points, against the serial
    golden model on the card."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    from heat2d_tpu_torch.ops import cuda_stencil as cs

    def both(cfg):
        got = Heat2DSolver(cfg).run()
        want = Heat2DSolver(cfg.replace(mode="serial")).run(timed=False)
        u = torch.from_numpy(got.u)
        fail_unless(bool(torch.isfinite(u).all()), f"{cfg}: non-finite")
        fail_unless(tuple(u.shape) == cfg.shape, f"{cfg}: shape {u.shape}")
        fail_unless(float(u[0].abs().max()) == 0.0
                    and float(u[:, -1].abs().max()) == 0.0,
                    f"{cfg}: boundary not held")
        fail_unless(got.steps_done == want.steps_done,
                    f"{cfg}: steps_done {got.steps_done} vs "
                    f"{want.steps_done}")
        ref = torch.from_numpy(want.u)
        err = max_err(u, ref)
        tol = 0.0 if cfg.bitwise_parity else fma_tol(got.steps_done, ref)
        fail_unless(err <= tol, f"{cfg}: max_abs_err {err} > {tol}")
        return {"shape": list(cfg.shape), "steps": cfg.steps,
                "convergence": cfg.convergence,
                "bitwise_parity": cfg.bitwise_parity, "route": got.route,
                "steps_done": got.steps_done, "max_abs_err": err,
                "tol": tol, "elapsed_s": got.elapsed,
                "warmup_s": got.warmup_s, "mcells_per_s": got.mcells_per_s,
                "residual_reads": got.residual_reads}

    big = HeatConfig(nxprob=4096, nyprob=4096, steps=240, mode="pallas")
    cfgs = [big,
            big.replace(convergence=True, interval=20),
            big.replace(convergence=True, interval=20, bitwise_parity=True),
            HeatConfig(nxprob=640, nyprob=1024, steps=10000, mode="pallas")]
    cs.reset_launch_counts()
    runs = []
    for cfg in cfgs:
        runs.append(both(cfg))
        emit({"phase": "main_path_run", **runs[-1]})
    counts = cs.launch_counts()
    for name, n in counts.items():
        fail_unless(n > 0, f"kernel {name} never launched on the main path")
    routes = [r["route"] for r in runs]
    fail_unless(routes == ["streamed", "streamed-fused", "streamed",
                           "resident"], f"routes {routes}")
    info = {"phase": "main_path", "launches": counts}
    emit(info)
    return {"runs": runs, "launches": counts}


def phase_kernel_times(torch, launches: dict, worst: dict) -> list:
    """Each kernel timed at the main path's shapes, beside its bound, its
    plain version and, where one PyTorch call computes the same function,
    that call (timed only here; the port never calls it)."""
    import torch.nn.functional as F
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.init import inidat

    cx, cy = 0.1, 0.1
    big = inidat(4096, 4096, device="cuda")
    cells = big.numel()
    plane = cells * 4
    rows = []

    # H1: one step at 4096^2. Library: a 3x3 convolution, TF32 off.
    torch.backends.cudnn.allow_tf32 = False
    k0 = 1.0 - 2.0 * cx - 2.0 * cy
    w = torch.tensor([[0.0, cx, 0.0], [cy, k0, cy], [0.0, cx, 0.0]],
                     device="cuda").reshape(1, 1, 3, 3)
    x4 = big.reshape(1, 1, *big.shape)
    b, by = bound_ms(2 * plane, FLOPS_PER_CELL_STEP * cells)
    rows.append(dict(
        name="step", ms=time_ms(lambda: cs.step(big, cx, cy), 50),
        plain_ms=time_ms(lambda: cs.step_plain(big, cx, cy), 20),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: F.conv2d(x4, w, padding=1), 50)))

    # H2 / H3: one T = 8 sweep at 4096^2 (8 steps).
    t = cs.DEFAULT_TSTEPS
    b, by = bound_ms(2 * plane, FLOPS_PER_CELL_STEP * cells * t)
    rows.append(dict(
        name="tile_multi",
        ms=time_ms(lambda: cs.tile_multi(big, t, cx, cy), 20),
        plain_ms=time_ms(lambda: cs.multi_step_plain(big, t, cx, cy), 5),
        bound_ms=b, bound_by=by, library_ms=None))
    ntiles = cs.plan_tiles(4096, 4096, t, cs.smem_limit("cuda")).ntiles
    b, by = bound_ms(2 * plane + 4 * ntiles,
                     FLOPS_PER_CELL_STEP * cells * t + 3 * cells)
    rows.append(dict(
        name="tile_multi_resid",
        ms=time_ms(lambda: cs.tile_multi_resid(big, t, cx, cy), 20),
        plain_ms=time_ms(lambda: cs.tile_multi_resid_plain(big, t, cx, cy),
                         5),
        bound_ms=b, bound_by=by, library_ms=None))

    # H4: 640x1024 x 10000 steps in one launch.
    small = inidat(640, 1024, device="cuda")
    n = 10000
    b, by = bound_ms(2 * small.numel() * 4,
                     FLOPS_PER_CELL_STEP * small.numel() * n)
    rows.append(dict(
        name="resident", ms=time_ms(lambda: cs.resident(small, n, cx, cy), 3),
        plain_ms=time_ms(lambda: cs.multi_step_plain(small, n, cx, cy), 1),
        bound_ms=b, bound_by=by, library_ms=None))

    for r in rows:
        r.update(route="cuda", source=SOURCE, replaces=REPLACES[r["name"]],
                 launches=launches[r["name"]],
                 max_abs_err=worst[r["name"]])
    return rows


def phase_headline(torch, name: str, power: str) -> dict:
    """Mcells/s at 4096^2, pallas mode: the marginal step time between
    two step counts (fixed fence and launch overheads cancel), min of 3
    runs at the low count and of 2 at the high one, as in bench.py."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    lo, hi = 480, 4800
    solvers = {n: Heat2DSolver(HeatConfig(nxprob=4096, nyprob=4096, steps=n,
                                          mode="pallas"))
               for n in (lo, hi)}

    def t(n, warm):
        return solvers[n].run(warmup=warm).elapsed

    t_lo = min([t(lo, True)] + [t(lo, False) for _ in range(2)])
    t_hi = min([t(hi, True)] + [t(hi, False)])
    step_s = (t_hi - t_lo) / (hi - lo)
    fail_unless(step_s > 0, f"two-point step time {step_s} <= 0")
    info = {"phase": "headline",
            "metric": f"Mcells/s 4096x4096 (pallas, two-point {lo}/{hi})",
            "value": 4096 * 4096 / step_s / 1e6, "step_ms": step_s * 1e3,
            "t_lo_s": t_lo, "t_hi_s": t_hi, "device": name,
            "power_limit": power}
    emit(info)
    return info


def write_results(results: dict) -> None:
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "chip_smoke.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "heat2d_tpu_torch")):
        print("chip_smoke.py: the heat2d_tpu_torch package is not beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    try:
        t0 = time.perf_counter()
        tool = phase_toolchain(torch)
        build = phase_build()
        kern = phase_kernels(torch)
        main_path = phase_main_path(torch)
        rows = phase_kernel_times(torch, main_path["launches"],
                                  kern["max_abs_err"])
        head = phase_headline(torch, tool["name"], tool["power_limit"])
        for r in rows:
            fail_unless(all(math.isfinite(r[k]) for k in
                            ("ms", "plain_ms", "bound_ms")),
                        f"non-finite time in {r}")
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    write_results({"toolchain": tool, "build": build, "kernels_check": kern,
                   "main_path": main_path, "kernels": rows,
                   "headline": head,
                   "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    print(smi("name,power.limit"))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
