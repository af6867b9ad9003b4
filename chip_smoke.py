#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``heat2d_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. toolchain: torch, CUDA, nvcc and driver versions, the card's name and
   power limit;
2. build: every ``heat2d_tpu_torch/csrc/*.cu`` with nvcc, in parallel;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at ragged and full sizes (literal form bitwise, FMA form
   within ``n * 2**-21 * max|plain|`` after n steps): H1-H4 on single
   grids, H5-H7 on batches of B in {1, 3, 8} members with heterogeneous
   (cx, cy), H7 with a mixed ``active`` vector (frozen members bitwise
   unchanged, their residual exactly 0);
4. main path: ``Heat2DSolver`` in mode ``pallas`` against mode ``serial``
   on the card: 4096^2 x 240 steps fixed, the same with convergence
   (interval 20) in both step forms, and 640x1024x10000 on the resident
   route; launch counters, zeroed just before, show H1-H4 ran;
5. serving path: an in-process ``SolveServer`` on the card (max_batch 8)
   answers (a) 8 requests of 640x1024 x 10000 steps (one launch of
   capacity 8 through H5), (b) 4 of 4096^2 x 240 steps (one launch
   through H6), (c) 4 convergence requests at 4096^2, interval 20, with a
   sensitivity picked from the members' chunk-1 residuals so that they
   exit at different chunks (H7), (d) a cache-hit repeat and two
   coalesced duplicates; each result against the port's ``jnp`` route on
   the card (equal ``steps_done``, grids within tolerance), fewer
   launches than requests, and the launch counters, zeroed just before,
   show H5-H7 ran;
6. the ``kernels`` line: time, bound, plain and library times of each
   kernel at its path's shapes;
7. headline: Mcells/s at 4096^2 by the two-point protocol of bench.py.

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

STENCIL_SOURCE = "heat2d_tpu_torch/csrc/stencil.cu"
ENSEMBLE_SOURCE = "heat2d_tpu_torch/csrc/ensemble.cu"
REPLACES = {
    "step": "heat2d_tpu/ops/pallas_stencil.py:509",
    "tile_multi": "heat2d_tpu/ops/pallas_stencil.py:993",
    "tile_multi_resid": "heat2d_tpu/ops/pallas_stencil.py:1064",
    "resident": "heat2d_tpu/ops/pallas_stencil.py:275",
    "ens_resident": "heat2d_tpu/models/ensemble.py:106",
    "ens_tile_multi": "heat2d_tpu/models/ensemble.py:243",
    "ens_tile_multi_conv": "heat2d_tpu/models/ensemble.py:357",
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
    from heat2d_tpu_torch.ops import _build, cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    t0 = time.perf_counter()
    libs = _build.build_all()
    caps = cs.device_caps("cuda")
    info = {"phase": "build", "seconds": time.perf_counter() - t0,
            "libraries": [str(p.name) for p in libs],
            "caps": caps._asdict(),
            "ens_resident_blocks": ce.resident_blocks("cuda")}
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


def phase_ensemble_kernels(torch) -> dict:
    """H5-H7 against their plain versions on the same batches: ragged
    members, B in {1, 3, 8}, heterogeneous (cx, cy) inside the stability
    box, nsub in {1, 5, 8}; H7 with every other member frozen."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    g = torch.Generator(device="cuda")
    g.manual_seed(1613)
    worst = {k: 0.0 for k in ce.LAUNCHES}
    checks = 0

    def judge(name, got, ref, n, what):
        nonlocal checks
        err = max_err(got, ref)
        worst[name] = max(worst[name], err)
        tol = fma_tol(n, ref)
        fail_unless(err <= tol, f"{name} {what}: max_abs_err {err} > {tol}")
        checks += 1

    for shape in [(37, 53), (4099, 4097)]:
        for b in (1, 3, 8):
            u = torch.rand((b,) + shape, generator=g, device="cuda")
            cxs = torch.rand(b, generator=g, device="cuda") * 0.24 + 0.01
            cys = torch.rand(b, generator=g, device="cuda") * 0.24 + 0.01
            active = torch.tensor([i % 2 for i in range(b)],
                                  dtype=torch.int32, device="cuda")
            frozen = active == 0
            for nsub in (1, 5, 8):
                what = f"B={b} {shape} nsub={nsub}"
                ref = ce.ens_multi_step_plain(u, nsub, cxs, cys)
                judge("ens_resident", ce.ens_resident(u, nsub, cxs, cys),
                      ref, nsub, what)
                judge("ens_tile_multi", ce.ens_tile_multi(u, nsub, cxs, cys),
                      ref, nsub, what)
                got, r = ce.ens_tile_multi_conv(u, nsub, cxs, cys, active,
                                                resid=True)
                ref, r_ref = ce.ens_conv_sweep_plain(u, nsub, cxs, cys,
                                                     active, True)
                judge("ens_tile_multi_conv", got, ref, nsub, what)
                fail_unless(torch.equal(got[frozen], u[frozen]),
                            f"H7 {what}: a frozen member changed")
                fail_unless(bool((r[frozen] == 0).all()),
                            f"H7 {what}: a frozen member's residual != 0")
                # per-tile partials summed in another order than
                # torch.sum: a relative tolerance
                on = ~frozen
                rerr = float(((r - r_ref).abs() / r_ref.abs())[on].max()) \
                    if bool(on.any()) else 0.0
                fail_unless(rerr <= 1e-4,
                            f"H7 residual {what}: relative error {rerr}")
                got = ce.ens_tile_multi_conv(u, nsub, cxs, cys, active)
                judge("ens_tile_multi_conv", got, ref, nsub, what)
    torch.cuda.synchronize()
    info = {"phase": "ensemble_kernels", "checks": checks,
            "max_abs_err": worst}
    emit(info)
    return info


def pick_sensitivity(torch, nx, ny, cxs, cys, interval):
    """A sensitivity between the members' chunk-1 residuals, read from
    the plain versions on the card: the FMA form the H7 route steps and
    the literal form of the jnp route it is checked against. The split
    with the widest gap is taken, at its geometric middle, so that every
    member lies a factor >= 2 away from it in both forms."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.ops.stencil import stencil_step
    cx = torch.tensor(cxs, dtype=torch.float32, device="cuda")
    cy = torch.tensor(cys, dtype=torch.float32, device="cuda")
    cx, cy = cx.reshape(-1, 1, 1), cy.reshape(-1, 1, 1)
    u0 = inidat(nx, ny, device="cuda").expand(len(cxs), nx, ny).contiguous()
    res = []
    for step in (cs.step_plain, stencil_step):
        prev = u0
        for _ in range(interval - 1):
            prev = step(prev, cx, cy)
        res.append(ce.member_residuals(step(prev, cx, cy), prev).tolist())
    lo = [min(a, b) for a, b in zip(*res)]
    hi = [max(a, b) for a, b in zip(*res)]
    order = sorted(range(len(cxs)), key=lambda i: hi[i])
    best = None
    for k in range(1, len(order)):
        below = max(hi[i] for i in order[:k])
        above = min(lo[i] for i in order[k:])
        if above > below and (best is None
                              or above / below > best[1] / best[0]):
            best = (below, above)
    fail_unless(best is not None and best[1] >= 4 * best[0],
                f"no sensitivity separates the members' chunk-1 "
                f"residuals {res}")
    return math.sqrt(best[0] * best[1]), res


def phase_serve(torch) -> dict:
    """The serving path at full width, through ``SolveServer`` and its
    ``Client`` on the card, each result checked against the port's jnp
    route on the card."""
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.serve.schema import SolveRequest
    from heat2d_tpu_torch.serve.server import Client, SolveServer

    big = 4096
    conv_c = [0.03125, 0.0625, 0.125, 0.2]
    sens, chunk1 = pick_sensitivity(torch, big, big, conv_c, conv_c, 20)
    legs = {
        "a": [SolveRequest(nx=640, ny=1024, steps=10000,
                           cx=0.02 + 0.02 * i, cy=0.2 - 0.02 * i)
              for i in range(8)],
        "b": [SolveRequest(nx=big, ny=big, steps=240, cx=0.05 * (i + 1),
                           cy=0.2 - 0.04 * i) for i in range(4)],
        "c": [SolveRequest(nx=big, ny=big, steps=240, cx=c, cy=c,
                           convergence=True, interval=20,
                           sensitivity=sens) for c in conv_c],
    }
    registry = MetricsRegistry()
    server = SolveServer(max_batch=8, max_delay=0.5, registry=registry,
                         default_timeout=600.0)
    client = Client(server)
    answers, seconds = {}, {}
    ce.reset_launch_counts()
    with server:
        for name, reqs in legs.items():
            t0 = time.perf_counter()
            futs = [client.submit(r) for r in reqs]
            answers[name] = [f.result(timeout=900) for f in futs]
            seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hit = client.solve(legs["a"][0])
        dup = SolveRequest(nx=640, ny=1024, steps=10000, cx=0.11, cy=0.13)
        pair = [client.submit(dup), client.submit(dup)]
        pair = [f.result(timeout=900) for f in pair]
        seconds["d"] = time.perf_counter() - t0
    counts = ce.launch_counts()
    requests = sum(len(r) for r in legs.values()) + 3
    launches = server.engine.launches

    fail_unless(hit.cache_hit and hit.u.tobytes()
                == answers["a"][0].u.tobytes(),
                "leg d: the repeat was not a bitwise cache hit")
    fail_unless(pair[1].coalesced and pair[0].u.tobytes()
                == pair[1].u.tobytes(),
                "leg d: the duplicates were not coalesced bitwise")
    answers["d"] = pair[:1]
    legs["d"] = [dup]
    checked = {}
    for name, reqs in legs.items():
        r0 = reqs[0]
        cxs, cys = [r.cx for r in reqs], [r.cy for r in reqs]
        if r0.convergence:
            ref, k = ensemble.run_ensemble_convergence(
                r0.nx, r0.ny, r0.steps, r0.interval, r0.sensitivity, cxs,
                cys, method="jnp")
            k = k.tolist()
        else:
            ref = ensemble.run_ensemble(r0.nx, r0.ny, r0.steps, cxs, cys,
                                        method="jnp")
            k = [r0.steps] * len(reqs)
        got = [a.steps_done for a in answers[name]]
        fail_unless(got == k, f"leg {name}: steps_done {got} vs jnp {k}")
        errs = []
        for m, a in enumerate(answers[name]):
            u = torch.from_numpy(a.u)
            fail_unless(bool(torch.isfinite(u).all()),
                        f"leg {name}: non-finite values")
            want = ref[m].cpu()
            err, tol = max_err(u, want), fma_tol(k[m], want)
            fail_unless(err <= tol, f"leg {name} member {m}: max_abs_err "
                        f"{err} > {tol}")
            errs.append(err)
        checked[name] = {"steps_done": got, "max_abs_err": max(errs)}
    fail_unless(len(set(checked["c"]["steps_done"])) >= 2,
                f"leg c: members did not exit at different chunks "
                f"{checked['c']['steps_done']}")
    fail_unless(launches < requests,
                f"{launches} launches for {requests} requests")
    for name, n in counts.items():
        fail_unless(n > 0, f"kernel {name} never launched on the serving "
                    f"path")
    methods = [row["method"] for row in server.engine.launch_log]
    fail_unless(methods == ["pallas", "band", "band", "pallas"],
                f"serving routes {methods}")
    snap = registry.snapshot()
    info = {"phase": "serve", "requests": requests, "launches": launches,
            "launch_counts": counts, "sensitivity": sens,
            "chunk1_residuals": {"fma": chunk1[0], "literal": chunk1[1]},
            "legs": checked, "leg_seconds": seconds,
            "launch_log": [dict(row, signature=str(row["signature"]))
                           for row in server.engine.launch_log],
            "queue_wait_s": snap["histograms"].get("serve_queue_wait_s"),
            "e2e_latency_s": snap["histograms"].get("serve_e2e_latency_s")}
    emit({k: info[k] for k in ("phase", "requests", "launches",
                               "launch_counts", "sensitivity", "legs")})
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
    """Each kernel timed at its path's shapes, beside its bound, its
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

    rows += ensemble_kernel_rows(torch)
    for r in rows:
        r.update(route="cuda",
                 source=(ENSEMBLE_SOURCE if r["name"].startswith("ens_")
                         else STENCIL_SOURCE),
                 replaces=REPLACES[r["name"]],
                 launches=launches[r["name"]],
                 max_abs_err=worst[r["name"]])
    return rows


def ensemble_kernel_rows(torch) -> list:
    """H5-H7 timed at the serving path's shapes (bounds times the B
    members; no single PyTorch call advances T steps, so no library
    time)."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.init import inidat

    rows = []
    # H5: leg (a), 8 members of 640x1024 x 10000 steps in one launch.
    b, n = 8, 10000
    u = inidat(640, 1024, device="cuda").expand(b, 640, 1024).contiguous()
    cxs = torch.linspace(0.02, 0.16, b, device="cuda")
    cys = torch.linspace(0.2, 0.06, b, device="cuda")
    bnd, by = bound_ms(2 * u.numel() * 4, FLOPS_PER_CELL_STEP * u.numel() * n)
    rows.append(dict(
        name="ens_resident",
        ms=time_ms(lambda: ce.ens_resident(u, n, cxs, cys), 3),
        plain_ms=time_ms(lambda: ce.ens_multi_step_plain(u, n, cxs, cys),
                         1),
        bound_ms=bnd, bound_by=by, library_ms=None))

    # H6 / H7: legs (b) and (c), 4 members of 4096^2, one T = 8 sweep
    # (H7 with every member active and its residual).
    b, t = 4, cs.DEFAULT_TSTEPS
    u = inidat(4096, 4096, device="cuda").expand(b, 4096, 4096).contiguous()
    cxs = torch.tensor([0.05, 0.1, 0.15, 0.2], device="cuda")
    cys = torch.tensor([0.2, 0.16, 0.12, 0.08], device="cuda")
    act = torch.ones(b, dtype=torch.int32, device="cuda")
    cells = u.numel()
    bnd, by = bound_ms(2 * cells * 4, FLOPS_PER_CELL_STEP * cells * t)
    rows.append(dict(
        name="ens_tile_multi",
        ms=time_ms(lambda: ce.ens_tile_multi(u, t, cxs, cys), 20),
        plain_ms=time_ms(lambda: ce.ens_multi_step_plain(u, t, cxs, cys),
                         5),
        bound_ms=bnd, bound_by=by, library_ms=None))
    ntiles = cs.plan_tiles(4096, 4096, t, cs.smem_limit("cuda")).ntiles
    bnd, by = bound_ms(2 * cells * 4 + 4 * b * ntiles,
                       FLOPS_PER_CELL_STEP * cells * t + 3 * cells)
    rows.append(dict(
        name="ens_tile_multi_conv",
        ms=time_ms(lambda: ce.ens_tile_multi_conv(u, t, cxs, cys, act,
                                                  resid=True), 20),
        plain_ms=time_ms(lambda: ce.ens_conv_sweep_plain(
            u, t, cxs, cys, act, True), 5),
        bound_ms=bnd, bound_by=by, library_ms=None))
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
        ens_kern = phase_ensemble_kernels(torch)
        main_path = phase_main_path(torch)
        serve = phase_serve(torch)
        rows = phase_kernel_times(
            torch, {**main_path["launches"], **serve["launch_counts"]},
            {**kern["max_abs_err"], **ens_kern["max_abs_err"]})
        head = phase_headline(torch, tool["name"], tool["power_limit"])
        for r in rows:
            fail_unless(all(math.isfinite(r[k]) for k in
                            ("ms", "plain_ms", "bound_ms")),
                        f"non-finite time in {r}")
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    write_results({"toolchain": tool, "build": build, "kernels_check": kern,
                   "ensemble_kernels_check": ens_kern,
                   "main_path": main_path, "serve": serve, "kernels": rows,
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
