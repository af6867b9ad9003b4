#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``heat2d_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. toolchain: torch, CUDA, nvcc and driver versions, the card's name and
   power limit;
2. build: every ``heat2d_tpu_torch/csrc/*.cu`` with nvcc, in parallel;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at ragged and full sizes (literal form bitwise, FMA form
   within ``n * 2**-21 * max|plain|`` after n steps): H1-H3 on single
   grids (H2/H3 counting their tiles by path, which must equal the
   planner's), H4 up to the on-chip budget's edge (1900x1900) in both
   forms bit for bit against the H2 route and a wait that cannot end,
   H5-H7 on batches of B in {1, 3, 8} members with heterogeneous
   (cx, cy), H7 with a mixed ``active`` vector (frozen members bitwise
   unchanged, their residual exactly 0), H6/H7 counting their tiles by
   path (which must equal the planner's, both paths taken), H5's
   on-chip sweep bit for bit against the H6 route; H8/H9 for heat9, advdiff and
   reactdiff (B in {1, 3, 8}, 37x53 and 4099x4097, nsub in {1, 5, 8},
   within a per-family bound, ``family_tol``), and H9 bit for bit at the
   serving path's 4 x 4096^2 at the plan's depth; H10/H11 at B in {1, 3}
   on ragged shapes with diffusion numbers up to 51.2 (``td_tol``), H11
   bit for bit where it masks (rows and n not multiples of 32, n < 32),
   and both bit for bit on the hoisted coefficients (``td_coeffs``,
   itself bitwise against its plain version) at 1 and 4 members of
   4096^2;
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
6. implicit path: ``Heat2DSolver --mode pallas --method adi`` at 4096^2,
   cx = cy = 51.2, 20 fixed steps, and a convergence run at 1024^2 whose
   sensitivity is read from both routes' residuals so that they exit at
   the fifth check; each against ``--mode serial --method adi`` (equal
   ``steps_done``, ``adi_tol``); ``--method mg`` at 4097^2 x 4 steps,
   and on the separable mode against the exact Crank-Nicolson factor;
   H10 and H11 launched;
7. serving path of the families and the implicit methods: (e) per
   family 8 requests of 640x1024 x 10000 (H8) and 4 of 4096^2 x 240
   (H9), (f) 4 adi requests of 4096^2 x 20 (H10) and a bitwise cache
   hit, (g) 2 mg requests of 4097^2 x 4, (h) reactdiff x adi rejected as
   ``unsupported_combination``; each result against the jnp, scan or
   plain route on the card (the families bit for bit), and the mg
   results also against the exact Crank-Nicolson evolution;
8. time to solution at 513^2: explicit through H6 against ADI through
   H10/H11, matched accuracy against the analytic mode;
9. shard kernels: H12 and H13 on every shard of a 2x2 mesh of 4096^2
   (T = 8, nsub 8, 3 and 1), of 4 row strips of 4099x4096 and of 543x300
   (pad rows) and of a 2x2 mesh of 74x106, so that the strip sweep's
   fast and edge tiles both run, H14 on the same meshes, both step forms,
   against their plain versions (literal bitwise, FMA within ``fma_tol``)
   and H14 against H12 bit for bit; H12/H13 and H14 count their tiles by
   path, which must equal the planner's;
10. sharded path: ``Heat2DSolver`` on a 2x2 mesh of four 2048^2 shards on
   the one card (``host_devices(4)``), 4096^2 x 240 steps: dist2d,
   dist1d (4 strips) and hybrid ``bitwise_parity`` bitwise equal to
   serial, hybrid (FMA) within ``fma_tol``, hybrid ``--halo fused``
   bitwise equal to hybrid collective on the in-kernel tier (``ici``),
   hybrid convergence (interval 20, a sensitivity read from both routes'
   residuals) at serial's ``steps_done``; then the reference's largest
   grid, 2560x2048, in hybrid with its convergence defaults against
   serial; launch counters, zeroed just before, show H12-H14 ran;
11. sharded ensembles on 4 slots of the card (``host_devices(4)``): 8 x
   640x1024 x 10000 (H5 per slot), 4 x 4096^2 x 240 (H6 per slot) and a
   convergence run at 640x1024, interval 20, method band (H7 per slot),
   each bitwise the one-slot run (steps_done equal);
12. spatial ensembles: 2 x 4096^2 x 240 on a 2x2 submesh, collective and
   fused, each member bitwise the port's dist2d run of its (cx, cy);
13. mesh serving: ``SolveServer(engine=MeshEnsembleEngine(host_devices(4),
   fault=FaultPolicy(abft=True)), admission=MeshAdmission(...))`` answers
   8 requests of 640x1024 x 10000 (batch route, H5, ABFT verified), 2 of
   4096^2 x 240 (spatial by the default threshold) and 4 heat9 requests
   (H8), bitwise the one-card engine; the halo plan reads compiled; a
   resubmission is a cache hit; the launch rows' setup, run and readback
   seconds;
14. the mesh fault tier: ``mesh.chaos_gate.run_gate`` on 4 slots (device
   loss, a bit flip the ABFT tier detects, a hung launch), each
   recovered bitwise;
15. strong scaling: ``measure_strong_scaling(4, 4096, 4096, 240,
   mode="hybrid")`` collective (H12) and fused (H14), each record printed
   with the number of cards its slots span;
16. diff path (``heat2d_tpu_torch/diff``): the gradient at 4096^2 x 240
   steps, method auto (band: H6 forward), checkpointed, against the jnp
   route (primal within ``fma_tol``, du0 bit for bit, da and db against
   the float64 gradient), checkpoint against full bit for bit on the jnp
   route, forward and backward ms and peak memory of each; two inverse
   requests through a ``SolveServer`` (16^2 diffusivity, 2048^2 init
   through H6) and their cache-hit repeats; FD parity in float64 at
   64^2; H6's launches, zeroed just before, equal the band sweeps;
17. the ``kernels`` line: the shape timed, time, bound, plain and library
   times of each kernel H1-H14 and the coefficient pass at its path's
   shapes (H2 per 8 steps with its plan sweep over depths and its tiles
   by path; H6/H7 timed in turns, with their plan and tiles by path; H14
   with its plan and tiles by path; H4 in both forms with the chunk depth swept in each, and
   the resident routes against the streamed ones about the resident
   gate's edge; H9 with its plan, its build on the card and the
   plan sweep over depths that chose it; H10/H11 solve only, beside
   the call with its coefficient pass; H10's two builds, coefficients in
   shared memory or through the read-only cache; ``td_coeffs`` bound by
   the latency of its chain of rows, ``td_chain_bound``);
18. headline: Mcells/s at 4096^2 by bench.py's two-point protocol
   (``models.solver.two_point_headline`` at 4800/24000 steps with the
   noise rules of ``tune.measure``, as ``bench_torch.py`` times it), and
   the protocol of earlier runs (480/4800) in the same call beside it;
19. multi-process worlds (run after 15): 2-process worlds on the card,
   spawned by ``dist.harness.spawn_world`` (gloo, the strips between
   ranks staged through pinned host buffers): hybrid 4096^2 x 240 on a
   2x2 mesh, two 2048^2 shards a process (H12 per rank), and hybrid
   convergence at 1024^2 (H13 per rank, a sensitivity that stops the
   one-process run at step 140 of 240), each ``final_binary.dat`` bit
   for bit the one-process hybrid run's, steps_done equal; the 4096^2
   world also writes collective managed snapshots (``--checkpoint DIR/
   --checkpoint-every 120``, no rank gathering the grid), and a third
   world resumes from the directory past its torn step-240 snapshot
   (from 120, H12 per rank), bitwise; then
   ``heat2d-tpu-torch-dist --selftest`` at 4096^2 x 64, segment 8 (the
   store halo route), bitwise. It prints each rank's and the slowest
   rank's elapsed, Mcells/s beside the one-process run's, the host-staged
   exchange's ms and bytes per timed chunk, its share of each rank's
   elapsed and its rate, and the store halo bytes; the
   workers' H12/H13 launches, read from their run records, join the
   kernels line;
20. tune (after 18): the tuning subsystem (``heat2d_tpu_torch/tune``) on
   the card, its db in a temporary directory (``phase_tune``): a real
   search of 4096^2 (tile route: T and tile heights), 640x1024
   (resident route's K, tile route) and the fused route on 2048^2
   shards of a 2x2 mesh on host_devices(4), its frontier table and each
   route's planner point beside its best; a resumed search that
   measures nothing; every measured candidate bitwise the default plan
   (and H6/H7 at lifted depths bitwise T = 8); the db applied to the
   main path through the solver CLI (bitwise, ``tuned_config``), to a
   hybrid --halo fused run (its depth), to a serving request (its
   launch row) and to the mesh scheduler (its rate); then cleared, the
   plans the defaults again. The db is copied to
   ``chiprun_out/tune_db.json``.
21. obs (after 20): the telemetry layer (``heat2d_tpu_torch/obs``) on the
   card (``phase_obs``): (a) the main path, 4096^2 x 240 on the tile
   route through the solver CLI, once untraced and once under
   ``--profile`` and ``--trace-dir``: the final grids bitwise equal, the
   launch counts equal, the capture's H2 events (``k_tile``) as many as
   ``tile_multi``'s launches, H2 the top op, ``stencil_chunk``
   annotated; the digest's per-kernel ms and shares, the stream's idle
   share and longest gaps, H2's mean event beside the kernels line's
   time, the traced over untraced elapsed; (b) the same at 640x1024 x
   10000 on H4 (one persistent launch a run: its event time); (c) a
   ``SolveServer`` with tracing, cost cards and an SLO armed serving H5
   and H6 buckets: every request's merged trace connected with request,
   queue and launch spans, every launch row stamped with a bound and at
   most 100% of it, every card with a peak and a plan; (d) the card's
   roofline bound known. Digests and the merged report go to
   ``chiprun_out/obs_*.json``.
22. resil (after 19, before the kernels line): ``resil/`` and
   ``analysis/`` on the card through the solver CLI (``phase_resil``):
   (a) 4096^2 x 240 on H2 uninterrupted against ``--checkpoint DIR/
   --checkpoint-every 48``, bitwise, 5 snapshots, each one's host copy
   and write + sha256 + commit ms, the 64 MiB copy pageable against
   pinned; (b) the same killed at its 3rd checkpoint's mid_write
   (``HEAT2D_CHAOS_KILL_CKPT_AT=3``, a subprocess): rc 137, manifest
   [48, 96], a flight dump, and ``--resume DIR`` from step 96 bitwise
   (a); (c) 640x1024 x 10000 on H4 every 2000 steps, bitwise; (d)
   convergence at 2048^2 on H2 + H3 every 100 steps, the unsegmented
   run's stop step 160; (e) the build sentinel over the serve occupancy
   sweep (H5): no rebuild, capacities within the log2 budget; (f) the
   implicit gate (H6, H10/H11), rc 0. Its launches join the kernels
   line's.
23. fleet (after 22): ``heat2d_tpu_torch.fleet`` on the card
   (``phase_fleet``): a ``FleetServer(device="cuda")`` of 3 worker
   processes, each a CUDA context on the card, answers 24 requests of
   640x1024 x ~2000 steps (H5) and 6 of 4096^2 x ~240 (H6), with
   duplicates (coalesced) and repeats (cache hits); worker 0 dies at its
   4th pickup (``HEAT2D_CHAOS_WORKER_KILL_AFTER``), worker 1 is killed
   with 4096^2 requests in flight. Every distinct answer bitwise the
   one-process ``SolveServer`` on the card, nothing lost, >= 2 deaths and
   restarts, none on heartbeat age, no resident give-up, no build in a
   worker and ``build/kernels/`` unchanged, a clean stop; it reports the
   workers' start and recovery seconds by part, wire ms per answer, the
   wire's share of the traced requests, latency p50/p99 per width and
   ``nvidia-smi``'s compute apps. The workers' H5/H6 launches (their
   heartbeats' counts) join the kernels line's.
24. load (after 23): ``heat2d_tpu_torch.load`` on the card
   (``phase_load``), three legs: (a) the fleet phase's recorded
   admissions (its spans) replayed through ``heat2d-tpu-torch-load
   --replay --target serve --device cuda --max-skew`` against an
   in-process server, every arrival completed, H5 and H6 launched; (b)
   one ``ServeTarget(device="cuda")``: a probe of the top rate it keeps
   up with on the ``card_h5`` mix (640x1024 x 2000-2001 steps, H5), a
   sweep of 3 rates (half, once and twice that rate), a fit that must
   find the knee; the gated surface below the knee (2 rates, the
   committed baseline's), a healthy re-run that passes the gate against
   it and a chaos-slowed one (``launch_latency_s``) that fails it, the
   gated surface held against ``heat2d_tpu_torch/load/baseline_h100.json``
   at the default margins, and one point of the ``card_h6`` mix (4096^2 x
   240, H6) past its knee; (c) one ``FleetTarget(workers=2,
   device="cuda")``: the 640x1024 mix at two rates and the 4096^2 mix at
   two, each width's fit over 2 units, the router's decode ms of a
   4096^2 answer, a clean stop. Every arrival answered, no error outcome,
   no shedding at or below a knee, no kernel build; per point offered and
   achieved req/s, p50/p99, shed rate and submit-skew p99, each fit, the
   warmup seconds, the gate verdicts and the launch rows' run and
   readback seconds. Its H5/H6 launches (the pool's from the workers'
   heartbeats) join the kernels line's. Full results in
   ``chiprun_out/load_phase.json``.

The last line of standard output is ``{"ok": true, "device": ...}``. The
full results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


SOURCES = {
    "step": "heat2d_tpu_torch/csrc/stencil.cu",
    "tile_multi": "heat2d_tpu_torch/csrc/stencil.cu",
    "tile_multi_resid": "heat2d_tpu_torch/csrc/stencil.cu",
    "resident": "heat2d_tpu_torch/csrc/stencil.cu",
    "ens_resident": "heat2d_tpu_torch/csrc/ensemble.cu",
    "ens_tile_multi": "heat2d_tpu_torch/csrc/ensemble.cu",
    "ens_tile_multi_conv": "heat2d_tpu_torch/csrc/ensemble.cu",
    "fam_resident": "heat2d_tpu_torch/csrc/family.cu",
    "fam_tile_multi": "heat2d_tpu_torch/csrc/family.cu",
    "td_coeffs": "heat2d_tpu_torch/csrc/tridiag.cu",
    "td_rows": "heat2d_tpu_torch/csrc/tridiag.cu",
    "td_lanes": "heat2d_tpu_torch/csrc/tridiag.cu",
    "shard_tile_multi": "heat2d_tpu_torch/csrc/shard.cu",
    "shard_tile_multi_resid": "heat2d_tpu_torch/csrc/shard.cu",
    "shard_fused": "heat2d_tpu_torch/csrc/shard.cu",
}
REPLACES = {
    "step": "heat2d_tpu/ops/pallas_stencil.py:509",
    "tile_multi": "heat2d_tpu/ops/pallas_stencil.py:993",
    "tile_multi_resid": "heat2d_tpu/ops/pallas_stencil.py:1064",
    "resident": "heat2d_tpu/ops/pallas_stencil.py:275",
    "ens_resident": "heat2d_tpu/models/ensemble.py:106",
    "ens_tile_multi": "heat2d_tpu/models/ensemble.py:243",
    "ens_tile_multi_conv": "heat2d_tpu/models/ensemble.py:357",
    "fam_resident": "heat2d_tpu/problems/runners.py:124",
    "fam_tile_multi": "heat2d_tpu/problems/runners.py:181",
    "td_coeffs": "heat2d_tpu/ops/tridiag.py:219",
    "td_rows": "heat2d_tpu/ops/tridiag.py:324",
    "td_lanes": "heat2d_tpu/ops/tridiag.py:349",
    "shard_tile_multi": "heat2d_tpu/ops/pallas_stencil.py:1618",
    "shard_tile_multi_resid": "heat2d_tpu/ops/pallas_stencil.py:1924",
    "shard_fused": "heat2d_tpu/ops/pallas_stencil.py:2217",
}
#: The headline's two step counts: bench.py's (bench_torch.py takes the
#: same), and those of the protocol used up to PR 10, timed beside them.
HEADLINE_STEPS = (4800, 24000)
OLD_HEADLINE_STEPS = (480, 4800)


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


def time_device_ms(fn, reps: int) -> float:
    """``time_ms`` with the host's enqueue hidden: the stream sleeps
    ~10 ms before the first event, so that all ``reps`` calls are queued
    before the card reaches them and no host gap falls between the
    events (for kernels whose launch costs the host about as long as
    they run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def update_flops(problem: str = "heat5") -> int:
    """FLOPs of one cell update of ``problem`` (``obs.roofline``'s
    table: each rounded operation counted once; heat5's FMA form a
    multiply, two adds, two FMAs)."""
    from heat2d_tpu_torch.obs import roofline
    return roofline.FLOPS_PER_CELL_STEP[problem]


def td_flops() -> int:
    """FLOPs per unknown of a tridiagonal solve (``obs.roofline``)."""
    from heat2d_tpu_torch.obs import roofline
    return roofline.TD_FLOPS_PER_UNKNOWN


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time of the work on the card, by the published peaks of
    ``obs.roofline`` (the H100's float32 row)."""
    from heat2d_tpu_torch.obs import roofline
    pk = roofline.peaks(roofline.H100_KIND, "float32")
    t_bytes = nbytes / pk.bytes_per_s * 1e3
    t_ops = flops / pk.flops_per_s * 1e3
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
    """Every library built; the card's limits; the plans of the resident
    sweeps at leg (a)/(e)'s shape and of H4 at the main path's 640x1024,
    of H9 at each family's depth on 4096^2 and of H2 at the main path's
    depth on 4096^2 (registers and local bytes a thread as the build
    reports them, blocks per SM by the occupancy query and, for H9, as
    the planner states them)."""
    from heat2d_tpu_torch.ops import _build
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.resident import plan_resident
    t0 = time.perf_counter()
    libs = _build.build_all()
    caps = cs.device_caps("cuda")
    h2 = cs.tile_plan(4096, 4096, cs.DEFAULT_TSTEPS, "cuda")
    h9 = {}
    for fam in FAMILY_COEFS:
        plan = cf.tile_plan(4096, 4096, fam, "cuda", cf.SWEEP_TSTEPS[fam])
        h9[fam] = {"tsteps": cf.SWEEP_TSTEPS[fam], "ring": plan.tsteps,
                   "tile": [plan.ty, plan.tx],
                   "planned_blocks_per_sm": cf.blocks_per_sm(plan),
                   **cf.tile_info(fam, plan)}
        fail_unless(h9[fam]["blocks_per_sm"] >= 1,
                    f"H9 {fam}: no block of its plan fits an SM: {h9[fam]}")
    info = {"phase": "build", "seconds": time.perf_counter() - t0,
            "libraries": [str(p.name) for p in libs],
            "caps": caps._asdict(),
            "resident_plans": {
                name: plan_resident(8, 640, 1024, w, "cuda")._asdict()
                for name, w in (("ens_resident", 1), ("fam_resident_heat9",
                                                      2))},
            "h4_plan": cs.resident_plan(640, 1024, "cuda")._asdict(),
            "fam_tile_plans": h9,
            "h2_build": cs.tile_info(h2)}
    emit(info)
    return info


#: The H4 checks: a one-tile grid, the main path's 640x1024, a ragged
#: grid, 2048x1536 (every block) and one at the on-chip budget's edge
#: (1900x1900: past the old L2 gate, the plan's K down to 1).
H4_SHAPES = [(10, 10), (37, 53), (640, 1024), (641, 1023), (2048, 1536),
             (1900, 1900)]
H4_STEPS = (1, 5, 8, 9, 27, 100)


def phase_kernels(torch) -> dict:
    """Every kernel against its plain version on the same inputs. H2/H3
    on grids whose tiles take both paths of the strip sweep (the kernel's
    own count of its tiles by path must equal the planner's). H4 in both
    forms bit for bit against the H2 route, and a wait that cannot end,
    which must raise."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.resident import ResidentPlan
    g = torch.Generator(device="cuda")
    g.manual_seed(1612)
    shapes = [(4099, 4097), (4096, 4096), (640, 1024), (300, 520), (37, 53),
              (10, 10)]
    forms = (cs.FORM_FMA, cs.FORM_LITERAL)
    cx, cy = 0.1, 0.1
    worst = {k: 0.0 for k in cs.LAUNCHES}
    checks = 0
    paths = {}

    def judge(name, got, ref, n, form, what):
        nonlocal checks
        err = max_err(got, ref)
        worst[name] = max(worst[name], err)
        tol = 0.0 if form == cs.FORM_LITERAL else fma_tol(n, ref)
        fail_unless(err <= tol, f"{name} {what}: max_abs_err {err} > {tol}")
        checks += 1

    for shape in shapes:
        u = torch.rand(shape, generator=g, device="cuda")
        counted = cs.path_counter("cuda")
        planned = dict.fromkeys(cs.TILE_PATHS, 0)
        for form in forms:
            judge("step", cs.step(u, cx, cy, form),
                  cs.step_plain(u, cx, cy, form), 1, form,
                  f"{shape} form {form}")
            for t, nsub in [(1, 1), (3, 3), (3, 2), (8, 8), (8, 5), (8, 1)]:
                got = cs.tile_multi(u, nsub, cx, cy, form, t, paths=counted)
                judge("tile_multi", got,
                      cs.multi_step_plain(u, nsub, cx, cy, form), nsub, form,
                      f"{shape} T={t} nsub={nsub} form {form}")
                for k, v in cs.tile_paths(cs.tile_plan(*shape, t, "cuda"),
                                          *shape).items():
                    planned[k] += v
            for t, nsub in [(1, 1), (3, 2), (8, 8), (8, 3)]:
                got, r = cs.tile_multi_resid(u, nsub, cx, cy, form, t,
                                             paths=counted)
                for k, v in cs.tile_paths(cs.tile_plan(*shape, t, "cuda"),
                                          *shape).items():
                    planned[k] += v
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
        got = dict(zip(cs.TILE_PATHS, counted.tolist()))
        fail_unless(got == planned, f"H2/H3 {shape}: the kernel's tiles by "
                    f"path {got}, the planner's {planned}")
        paths[f"{shape[0]}x{shape[1]}"] = got
    fail_unless(paths["4096x4096"]["fast"] > 0 and paths["300x520"]["fast"]
                and paths["37x53"]["fast"] == 0,
                f"the H2/H3 cases miss a path of the strip sweep: {paths}")

    for shape in H4_SHAPES:
        u = torch.rand(shape, generator=g, device="cuda")
        for form in forms:
            for n in H4_STEPS:
                err = check_resident(
                    torch, "resident",
                    lambda: cs.resident(u, n, cx, cy, form),
                    lambda: cs.tiled_chunk(u, n, cx, cy, form,
                                           cs.DEFAULT_TSTEPS),
                    lambda: cs.multi_step_plain(u, n, cx, cy, form),
                    cs.launch_counts, "tile_multi",
                    lambda ref: (0.0 if form == cs.FORM_LITERAL
                                 else fma_tol(n, ref)),
                    f"{shape} steps={n} form {form}")
                worst["resident"] = max(worst["resident"], err)
                checks += 1
    # A plan whose one tile row stops short of the grid: the ring below it
    # is never published, its blocks give up after ~2 s and the wrapper
    # must raise; the launches after it run as ever.
    u = torch.rand((64, 256), generator=g, device="cuda")
    short = ResidentPlan(1, 64, 256, 1, 4, 32, 128, 1, 2, 1)
    try:
        cs._resident_launch(u, 9, cx, cy, cs.FORM_FMA, short)
    except RuntimeError as e:
        fail_unless("gave up" in str(e), f"H4 on a short plan raised {e}")
    else:
        raise SmokeFailure("H4 on a short plan: a wait that cannot end "
                           "did not raise")
    fail_unless(torch.equal(cs.resident(u, 9, cx, cy),
                            cs.tiled_chunk(u, 9, cx, cy)),
                "H4 after a launch that gave up: differs from the H2 route")
    checks += 1
    torch.cuda.synchronize()
    info = {"phase": "kernels", "checks": checks, "max_abs_err": worst,
            "tile_paths": paths}
    emit(info)
    return info


#: The on-chip checks of H5/H8: members that fit the card's shared memory,
#: in one tile (37x53), ragged (641x1023), a member that fills every
#: block (2048x1536) and one at the budget's edge (1900x1900, K = 1).
RESIDENT_SHAPES = [(37, 53), (641, 1023), (2048, 1536), (1900, 1900)]
RESIDENT_STEPS = (1, 5, 8, 9, 27)


def resident_cases():
    """(shape, B) of the on-chip checks: B = 40 gives a wave of 40 one-tile
    members and ten waves of 641x1023; the largest shape stops at 8."""
    return [(shape, b) for shape in RESIDENT_SHAPES for b in (1, 3, 8, 40)
            if not (b == 40 and shape[0] > 1000)]


def check_resident(torch, name, resident, tiled, plain, counts, tile_name,
                   tol_of, what) -> float:
    """One on-chip case: ``resident()`` must be served by the resident
    kernel (its counter, not the tile kernel's, moves), equal ``tiled()``
    (the tile-sweep route) bit for bit and lie within ``tol_of(ref)`` of
    ``plain()`` where one is given. Returns the error against plain."""
    before = counts()
    got = resident()
    after = counts()
    fail_unless(after[name] == before[name] + 1
                and after[tile_name] == before[tile_name],
                f"{name} {what}: served by {after} after {before}")
    fail_unless(torch.equal(got, tiled()),
                f"{name} {what}: differs from the tile-sweep route")
    if plain is None:
        return 0.0
    ref = plain()
    err = max_err(got, ref)
    fail_unless(err <= tol_of(ref), f"{name} {what}: max_abs_err {err} > "
                f"{tol_of(ref)}")
    return err


def phase_ensemble_kernels(torch) -> dict:
    """H5-H7 against their plain versions on the same batches: ragged
    members, B in {1, 3, 8}, heterogeneous (cx, cy) inside the stability
    box, nsub in {1, 5, 8}; H7 with every other member frozen. Then H5's
    on-chip sweep (``resident_cases``) against the H6 route bit for bit,
    and 4099x4097 members, which must be served by H6; the step loop H5
    does not take, bit for bit too; and a wait that cannot end, which must
    raise."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.resident import ResidentPlan, plan_resident
    g = torch.Generator(device="cuda")
    g.manual_seed(1613)
    worst = {k: 0.0 for k in ce.LAUNCHES}
    checks = 0
    paths = {}

    def judge(name, got, ref, n, what):
        nonlocal checks
        err = max_err(got, ref)
        worst[name] = max(worst[name], err)
        tol = fma_tol(n, ref)
        fail_unless(err <= tol, f"{name} {what}: max_abs_err {err} > {tol}")
        checks += 1

    for shape in [(37, 53), (4099, 4097)]:
        counted = cs.path_counter("cuda")
        planned = dict.fromkeys(cs.TILE_PATHS, 0)
        plan = ce.tile_plan(*shape, "cuda")
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
                judge("ens_tile_multi",
                      ce.ens_tile_multi(u, nsub, cxs, cys, paths=counted),
                      ref, nsub, what)
                got, r = ce.ens_tile_multi_conv(u, nsub, cxs, cys, active,
                                                resid=True, paths=counted)
                for k, v in ce.tile_paths(plan, b, *shape).items():
                    planned[k] += 2 * v
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
        got = dict(zip(cs.TILE_PATHS, counted.tolist()))
        fail_unless(got == planned, f"H6/H7 {shape}: the kernels' tiles by "
                    f"path {got}, the planner's {planned}")
        paths[f"{shape[0]}x{shape[1]}"] = got
        if shape == (4099, 4097):
            before = ce.launch_counts()
            ce.ens_resident(u, 9, cxs, cys)
            after = ce.launch_counts()
            fail_unless(after["ens_resident"] == before["ens_resident"]
                        and after["ens_tile_multi"]
                        == before["ens_tile_multi"] + 2,
                        f"H5 B=8 {shape}: served by {after} after {before}, "
                        f"not by two H6 sweeps")
            checks += 1
    for shape, b in resident_cases():
        u = torch.rand((b,) + shape, generator=g, device="cuda")
        cxs = torch.rand(b, generator=g, device="cuda") * 0.24 + 0.01
        cys = torch.rand(b, generator=g, device="cuda") * 0.24 + 0.01
        for n in RESIDENT_STEPS:
            err = check_resident(
                torch, "ens_resident",
                lambda: ce.ens_resident(u, n, cxs, cys),
                lambda: ce.ens_tiled_chunk(u, n, cxs, cys),
                (lambda: ce.ens_multi_step_plain(u, n, cxs, cys))
                if b <= 8 else None,
                ce.launch_counts, "ens_tile_multi",
                lambda ref: fma_tol(n, ref), f"B={b} {shape} steps={n}")
            worst["ens_resident"] = max(worst["ens_resident"], err)
            checks += 1
        if b == 3:
            # the step loop H5 does not take, on the same plan
            n = RESIDENT_STEPS[-1]
            plan = plan_resident(b, *shape, 1, "cuda")
            fail_unless(
                torch.equal(ce._resident_launch(u, n, cxs, cys, plan,
                                                window=False),
                            ce.ens_tiled_chunk(u, n, cxs, cys)),
                f"H5 by tile_steps B={b} {shape} steps={n}: differs from "
                f"the tile-sweep route")
            checks += 1
    # A plan whose one tile row stops short of the member: the ring below
    # it is never published, its blocks give up after ~2 s and the wrapper
    # must raise; the launches after it run as ever.
    u = torch.rand((1, 64, 256), generator=g, device="cuda")
    short = ResidentPlan(1, 64, 256, 1, 4, 32, 128, 1, 2, 1)
    try:
        ce._resident_launch(u, 9, cxs[:1], cys[:1], short)
    except RuntimeError as e:
        fail_unless("gave up" in str(e), f"H5 on a short plan raised {e}")
    else:
        raise SmokeFailure("H5 on a short plan: a wait that cannot end "
                           "did not raise")
    fail_unless(torch.equal(ce.ens_resident(u, 9, cxs[:1], cys[:1]),
                            ce.ens_tiled_chunk(u, 9, cxs[:1], cys[:1])),
                "H5 after a launch that gave up: differs from the "
                "tile-sweep route")
    checks += 1
    fail_unless(paths["4099x4097"]["fast"] > 0 and paths["4099x4097"]["edge"]
                and paths["37x53"]["fast"] == 0,
                f"the H6/H7 cases miss a path of the strip sweep: {paths}")
    torch.cuda.synchronize()
    info = {"phase": "ensemble_kernels", "checks": checks,
            "max_abs_err": worst, "tile_paths": paths}
    emit(info)
    return info


#: Per-family ranges of the random (cx, cy) of the kernel checks: inside
#: each family's explicit stability bound (heat9: cx + cy <= 3/8;
#: advdiff: vx^2 <= 2 cx besides the 5-point box).
FAMILY_COEFS = {"heat9": (0.01, 0.17), "advdiff": (0.01, 0.24),
                "reactdiff": (0.01, 0.24)}


def family_tol(problem, n, ref) -> float:
    """H8/H9 against their plain version after n steps: ``n * factor *
    2**-24 * max|plain|``, the factor (rounded operations x largest
    partial result, ``cuda_family.rounding_factor``) derived per family.
    The kernels repeat the plain roundings, so 0 is expected."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    return max(1, n) * cf.rounding_factor(problem) * 2.0 ** -24 * float(
        ref.abs().max())


def td_tol(c_max, ref) -> float:
    """H10/H11 against their plain version: an ADI half step at diffusion
    number c forms intermediates ~c times the state, so its roundoff is
    ~c eps; the bound is ``(1 + c_max) * 2**-20 * max|plain|`` (16 ulp of
    margin on c eps). The kernels repeat the plain roundings, so 0 is
    expected."""
    return (1.0 + c_max) * 2.0 ** -20 * float(ref.abs().max())


def adi_tol(steps, cx, cy, ref) -> float:
    """The H10 route against the plain scan: two arithmetics (the
    kernel's (cp, mi) elimination against the scan's division form),
    each ~(1 + cx + cy) eps per step: ``steps * (1 + cx + cy) * 2**-22 *
    max|ref|``."""
    return max(1, steps) * (1.0 + cx + cy) * 2.0 ** -22 * float(
        ref.abs().max())


def phase_family_kernels(torch) -> dict:
    """H8 and H9 against their plain version for heat9, advdiff and
    reactdiff: ragged 37x53 and 4099x4097 members, B in {1, 3, 8}, nsub
    in {1, 5, T}, random per-member (cx, cy) inside each family's box.
    Then H8's on-chip sweep (``resident_cases``) against the H9 route bit
    for bit (the step loop H8 does not take too), and 4099x4097 members,
    which must be served by H9."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops.resident import plan_resident
    from heat2d_tpu_torch.problems.registry import get_family
    g = torch.Generator(device="cuda")
    g.manual_seed(1614)
    worst = {k: 0.0 for k in cf.LAUNCHES}
    checks = 0
    for problem, (lo, hi) in FAMILY_COEFS.items():
        for shape in [(37, 53), (4099, 4097)]:
            for b in (1, 3, 8):
                u = torch.rand((b,) + shape, generator=g, device="cuda")
                cxs, cys = (torch.rand(b, generator=g, device="cuda")
                            * (hi - lo) + lo for _ in range(2))
                scal = cf.scalar_block(problem, cxs, cys)
                for nsub in (1, 5, 8):
                    ref = cf.fam_multi_step_plain(u, nsub, scal, problem)
                    tol = family_tol(problem, nsub, ref)
                    for name, fn in (("fam_resident", cf.fam_resident),
                                     ("fam_tile_multi", cf.fam_tile_multi)):
                        err = max_err(fn(u, nsub, scal, problem), ref)
                        worst[name] = max(worst[name], err)
                        fail_unless(err <= tol, f"{name} {problem} B={b} "
                                    f"{shape} nsub={nsub}: max_abs_err "
                                    f"{err} > {tol}")
                        checks += 1
                if shape == (4099, 4097) and b == 8:
                    before = cf.launch_counts()
                    cf.fam_resident(u, 9, scal, problem)
                    after = cf.launch_counts()
                    sweeps = len(cf.sweep_schedule(9, problem))
                    fail_unless(
                        after["fam_resident"] == before["fam_resident"]
                        and after["fam_tile_multi"]
                        == before["fam_tile_multi"] + sweeps,
                        f"H8 {problem} B=8 {shape}: served by {after} "
                        f"after {before}, not by {sweeps} H9 sweeps")
                    checks += 1
        for shape, b in resident_cases():
            u = torch.rand((b,) + shape, generator=g, device="cuda")
            cxs, cys = (torch.rand(b, generator=g, device="cuda")
                        * (hi - lo) + lo for _ in range(2))
            scal = cf.scalar_block(problem, cxs, cys)
            for n in RESIDENT_STEPS:
                err = check_resident(
                    torch, "fam_resident",
                    lambda: cf.fam_resident(u, n, scal, problem),
                    lambda: cf.fam_tiled_chunk(u, n, scal, problem),
                    (lambda: cf.fam_multi_step_plain(u, n, scal, problem))
                    if b <= 3 else None,
                    cf.launch_counts, "fam_tile_multi",
                    lambda ref: family_tol(problem, n, ref),
                    f"{problem} B={b} {shape} steps={n}")
                worst["fam_resident"] = max(worst["fam_resident"], err)
                checks += 1
            if b == 3:
                # the step loop H8 does not take, on the same plan
                n = RESIDENT_STEPS[-1]
                plan = plan_resident(
                    b, *shape, get_family(problem).spec.halo_width, "cuda")
                fail_unless(
                    torch.equal(cf._resident_launch(u, n, scal, problem,
                                                    plan, window=True),
                                cf.fam_tiled_chunk(u, n, scal, problem)),
                    f"H8 by window_steps {problem} B={b} {shape} "
                    f"steps={n}: differs from the tile-sweep route")
                checks += 1
    # H9 at the serving path's shape (legs e band), bit for bit: one sweep
    # at the plan's depth, and 8 steps as the path sweeps them.
    for problem, (lo, hi) in FAMILY_COEFS.items():
        u = torch.rand((4, 4096, 4096), generator=g, device="cuda")
        cxs, cys = (torch.rand(4, generator=g, device="cuda") * (hi - lo)
                    + lo for _ in range(2))
        scal = cf.scalar_block(problem, cxs, cys)
        for n, fn in ((cf.SWEEP_TSTEPS[problem], cf.fam_tile_multi),
                      (8, cf.fam_tiled_chunk)):
            fail_unless(torch.equal(fn(u, n, scal, problem),
                                    cf.fam_multi_step_plain(u, n, scal,
                                                            problem)),
                        f"fam_tile_multi {problem} 4 x 4096^2, {n} steps "
                        f"({fn.__name__}): not bitwise equal to plain")
            checks += 1
    torch.cuda.synchronize()
    info = {"phase": "family_kernels", "checks": checks,
            "max_abs_err": worst}
    emit(info)
    return info


def phase_tridiag_kernels(torch) -> dict:
    """H10 and H11 against their plain versions: B in {1, 3}, ragged
    shapes, diffusion numbers up to 51.2. Then the paths' shapes bit for
    bit, on the hoisted coefficients: one member of 4096^2 at c = 51.2
    (the ADI path) and leg (f)'s four; and the coefficient pass
    (``td_coeffs``) against its plain version."""
    from heat2d_tpu_torch.ops import tridiag as td
    g = torch.Generator(device="cuda")
    g.manual_seed(1615)
    worst = {k: 0.0 for k in td.LAUNCHES}
    checks = 0
    cs_ = [51.2, 0.3, 7.0]
    for shape in [(37, 53), (1031, 2053), (4099, 4097)]:
        for b in (1, 3):
            rhs = torch.rand((b,) + shape, generator=g, device="cuda") * 1e3
            c = torch.tensor(cs_[:b], dtype=torch.float32, device="cuda")
            for name, fn, plain in (("td_rows", td.td_rows, td.td_rows_plain),
                                    ("td_lanes", td.td_lanes,
                                     td.td_lanes_plain)):
                ref = plain(rhs, c)
                err = max_err(fn(rhs, c), ref)
                tol = td_tol(max(cs_[:b]), ref)
                worst[name] = max(worst[name], err)
                fail_unless(err <= tol, f"{name} B={b} {shape}: max_abs_err "
                            f"{err} > {tol}")
                checks += 1
    # H11 where it masks: rows not a multiple of its 32-row panels, n not
    # a multiple of its 32-column stages or below one, bitwise
    for b, rows, n in ((1, 1, 2), (3, 31, 3), (1, 33, 33), (3, 70, 31),
                       (1, 1000, 70), (3, 37, 4097)):
        c = torch.tensor(cs_[:b], device="cuda")
        rhs = torch.rand((b, rows, n), generator=g, device="cuda") * 1e3
        coef = td.td_coeffs(c, n)
        fail_unless(torch.equal(td.td_lanes(rhs, c, coef),
                                td.td_lanes_plain(rhs, c, coef)),
                    f"td_lanes B={b} {rows}x{n} on the hoisted "
                    f"coefficients: not bitwise equal to plain")
        checks += 1
    for c in ([51.2], [51.2, 25.6, 12.8, 3.2]):
        c = torch.tensor(c, device="cuda")
        rhs = torch.rand((len(c), 4096, 4096), generator=g,
                         device="cuda") * 1e3
        coef = td.td_coeffs(c, 4096)
        fail_unless(torch.equal(coef, td.td_coeffs_plain(c, 4096)),
                    f"td_coeffs B={len(c)} n=4096: not bitwise equal to "
                    f"plain")
        for name, fn, plain in (("td_rows", td.td_rows, td.td_rows_plain),
                                ("td_lanes", td.td_lanes,
                                 td.td_lanes_plain)):
            fail_unless(torch.equal(fn(rhs, c, coef), plain(rhs, c)),
                        f"{name} B={len(c)} 4096^2 on the hoisted "
                        f"coefficients: not bitwise equal to plain")
        checks += 3
    torch.cuda.synchronize()
    info = {"phase": "tridiag_kernels", "checks": checks,
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
    rows = stencil_kernel_rows(torch)
    rows += ensemble_kernel_rows(torch)
    rows += family_tridiag_kernel_rows(torch)
    rows += shard_kernel_rows(torch)
    for r in rows:
        r.update(route="cuda",
                 source=SOURCES[r["name"]],
                 replaces=REPLACES[r["name"]],
                 launches=launches[r["name"]],
                 max_abs_err=worst[r["name"]])
    return rows


#: H2's plan sweep: the depths T tried, per 8 steps.
H2_SWEEP_T = (4, 6, 8)


def stencil_kernel_rows(torch) -> list:
    """H1-H4 at the main path's shapes. H2 as the streamed route sweeps
    (T = 8: one sweep is 8 steps), beside the same 8 steps at other depths
    (``plan_sweep_ms``) and the tiles by path as one launch counted them.
    H4 at the reference CUDA program's 640x1024 x 10000 in both forms,
    its chunk depth K swept in each (``k_sweep_ms``), a launch of
    the convergence chunk's 20 steps (``chunk_20_ms``), and the resident
    routes against the streamed ones about the gate's edge
    (``gate_sweep``)."""
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
    b, by = bound_ms(2 * plane, update_flops() * cells)
    rows.append(dict(
        name="step", shape="4096x4096, 1 step",
        ms=time_ms(lambda: cs.step(big, cx, cy), 50),
        plain_ms=time_ms(lambda: cs.step_plain(big, cx, cy), 20),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: F.conv2d(x4, w, padding=1), 50)))

    # H2: one T = 8 sweep at 4096^2; H3: the same and its residual.
    t = cs.DEFAULT_TSTEPS
    plan = cs.tile_plan(4096, 4096, t, "cuda")
    counted = cs.path_counter("cuda")
    cs.tile_multi(big, t, cx, cy, tsteps=t, paths=counted)
    b, by = bound_ms(2 * plane, update_flops() * cells * t)
    rows.append(dict(
        name="tile_multi", shape=f"4096x4096, one T={t} sweep",
        ms=time_ms(lambda: cs.tile_multi(big, t, cx, cy, tsteps=t), 20),
        plan_sweep_ms={
            f"T={d}": time_ms(functools.partial(
                cs.tile_multi, big, d, cx, cy, tsteps=d), 10) * 8 / d
            for d in H2_SWEEP_T},
        plan={"tile": [plan.ty, plan.tx], "ring": plan.tsteps,
              "warps": cs.STRIP_WARPS, "strip": cs.TILE_STRIP,
              **dict(zip(cs.TILE_PATHS, counted.tolist()))},
        plain_ms=time_ms(lambda: cs.multi_step_plain(big, t, cx, cy), 5),
        bound_ms=b, bound_by=by, library_ms=None))
    b, by = bound_ms(2 * plane + 4 * plan.ntiles,
                     update_flops() * cells * t + 3 * cells)
    rows.append(dict(
        name="tile_multi_resid",
        shape=f"4096x4096, one T={t} sweep + residual",
        ms=time_ms(lambda: cs.tile_multi_resid(big, t, cx, cy, tsteps=t),
                   20),
        plain_ms=time_ms(lambda: cs.tile_multi_resid_plain(big, t, cx, cy),
                         5),
        bound_ms=b, bound_by=by, library_ms=None))

    # H4: 640x1024 x 10000 steps in one launch.
    small = inidat(640, 1024, device="cuda")
    n = 10000
    plan = cs.resident_plan(640, 1024, "cuda")
    b, by = bound_ms(2 * small.numel() * 4,
                     update_flops() * small.numel() * n)

    def launcher(form):
        return lambda p: cs._resident_launch(small, n, cx, cy, form, p)
    rows.append(dict(
        name="resident", shape="640x1024 x 10000 steps",
        ms=time_ms(lambda: cs.resident(small, n, cx, cy), 3),
        literal_ms=time_ms(
            lambda: cs.resident(small, n, cx, cy, cs.FORM_LITERAL), 3),
        k_sweep_ms={fname: resident_k_sweep(torch, launcher(form), 1,
                                            range(1, 9), nb=1)
                    for form, fname in ((cs.FORM_FMA, "fma"),
                                        (cs.FORM_LITERAL, "literal"))},
        chunk_20_ms=time_ms(lambda: cs.resident(small, 20, cx, cy), 20),
        plan={"k": plan.k, "tile": [plan.ty, plan.tx], "tiles": plan.tiles},
        tile_route_ms=time_ms(lambda: cs.tiled_chunk(
            small, n, cx, cy, tsteps=cs.DEFAULT_TSTEPS), 1),
        gate_sweep=gate_sweep(torch),
        plain_ms=time_ms(lambda: cs.multi_step_plain(small, n, cx, cy), 1),
        bound_ms=b, bound_by=by, library_ms=None))
    return rows


#: Grids about the resident gate's edge (``fits_resident``): from well
#: inside it to the last square the plan admits (1920^2, K = 1); 1810^2
#: is the last square the L2 gate of the old H4 admitted.
GATE_SHAPES = [(1024, 1024), (1448, 1448), (2048, 1536), (1810, 1810),
               (1850, 1850), (1900, 1900), (1920, 1920)]
GATE_STEPS = 1000


def gate_sweep(torch) -> list:
    """The resident routes against the streamed ones at ``GATE_SHAPES`` x
    ``GATE_STEPS`` steps, the three `auto` routes that ``fits_resident``
    gates: H4 against the H2 route (``tiled_chunk``) on one grid, H5
    against the H6 route and H8 (heat9) against the H9 route on 8
    members. Each with the plans the resident routes take (None: past
    the gate; H8 then runs the H9 route itself)."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.resident import plan_resident
    n, b, cx, cy = GATE_STEPS, 8, 0.1, 0.1
    cxs = torch.linspace(0.02, 0.125, b, device="cuda")
    scal = cf.scalar_block("heat9", cxs, 0.17 - cxs)

    def plan_of(p):
        return None if p is None else {"k": p.k, "tile": [p.ty, p.tx],
                                       "tiles": p.tiles, "waves": p.waves}
    out = []
    for nx, ny in GATE_SHAPES:
        u = torch.rand((nx, ny), device="cuda")
        ub = u.expand(b, nx, ny).contiguous()
        out.append({
            "shape": f"{nx}x{ny}", "steps": n,
            "fits_resident": cs.fits_resident((nx, ny), "cuda"),
            "h4_plan": plan_of(cs.resident_plan(nx, ny, "cuda")),
            "h4_ms": time_ms(lambda: cs.resident(u, n, cx, cy), 1),
            "h2_route_ms": time_ms(lambda: cs.tiled_chunk(u, n, cx, cy), 1),
            "h5_ms": time_ms(lambda: ce.ens_resident(ub, n, cxs, cxs), 1),
            "h6_route_ms": time_ms(
                lambda: ce.ens_tiled_chunk(ub, n, cxs, cxs), 1),
            "h8_heat9_plan": plan_of(plan_resident(b, nx, ny, 2, "cuda")),
            "h8_heat9_ms": time_ms(
                lambda: cf.fam_resident(ub, n, scal, "heat9"), 1),
            "h9_route_ms": time_ms(
                lambda: cf.fam_tiled_chunk(ub, n, scal, "heat9"), 1)})
        del u, ub
    return out


def resident_against_tiles(torch) -> list:
    """H5 and the H6 route on the same work at other member counts and
    sizes: one member of the reference CUDA program's grid (H4's shape),
    a bucket that fills one wave, and a member at the on-chip budget's
    edge. What `auto` should prefer is read from these."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.ops.resident import plan_resident
    out = []
    for b, nx, ny, n in [(1, 640, 1024, 10000), (4, 640, 1024, 10000),
                         (1, 2048, 1536, 2000)]:
        u = inidat(nx, ny, device="cuda").expand(b, nx, ny).contiguous()
        cxs = torch.linspace(0.02, 0.16, b, device="cuda")
        cys = torch.linspace(0.2, 0.06, b, device="cuda")
        plan = plan_resident(b, nx, ny, 1, "cuda")
        out.append({
            "shape": f"{b} x {nx}x{ny} x {n} steps",
            "plan": {"k": plan.k, "tile": [plan.ty, plan.tx],
                     "tiles": plan.tiles, "waves": plan.waves},
            "ms": time_ms(lambda: ce.ens_resident(u, n, cxs, cys), 2),
            "tile_route_ms": time_ms(
                lambda: ce.ens_tiled_chunk(u, n, cxs, cys), 1)})
    return out


def resident_k_sweep(torch, launch, ring_w: int, ks, nb: int = 8) -> dict:
    """The resident sweep at nb x 640x1024 x 10000 with the chunk depth K
    forced (the planner's tiles for that K): K -> ms. ``launch(plan)``
    runs the kernel on ``plan``. The planner's exchange cost is fitted to
    these."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.resident import plan_for_limits
    caps = cs.device_caps("cuda")
    out = {}
    for k in ks:
        plan = plan_for_limits(nb, 640, 1024, ring_w, cs.smem_limit("cuda"),
                               caps.sm_count, k)
        out[str(k)] = time_ms(functools.partial(launch, plan), 1)
    return out


def ensemble_kernel_rows(torch) -> list:
    """H5-H7 timed at the serving path's shapes (bounds times the B
    members; no single PyTorch call advances T steps, so no library
    time). H5's row also carries the time of the H6 route for the same
    work (``tile_route_ms``: 1250 sweeps), which the resident route has
    to beat, and the time of the same launch stepped by ``tile_steps``
    instead of H5's ``window_steps`` (``tile_steps_ms``). H6 and H7 are
    timed in turns, H6 first then H7 first (``turns_ms``; ``ms`` is the
    mean of a kernel's two), beside their plan and its tiles by path as
    one H6 launch counted them."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.ops.resident import plan_resident

    rows = []
    # H5: leg (a), 8 members of 640x1024 x 10000 steps in one launch.
    b, n = 8, 10000
    u = inidat(640, 1024, device="cuda").expand(b, 640, 1024).contiguous()
    cxs = torch.linspace(0.02, 0.16, b, device="cuda")
    cys = torch.linspace(0.2, 0.06, b, device="cuda")
    bnd, by = bound_ms(2 * u.numel() * 4, update_flops() * u.numel() * n)
    rows.append(dict(
        name="ens_resident", shape="8 x 640x1024 x 10000 steps",
        ms=time_ms(lambda: ce.ens_resident(u, n, cxs, cys), 3),
        tile_steps_ms=time_ms(lambda: ce._resident_launch(
            u, n, cxs, cys, plan_resident(*u.shape, 1, "cuda"),
            window=False), 3),
        tile_route_ms=time_ms(lambda: ce.ens_tiled_chunk(u, n, cxs, cys),
                              1),
        plain_ms=time_ms(lambda: ce.ens_multi_step_plain(u, n, cxs, cys),
                         1),
        bound_ms=bnd, bound_by=by, library_ms=None,
        k_sweep_ms=resident_k_sweep(
            torch, lambda p: ce._resident_launch(u, n, cxs, cys, p), 1,
            range(1, 9)),
        other_shapes=resident_against_tiles(torch)))

    # H6 / H7: legs (b) and (c), 4 members of 4096^2, one T = 8 sweep
    # (H7 with every member active and its residual), timed in turns.
    b, t = 4, cs.DEFAULT_TSTEPS
    u = inidat(4096, 4096, device="cuda").expand(b, 4096, 4096).contiguous()
    cxs = torch.tensor([0.05, 0.1, 0.15, 0.2], device="cuda")
    cys = torch.tensor([0.2, 0.16, 0.12, 0.08], device="cuda")
    act = torch.ones(b, dtype=torch.int32, device="cuda")
    cells = u.numel()
    plan = ce.tile_plan(4096, 4096, "cuda")
    # name -> (shape, kernel, plain version, (bound, by))
    kernels = {
        "ens_tile_multi": (
            "4 x 4096x4096, one T=8 sweep",
            lambda: ce.ens_tile_multi(u, t, cxs, cys),
            lambda: ce.ens_multi_step_plain(u, t, cxs, cys),
            bound_ms(2 * cells * 4, update_flops() * cells * t)),
        "ens_tile_multi_conv": (
            "4 x 4096x4096, one T=8 sweep + residuals, all active",
            lambda: ce.ens_tile_multi_conv(u, t, cxs, cys, act, resid=True),
            lambda: ce.ens_conv_sweep_plain(u, t, cxs, cys, act, True),
            bound_ms(2 * cells * 4 + 4 * b * plan.ntiles,
                     update_flops() * cells * t + 3 * cells))}
    turns = [[name, time_ms(kernels[name][1], 20)]
             for order in (list(kernels), list(kernels)[::-1])
             for name in order]
    counted = cs.path_counter("cuda")
    ce.ens_tile_multi(u, t, cxs, cys, paths=counted)
    plan_info = {"tile": [plan.ty, plan.tx], "ring": plan.tsteps,
                 "warps": cs.STRIP_WARPS, "strip": ce.STRIP,
                 **dict(zip(cs.TILE_PATHS, counted.tolist()))}
    for name, (shape, _, plain, (bnd, by)) in kernels.items():
        mine = [ms for n, ms in turns if n == name]
        rows.append(dict(
            name=name, shape=shape, ms=sum(mine) / len(mine),
            turns_ms=turns, plan=plan_info,
            plain_ms=time_ms(plain, 5),
            bound_ms=bnd, bound_by=by, library_ms=None))
    return rows


def family_tridiag_kernel_rows(torch) -> list:
    """H8-H11 timed at their paths' shapes. H8/H9 for heat9, the widest
    family (legs e); H10/H11 on one 4096^2 member at c = 51.2 (the ADI
    path). No single PyTorch call runs T family steps or a batched
    tridiagonal solve, so no library time."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops import tridiag as td
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.ops.resident import plan_resident

    rows = []
    fam = "heat9"
    # H8: leg (e), 8 members of 640x1024 x 10000 steps in one launch.
    b, n = 8, 10000
    u = inidat(640, 1024, device="cuda").expand(b, 640, 1024).contiguous()
    cxs = torch.linspace(0.02, 0.125, b, device="cuda")
    scal = cf.scalar_block(fam, cxs, 0.17 - cxs)
    bnd, by = bound_ms(2 * u.numel() * 4, update_flops(fam) * u.numel() * n)
    rows.append(dict(
        name="fam_resident", shape="heat9, 8 x 640x1024 x 10000 steps",
        ms=time_ms(lambda: cf.fam_resident(u, n, scal, fam), 3),
        tile_route_ms=time_ms(lambda: cf.fam_tiled_chunk(u, n, scal, fam),
                              1),
        other_families_ms={
            f: time_ms(functools.partial(
                cf.fam_resident, u, n,
                cf.scalar_block(f, cxs, 0.17 - cxs), f), 2)
            for f in ("advdiff", "reactdiff")},
        window_steps_ms={
            f: time_ms(functools.partial(
                cf._resident_launch, u, n,
                cf.scalar_block(f, cxs, 0.17 - cxs), f,
                plan_resident(*u.shape, w, "cuda"), window=True), 2)
            for f, w in (("heat9", 2), ("advdiff", 1), ("reactdiff", 1))},
        k_sweep_ms=resident_k_sweep(
            torch, lambda p: cf._resident_launch(u, n, scal, fam, p), 2,
            range(1, 5)),
        plain_ms=time_ms(lambda: cf.fam_multi_step_plain(u, n, scal, fam),
                         1),
        bound_ms=bnd, bound_by=by, library_ms=None))

    rows.append(family_tile_row(torch))

    # H10 / H11: one member's 4096 systems of 4096 unknowns, c = 51.2,
    # on the hoisted coefficients (``ms``, solve only); ``with_coeffs_ms``
    # is the call that computes its own (cp, mi) first. The coefficient
    # pass is a row of its own: n dependent steps, two IEEE divisions
    # each, no bound worth the name.
    rhs = inidat(4096, 4096, device="cuda")[None].contiguous()
    c = torch.tensor([51.2], device="cuda")
    coef = td.td_coeffs(c, 4096)
    coeffs_ms = time_ms(lambda: td.td_coeffs(c, 4096), 20)
    chain = td_chain_bound(51.2, 4096)
    bnd, by = bound_ms(4 + 2 * 4096 * 4, 0)
    if chain["ms"] > bnd:
        bnd, by = chain["ms"], "operations"
    rows.append(dict(
        name="td_coeffs", shape="1 member, n = 4096, c=51.2",
        ms=coeffs_ms,
        plain_ms=time_ms(lambda: td.td_coeffs_plain(c, 4096), 2),
        bound_ms=bnd, bound_by=by, bound_chain=chain, library_ms=None))
    bnd, by = bound_ms(2 * rhs.numel() * 4 + 4 + 2 * 4096 * 4,
                       td_flops() * rhs.numel())
    for name, fn, plain in (("td_rows", td.td_rows, td.td_rows_plain),
                            ("td_lanes", td.td_lanes, td.td_lanes_plain)):
        rows.append(dict(
            name=name, shape="1 x 4096 systems of 4096, c=51.2, solve only",
            ms=time_ms(lambda: fn(rhs, c, coef), 20),
            with_coeffs_ms=time_ms(lambda: fn(rhs, c), 20),
            coeffs_ms=coeffs_ms,
            plain_ms=time_ms(lambda: plain(rhs, c), 2),
            bound_ms=bnd, bound_by=by, library_ms=None))
    plan = td.plan_td_rows(1, 4096, 4096, *caps_of(torch))
    rows[-2]["plan"] = plan._asdict()
    rows[-1]["plan"] = td.plan_td_lanes(1, 4096, 4096,
                                        *caps_of(torch))._asdict()
    rows[-2]["variants_ms"] = td_rows_variants(torch, rhs, c, coef, plan)
    return rows


#: Clocks a row of ``k_td_coeffs``' recurrence takes at the least: three
#: dependent FP32 operations (the multiply, the subtract, and the division
#: counted as one), each at the FP32 pipe's 4-clock dependent latency.
TD_CHAIN_CLOCKS = 12


def td_chain_bound(c: float, n: int) -> dict:
    """``td_coeffs``' bound: a serial recurrence, so the latency of its
    chain of rows up to the float fixed point, after which the warp fills
    the rest in parallel (``csrc/tridiag.cu``, ``k_td_coeffs``). The rows
    are counted by running the kernel's recurrence in numpy float32 (the
    same correctly rounded operations) on this run's c; the clock is the
    card's maximum SM clock."""
    import numpy as np
    f = np.float32
    a, d = f(-0.5) * f(c), f(1.0) + f(c)
    cprev, rows = f(0.0), n - 2
    for i in range(1, n - 1):
        nxt = f(a / f(d - f(a * cprev)))
        if nxt == cprev:
            rows = i
            break
        cprev = nxt
    mhz = float(smi("clocks.max.sm").split()[0])
    return {"rows": rows, "clocks_per_row": TD_CHAIN_CLOCKS, "sm_mhz": mhz,
            "ms": rows * TD_CHAIN_CLOCKS / (mhz * 1e6) * 1e3}


def td_rows_variants(torch, rhs, c, coef, plan) -> dict:
    """H10's two builds (coefficients in shared memory, as the plan has
    them here, or through the read-only cache, as above ~24k rows) at the
    plan's warps, each timed and checked bitwise against the plain
    version."""
    from heat2d_tpu_torch.ops import tridiag as td
    nb, n, m = rhs.shape
    want = td.td_rows_plain(rhs, c, coef)
    out = {}
    for coef_smem in (1, 0):
        got = torch.empty_like(rhs)

        def run():
            td._check(td._lib().heat_td_rows(
                td._ptr(rhs), td._ptr(got), td._ptr(c), td._ptr(coef), nb,
                n, m, plan.warps, coef_smem, td._stream(rhs)),
                "td_rows variant")
        key = f"coef_smem={coef_smem}"
        out[key] = time_ms(run, 20)
        fail_unless(torch.equal(got, want),
                    f"H10 {key} differs from td_rows_plain")
    return out


def caps_of(torch) -> tuple:
    """(SMs, opt-in shared memory per block) of the card."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    caps = cs.device_caps("cuda")
    return caps.sm_count, caps.smem_optin


#: H9's plan sweep: the depths T tried per family.
PLAN_SWEEP_T = (3, 4, 6, 8)


def family_tile_row(torch) -> dict:
    """H9 at the serving path's shape (legs e band: 4 members of 4096^2)
    for heat9, the widest family: ``ms`` one sweep at the plan's depth T,
    ``per_8_steps_ms`` 8 steps as the path sweeps them; the plan
    (``cuda_family.SWEEP_TSTEPS``, ``FAM_WARPS``) and its build on the
    card (registers, local bytes, blocks per SM); ``plan_sweep_ms``: per
    8 steps at every depth in ``PLAN_SWEEP_T``, per family, from which
    the plan is chosen. The bound is per sweep at the plan's depth."""
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops.init import inidat
    b = 4
    u = inidat(4096, 4096, device="cuda").expand(b, 4096, 4096).contiguous()
    cxs = torch.tensor([0.03, 0.06, 0.09, 0.12], device="cuda")
    fams = {}
    for fam in FAMILY_COEFS:
        scal = cf.scalar_block(fam, cxs, 0.17 - cxs)
        t = cf.SWEEP_TSTEPS[fam]
        plan = cf.tile_plan(4096, 4096, fam, "cuda", t)
        sweep = {}
        for depth in PLAN_SWEEP_T:
            p = cf.tile_plan(4096, 4096, fam, "cuda", depth)
            sweep[f"T={depth}"] = time_ms(
                functools.partial(cf._tile_launch, u, depth, scal, fam, p),
                10) * 8 / depth
        fams[fam] = dict(
            ms=time_ms(lambda: cf.fam_tile_multi(u, t, scal, fam), 20),
            per_8_steps_ms=time_ms(
                lambda: cf.fam_tiled_chunk(u, 8, scal, fam), 10),
            plan={"tsteps": t, "ring": plan.tsteps, "tile": [plan.ty,
                                                             plan.tx],
                  **cf.tile_info(fam, plan)},
            plan_sweep_ms=sweep)
    fam = "heat9"
    scal = cf.scalar_block(fam, cxs, 0.17 - cxs)
    t = cf.SWEEP_TSTEPS[fam]
    bnd, by = bound_ms(2 * u.numel() * 4, update_flops(fam) * u.numel() * t)
    return dict(
        name="fam_tile_multi",
        shape=f"heat9, 4 x 4096x4096, one T={t} sweep",
        **fams.pop(fam),
        plain_ms=time_ms(lambda: cf.fam_multi_step_plain(u, t, scal, fam),
                         5),
        bound_ms=bnd, bound_by=by, library_ms=None,
        other_families=fams)


def adi_step_breakdown(torch, n: int, c: float) -> dict:
    """Where one ADI step of ``adi_sweep_kernel`` goes on an n x n
    member: each of its operations timed alone by CUDA events, and the
    whole step as a run takes it (``step``: on the run's hoisted
    coefficients) and alone (``step_with_coeffs``: the two coefficient
    passes first; ``coeffs``: those passes). Beside it, the y half solved
    as H11 does it and as a transpose, H10 and a transpose back, on that
    member and on leg (f)'s four members."""
    from heat2d_tpu_torch.ops import tridiag as td
    from heat2d_tpu_torch.ops.init import inidat

    u = inidat(n, n, device="cuda")[None].contiguous()
    cs_ = torch.tensor([c], device="cuda")
    cb = cs_.reshape(-1, 1, 1)
    kx, ky = coefs = td.adi_coeffs(u, cs_, cs_)
    rhs1 = td._rhs_half(u, cb, 1)
    x = td.td_rows(rhs1, cs_, kx)
    ustar = td._hold_edges(x, u)
    rhs2 = td._rhs_half(ustar, cb, 0)
    y = td.td_lanes(rhs2, cs_, ky)
    u4 = u.expand(4, n, n).contiguous()
    c4 = torch.tensor([51.2, 51.2, 12.8, 3.2], device="cuda")
    coefs4 = td.adi_coeffs(u4, c4, c4)
    rhs4 = td._rhs_half(u4, c4.reshape(-1, 1, 1), 0)

    def xpose(r, cc, k):
        return td.td_rows(r.transpose(1, 2).contiguous(), cc, k) \
            .transpose(1, 2).contiguous()

    parts = {
        "coeffs": lambda: td.adi_coeffs(u, cs_, cs_),
        "rhs_half_y": lambda: td._rhs_half(u, cb, 1),
        "td_rows_x": lambda: td.td_rows(rhs1, cs_, kx),
        "hold_edges_x": lambda: td._hold_edges(x, u),
        "rhs_half_x": lambda: td._rhs_half(ustar, cb, 0),
        "td_lanes_y": lambda: td.td_lanes(rhs2, cs_, ky),
        "hold_edges_y": lambda: td._hold_edges(y, u),
        "step": lambda: td.adi_sweep_kernel(u, cs_, cs_, coefs),
        "step_with_coeffs": lambda: td.adi_sweep_kernel(u, cs_, cs_),
        "y_half_xpose": lambda: xpose(rhs2, cs_, ky),
        "b4_td_lanes_y": lambda: td.td_lanes(rhs4, c4, coefs4[1]),
        "b4_y_half_xpose": lambda: xpose(rhs4, c4, coefs4[1]),
        "b4_step": lambda: td.adi_sweep_kernel(u4, c4, c4, coefs4),
    }
    return {k: time_ms(fn, 10) for k, fn in parts.items()}


def pick_adi_sensitivity(torch, n: int, c: float, interval: int,
                         exit_check: int):
    """A sensitivity at which both ADI routes of ``Heat2DSolver`` (H10/H11
    and the plain scan) exit at check ``exit_check`` of an n x n run:
    each route's residual at every check up to it, read on the card by
    the solver's own step and residual functions in the solver's order
    (``interval - 1`` steps, one tracked step, the pair's residual). The
    sensitivity lies at the geometric middle between the last check's
    largest residual and the earlier checks' smallest, and that gap must
    exceed four times the largest relative difference of the two routes
    at one check."""
    from heat2d_tpu_torch.ops import tridiag as td
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.ops.stencil import residual_sq
    ca = torch.full((1,), c, dtype=torch.float32, device="cuda")
    steps = {"adi-kernel": lambda u: td.adi_sweep_kernel(u[None], ca, ca)[0],
             "adi-scan": lambda u: td.adi_step(u, c, c)}
    res = {}
    for route, step in steps.items():
        u, res[route] = inidat(n, n, device="cuda"), []
        for _ in range(exit_check):
            for _ in range(interval - 1):
                u = step(u)
            prev, u = u, step(u)
            res[route].append(float(residual_sq(u, prev)))
    pairs = list(zip(*res.values()))
    gap = max(abs(a - b) / max(a, b) for a, b in pairs)
    below = max(pairs[-1])
    above = min(min(p) for p in pairs[:-1])
    fail_unless(above > below * (1 + 4 * gap),
                f"ADI residuals {res}: no sensitivity separates check "
                f"{exit_check} from the earlier ones (route gap {gap})")
    return math.sqrt(above * below), {"residuals": res, "route_gap": gap}


def adi_check(torch, got, want, cfg) -> dict:
    """An ADI/MG solver result against its reference on the card."""
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
    tol = adi_tol(got.steps_done, cfg.cx, cfg.cy, ref)
    fail_unless(err <= tol, f"{cfg}: max_abs_err {err} > {tol}")
    return {"shape": list(cfg.shape), "steps": cfg.steps,
            "method": cfg.method, "convergence": cfg.convergence,
            "route": got.route, "steps_done": got.steps_done,
            "max_abs_err": err, "tol": tol, "elapsed_s": got.elapsed,
            "warmup_s": got.warmup_s, "residual_reads": got.residual_reads}


def phase_implicit_path(torch) -> dict:
    """The implicit main path at full width through ``Heat2DSolver``:
    ``--mode pallas --method adi`` at 4096^2 and cx = cy = 51.2 (0.2 x
    bench_tts's step ratio of 256), 20 fixed steps, against ``--mode
    serial --method adi`` on the card. Then a convergence run of both
    routes at 1024^2, interval 10, which must exit at the fifth check: at
    4096^2 a step pair's residual falls only ~0.1% per check of 10 steps
    (the lowest mode's factor), less than the two routes' arithmetic
    moves it, so no sensitivity between checks is safe there. Then
    ``--method mg`` at 4097^2 (2^12 + 1, which the V-cycle coarsens), 4
    steps, on the reference initial condition and on the separable mode
    against the exact Crank-Nicolson factor. Launch counters, zeroed just
    before the solver runs, show H10 and H11 ran."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    from heat2d_tpu_torch.ops import analytic
    from heat2d_tpu_torch.ops import tridiag as td

    c, interval, exit_check = 51.2, 10, 5
    fixed = HeatConfig(nxprob=4096, nyprob=4096, steps=20, cx=c, cy=c,
                       method="adi", mode="pallas")
    sens, readings = pick_adi_sensitivity(torch, 1024, c, interval,
                                          exit_check)
    conv = fixed.replace(nxprob=1024, nyprob=1024, steps=100,
                         convergence=True, interval=interval,
                         sensitivity=sens)
    td.reset_launch_counts()
    runs = []
    for cfg in (fixed, conv):
        got = Heat2DSolver(cfg).run()
        want = Heat2DSolver(cfg.replace(mode="serial")).run(timed=False)
        runs.append(adi_check(torch, got, want, cfg))
        emit({"phase": "implicit_path_run", **runs[-1]})
    counts = td.launch_counts()
    for name in ("td_coeffs", "td_rows", "td_lanes"):
        fail_unless(counts[name] > 0, f"{name} never launched on the ADI "
                    f"path")
    fail_unless([r["route"] for r in runs] == ["adi-kernel", "adi-kernel"],
                f"ADI routes {[r['route'] for r in runs]}")
    fail_unless(runs[1]["steps_done"] == exit_check * interval
                and runs[1]["residual_reads"] == exit_check,
                f"ADI convergence run: steps_done {runs[1]['steps_done']}, "
                f"{runs[1]['residual_reads']} residual reads")

    n = 4097
    mg = HeatConfig(nxprob=n, nyprob=n, steps=4, cx=c, cy=c, method="mg",
                    mode="pallas")
    solver = Heat2DSolver(mg)
    r = solver.run()
    u = torch.from_numpy(r.u)
    fail_unless(bool(torch.isfinite(u).all()) and r.steps_done == 4
                and float(u[0].abs().max()) == 0.0, "mg: bad run")
    mode = analytic.separable_mode(n, n)
    rm = solver.run(u0=solver.place(mode), timed=False)
    lx, ly = analytic.mode_eigenvalues(n, n)
    a = c * lx / 2 + c * ly / 2
    exact = mode.astype("float64") * ((1 - a) / (1 + a)) ** 4
    mg_err = analytic.l2_error(rm.u, exact)
    fail_unless(mg_err <= 1e-4, f"mg: relative L2 error {mg_err} against "
                f"the exact CN factor")
    info = {"phase": "implicit_path", "launches": counts,
            "convergence": {"sensitivity": sens, **readings},
            "mg": {"route": r.route, "elapsed_s": r.elapsed,
                   "warmup_s": r.warmup_s, "mode_l2_error": mg_err},
            "adi_step_ms": adi_step_breakdown(torch, 4096, c)}
    emit(info)
    return {**info, "runs": runs}


def family_implicit_legs(SolveRequest) -> dict:
    """The serving legs of the families and the implicit methods, name ->
    requests. Coefficients sit inside each family's box (heat9: cx + cy
    <= 0.17; advdiff: vx^2 <= 2 cx)."""
    legs = {}
    for fam in ("heat9", "advdiff", "reactdiff"):
        if fam == "heat9":
            small = [(0.02 + 0.015 * i, 0.15 - 0.015 * i) for i in range(8)]
            big = [(0.03 * (i + 1), 0.17 - 0.03 * (i + 1)) for i in range(4)]
        else:
            small = [(0.02 + 0.02 * i, 0.2 - 0.02 * i) for i in range(8)]
            big = [(0.05 * (i + 1), 0.2 - 0.04 * i) for i in range(4)]
        legs[f"e_{fam}_pallas"] = [
            SolveRequest(nx=640, ny=1024, steps=10000, cx=cx, cy=cy,
                         problem=fam) for cx, cy in small]
        legs[f"e_{fam}_band"] = [
            SolveRequest(nx=4096, ny=4096, steps=240, cx=cx, cy=cy,
                         problem=fam) for cx, cy in big]
    legs["f"] = [SolveRequest(nx=4096, ny=4096, steps=20, cx=cx, cy=cy,
                              method="adi")
                 for cx, cy in [(51.2, 51.2), (25.6, 51.2), (51.2, 12.8),
                                (6.4, 3.2)]]
    legs["g"] = [SolveRequest(nx=4097, ny=4097, steps=4, cx=c, cy=c,
                              method="mg") for c in (51.2, 12.8)]
    return legs


def cn_exact_inidat(torch, nx: int, ny: int, steps: int, cx: float,
                    cy: float):
    """The exact Crank-Nicolson evolution of the reference initial
    condition, float64 on the card. ``inidat`` is i (nx-1-i) x j
    (ny-1-j), zero on the edges, so it expands in the sine modes of the
    held-edge Laplacian per axis; mode (k, l) is multiplied by (1 - a) /
    (1 + a) per step, a = (cx lx_k + cy ly_l) / 2, lx_k = 4 sin^2(pi k /
    (2 (nx - 1)))."""
    def basis(n):
        k = torch.arange(1, n - 1, dtype=torch.int64, device="cuda")
        ki = (k[:, None] * k[None, :]) % (2 * (n - 1))
        s = torch.sin(ki.to(torch.float64) * (math.pi / (n - 1)))
        f = (k * (n - 1 - k)).to(torch.float64)
        lam = 4.0 * torch.sin(k.to(torch.float64)
                              * (math.pi / (2.0 * (n - 1)))) ** 2
        return s, (2.0 / (n - 1)) * (s @ f), lam
    sx, ax, lx = basis(nx)
    sy, ay, ly = basis(ny)
    a = (cx * lx[:, None] + cy * ly[None, :]) / 2.0
    coef = ax[:, None] * ay[None, :] * ((1.0 - a) / (1.0 + a)) ** steps
    u = torch.zeros((nx, ny), dtype=torch.float64, device="cuda")
    u[1:-1, 1:-1] = sx @ coef @ sy
    return u


def mg_exact_check(torch, got, req, cx: float, cy: float) -> dict:
    """One served mg result against the exact Crank-Nicolson evolution:
    its relative L2 error must stay below a tenth of the relative L2
    change the exact evolution makes over the run, so a member stepped at
    another diffusion number, or not stepped, fails."""
    exact = cn_exact_inidat(torch, req.nx, req.ny, req.steps, cx, cy)
    start = cn_exact_inidat(torch, req.nx, req.ny, 0, cx, cy)
    u = torch.from_numpy(got).to("cuda", torch.float64)
    norm = float(torch.linalg.vector_norm(exact))
    err = float(torch.linalg.vector_norm(u - exact)) / norm
    change = float(torch.linalg.vector_norm(start - exact)) / norm
    fail_unless(err <= 0.1 * change, f"mg at ({cx}, {cy}): relative L2 "
                f"error {err} against the exact CN evolution, above a "
                f"tenth of its change {change}")
    return {"cx": cx, "cy": cy, "l2_error": err, "l2_change": change}


def phase_serve_families(torch) -> dict:
    """The serving path of the families and the implicit methods at full
    width, through ``SolveServer`` on the card: (e) per family 8 requests
    of 640x1024 x 10000 (H8) and 4 of 4096^2 x 240 (H9); (f) 4 adi
    requests of 4096^2 x 20 at diffusion numbers up to 51.2 (H10) and a
    repeat that must hit the cache bitwise; (g) 2 mg requests of 4097^2
    x 4; (h) reactdiff x adi, rejected as unsupported_combination. Every
    result against the port's jnp, scan or plain route on the card (the
    family legs bit for bit), the mg results also against the exact
    Crank-Nicolson evolution; launch counters, zeroed just before, show
    H8-H11 ran."""
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops import tridiag as td
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest
    from heat2d_tpu_torch.serve.server import Client, SolveServer

    legs = family_implicit_legs(SolveRequest)
    registry = MetricsRegistry()
    server = SolveServer(max_batch=8, max_delay=0.5, registry=registry,
                         default_timeout=600.0)
    client = Client(server)
    answers, seconds = {}, {}
    cf.reset_launch_counts()
    td.reset_launch_counts()
    with server:
        for name, reqs in legs.items():
            t0 = time.perf_counter()
            futs = [client.submit(r) for r in reqs]
            answers[name] = [f.result(timeout=900) for f in futs]
            seconds[name] = time.perf_counter() - t0
        hit = client.solve(legs["f"][0])
        try:
            client.solve(SolveRequest(nx=64, ny=64, steps=5, method="adi",
                                      problem="reactdiff"))
            rejected = None
        except Rejected as e:
            rejected = e
    counts = {**cf.launch_counts(), **td.launch_counts()}
    fail_unless(hit.cache_hit and hit.u.tobytes()
                == answers["f"][0].u.tobytes(),
                "leg f: the repeat was not a bitwise cache hit")
    fail_unless(rejected is not None
                and rejected.code == "unsupported_combination"
                and "does not support method 'adi'" in rejected.message
                and "nonlinear source term" in rejected.message,
                f"leg h: reactdiff x adi answered {rejected!r}")
    for name in ("fam_resident", "fam_tile_multi", "td_coeffs", "td_rows",
                 "td_lanes"):
        fail_unless(counts[name] > 0, f"kernel {name} never launched on "
                    f"the serving path")

    checked = {}
    for name, reqs in legs.items():
        r0 = reqs[0]
        cxs, cys = [r.cx for r in reqs], [r.cy for r in reqs]
        if r0.method == "adi":
            u0 = inidat(r0.nx, r0.ny, device="cuda").expand(
                len(reqs), r0.nx, r0.ny).contiguous()
            ref = td.batched_adi_scan(
                u0, torch.tensor(cxs, device="cuda"),
                torch.tensor(cys, device="cuda"), steps=r0.steps)
        else:
            route = "jnp" if r0.method == "auto" else r0.method
            ref = ensemble.run_ensemble(r0.nx, r0.ny, r0.steps, cxs, cys,
                                        method=route, problem=r0.problem)
        got = [a.steps_done for a in answers[name]]
        fail_unless(got == [r0.steps] * len(reqs),
                    f"leg {name}: steps_done {got}")
        errs = []
        for m, a in enumerate(answers[name]):
            u = torch.from_numpy(a.u)
            fail_unless(bool(torch.isfinite(u).all()),
                        f"leg {name}: non-finite values")
            want = ref[m].cpu()
            err = max_err(u, want)
            # The family kernels repeat their plain steps' roundings and
            # mg serves the route it is checked against: both bit for bit.
            tol = (adi_tol(r0.steps, cxs[m], cys[m], want)
                   if r0.method == "adi" else 0.0)
            fail_unless(err <= tol, f"leg {name} member {m}: max_abs_err "
                        f"{err} > {tol}")
            errs.append(err)
        checked[name] = {"steps_done": got, "max_abs_err": max(errs)}
        if r0.method == "mg":
            checked[name]["exact_cn"] = [
                mg_exact_check(torch, a.u, r0, r.cx, r.cy)
                for a, r in zip(answers[name], reqs)]
    log = server.engine.launch_log
    routes = [(row["problem"], row["method"]) for row in log]
    want_routes = [(f, r) for f in ("heat9", "advdiff", "reactdiff")
                   for r in ("pallas", "band")] + [("heat5", "adi"),
                                                   ("heat5", "mg")]
    fail_unless(routes == want_routes, f"serving routes {routes}")
    snap = registry.snapshot()
    info = {"phase": "serve_families",
            "requests": sum(len(r) for r in legs.values()) + 2,
            "launches": server.engine.launches, "launch_counts": counts,
            "legs": checked, "leg_seconds": seconds,
            "rejection": rejected.message,
            "problem_launches": {k: v for k, v in snap["counters"].items()
                                 if k.startswith("problem_requests")},
            "launch_log": [dict(row, signature=str(row["signature"]))
                           for row in log]}
    emit({k: info[k] for k in ("phase", "requests", "launches",
                               "launch_counts", "legs")})
    return info


def phase_time_to_solution(torch) -> dict:
    """One ``time_to_solution`` row at bench_tts's 513^2: explicit 2560
    steps through H6 against ADI 10 steps at 256x the diffusion number
    through H10, both against the analytic separable mode."""
    from heat2d_tpu_torch.models.solution import bench_tts
    out = bench_tts(use_kernels=True, device="cuda")
    summ = out["summary"]
    fail_unless(all(math.isfinite(r["accuracy"]) for r in out["rows"]),
                f"time_to_solution: {out['rows']}")
    fail_unless(summ["adi_matched_accuracy"],
                f"time_to_solution: ADI not at matched accuracy {out}")
    info = {"phase": "time_to_solution", **out}
    emit(info)
    return info


#: The diff leg's gradient: bench.py's grid and the main path's steps.
DIFF_GRID, DIFF_STEPS = 4096, 240


def grad_run(torch, f, u0, w, a, b, reps: int = 2) -> dict:
    """A differentiable solve and its gradient of ``sum(w * f(u0, a,
    b))`` on the card, ``reps`` times (the first warms the allocator's
    pools): the last run's output, (du0, da, db), forward and backward ms
    (host clock to a synchronize) and the peak memory allocated above the
    inputs; the first's times as ``cold_*``."""
    runs = []
    for _ in range(reps):
        ins = [u0.clone().requires_grad_()] + [
            torch.tensor(c, dtype=u0.dtype, device="cuda",
                         requires_grad=True) for c in (a, b)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = f(*ins)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(torch.sum(w * out), ins)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs.append({
            "out": out.detach(), "grads": [g.detach() for g in grads],
            "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30})
        del ins, out, grads
    return {**runs[-1], "cold_forward_ms": runs[0]["forward_ms"],
            "cold_backward_ms": runs[0]["backward_ms"]}


def diff_fd_check(torch) -> dict:
    """Autograd against central differences at 64^2 x 20 steps in float64
    on the card (jnp route, const and var), along random unit directions:
    rtol 1e-6, as on the CPU. The step h = 1e-4: at 64^2 the loss is ~1e4
    times a directional derivative, so h = 1e-6 (the CPU tests' h at 8^2)
    would leave a rounding floor of eps |L| / h ~ 1e-6 relative in the
    difference quotient; 1e-4 brings it to ~1e-8, and the h^2 truncation
    of the degree-20 polynomial stays below that."""
    from heat2d_tpu_torch.diff.adjoint import make_diff_solve
    from heat2d_tpu_torch.ops.init import inidat
    n, steps = 64, 20
    gen = torch.Generator(device="cuda").manual_seed(1621)
    u0 = inidat(n, n, torch.float64, "cuda")
    u0 = u0 / u0.max()
    w = torch.randn((n, n), generator=gen, device="cuda",
                    dtype=torch.float64)
    worst = 0.0
    for coeff in ("const", "var"):
        f = make_diff_solve(n, n, steps, coeff=coeff, device="cuda")
        shape = () if coeff == "const" else (n, n)
        args = [u0, torch.full(shape, 0.1, dtype=torch.float64,
                               device="cuda"),
                torch.full(shape, 0.12, dtype=torch.float64,
                           device="cuda")]
        ins = [x.clone().requires_grad_() for x in args]
        grads = torch.autograd.grad(torch.sum(w * f(*ins)), ins)
        for i, g in enumerate(grads):
            d = torch.randn(args[i].shape, generator=gen, device="cuda",
                            dtype=torch.float64)
            d = d / torch.sqrt(torch.sum(d * d))
            h = 1e-4
            p, m = list(args), list(args)
            p[i], m[i] = args[i] + h * d, args[i] - h * d
            fd = float(torch.sum(w * f(*p)) - torch.sum(w * f(*m))) / (2 * h)
            got = float(torch.sum(g * d))
            rel = abs(got - fd) / max(abs(fd), 1e-300)
            fail_unless(abs(got - fd) <= 1e-6 * abs(fd) + 1e-12,
                        f"diff FD parity {coeff} arg {i}: autograd {got} "
                        f"against finite differences {fd}")
            worst = max(worst, rel)
    return {"grid": n, "steps": steps, "dtype": "float64",
            "worst_rel_err": worst}


def diff_inverse_requests(torch) -> dict:
    """Two inverse requests through a ``SolveServer`` on the card: the
    selftest's diffusivity recovery (16^2, var, the plain step) and a
    target="init" request at 2048^2 x 64 steps, 3 iterations (past the
    resident gate: auto takes band, so H6 runs), each then resubmitted as
    a cache hit."""
    import numpy as np

    from heat2d_tpu_torch.diff.adjoint import make_diff_solve, segment_schedule
    from heat2d_tpu_torch.diff.inverse import (observation_mask,
                                               synthetic_diffusivity,
                                               unit_reference_init)
    from heat2d_tpu_torch.diff.serving import InverseRequest
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.serve.server import SolveServer

    n, steps = 16, 16
    true_k = torch.from_numpy(synthetic_diffusivity(n, n)).cuda()
    u0 = torch.from_numpy(unit_reference_init(n, n)).cuda()
    obs = make_diff_solve(n, n, steps, coeff="var")(u0, true_k, true_k)
    small = InverseRequest.from_fields(
        n, n, steps, observation_mask(n, n, every=1), obs.cpu().numpy(),
        target="diffusivity", iterations=300, lr=0.02, tol=1e-8)
    big, bsteps = 2048, 64
    f = make_diff_solve(big, big, bsteps, device="cuda")
    fail_unless(f.spec.method == "band",
                f"2048^2 auto resolved to {f.spec.method}, not band")
    bu0 = torch.from_numpy(unit_reference_init(big, big)).cuda()
    bobs = f(bu0, 0.1, 0.1).cpu().numpy()
    large = InverseRequest.from_fields(
        big, big, bsteps, observation_mask(big, big, every=16), bobs,
        target="init", iterations=3, lr=0.05)
    # H6 sweeps: the observations' primal, then each iteration's
    # checkpointed forward (a sweep per started 8 steps of a segment)
    from heat2d_tpu_torch.ops.cuda_stencil import DEFAULT_TSTEPS as t
    h6 = -(-bsteps // t) + large.iterations * sum(
        -(-k // t) for k in segment_schedule(bsteps))
    registry = MetricsRegistry()
    rows = {}
    with SolveServer(registry=registry, max_delay=0.01,
                     default_timeout=600.0) as server:
        for name, req in (("selftest_16", small), ("init_2048", large)):
            t0 = time.perf_counter()
            res = server.solve(req, timeout=600)
            t1 = time.perf_counter()
            again = server.solve(req, timeout=60)
            fail_unless(again.cache_hit and again.params.tobytes()
                        == res.params.tobytes(),
                        f"inverse {name}: the resubmission was not a "
                        f"bitwise cache hit")
            fail_unless(np.isfinite(res.params).all()
                        and math.isfinite(res.final_loss),
                        f"inverse {name}: non-finite result")
            rows[name] = {"seconds": t1 - t0, "iterations": res.iterations,
                          "final_loss": res.final_loss,
                          "converged": res.converged,
                          "first_loss": res.loss_history[0],
                          "cache_hit_repeat": again.cache_hit}
    r = rows["selftest_16"]
    fail_unless(r["converged"] and r["final_loss"] <= 1e-8,
                f"inverse selftest_16 did not converge: {r}")
    err0 = float((0.1 - true_k).abs()[1:-1, 1:-1].mean())
    r = rows["init_2048"]
    fail_unless(r["iterations"] == 3 and r["final_loss"] < r["first_loss"],
                f"inverse init_2048: the loss did not fall: {r}")
    snap = registry.snapshot()
    rows["selftest_16"]["initial_field_error"] = err0
    rows["solves_total"] = {k: v for k, v in snap["counters"].items()
                            if k.startswith("inverse_solves_total")}
    rows["h6_sweeps"] = h6
    return rows


def phase_diff_path(torch, name: str, power: str) -> dict:
    """The differentiable solves on the card (``heat2d_tpu_torch/diff``).
    The gradient of ``sum(w * u_T)`` at 4096^2 x 240 steps, const, method
    auto (which must resolve to band, H6), checkpointed, each gradient run
    twice (``grad_run``). Its band primal against the plain per-step
    primal (``fma_tol``); du0 bit for bit the jnp route's (the step is
    linear in u, so its pullback does not depend on the states); da and db
    against the float64 jnp gradient, within 4x the float32 jnp route's
    own error against it (the larger of its two) plus 2^-20 relative: the
    band route as accurate as the per-step route, whose float32 noise on
    these sums of tiny Laplacians is ~1e-3 relative at this size. On the
    jnp route the checkpointed adjoint against the full-storage one bit
    for bit. Forward and backward ms and the peak memory of each. Then two
    inverse requests through a server and FD parity in float64. H6's
    launches are counted over the band gradients and the inverse requests,
    and must equal their sweeps."""
    from heat2d_tpu_torch.diff.adjoint import make_diff_solve
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops.init import inidat

    n, steps = DIFF_GRID, DIFF_STEPS
    u0 = inidat(n, n, device="cuda")
    u0 = u0 / u0.max()
    # a smooth weight (the initial mode): da and db then sum terms of
    # one sign, which the routes' ulp differences cannot cancel
    w = u0.clone()
    band = make_diff_solve(n, n, steps, method="auto", device="cuda")
    fail_unless(band.spec.method == "band",
                f"{n}^2 auto resolved to {band.spec.method}, not band")
    ce.reset_launch_counts()
    runs = {"band_checkpoint": grad_run(torch, band, u0, w, 0.1, 0.1)}
    inverse = diff_inverse_requests(torch)
    launches = ce.launch_counts()
    sweeps = sum(-(-k // ce.DEFAULT_TSTEPS) for k in band.spec.schedule)
    want = 2 * sweeps + inverse["h6_sweeps"]
    fail_unless(launches["ens_tile_multi"] == want,
                f"H6 launched {launches['ens_tile_multi']} times on the "
                f"diff path, not the {want} sweeps of its band solves")
    for adjoint in ("checkpoint", "full"):
        f = make_diff_solve(n, n, steps, method="jnp", adjoint=adjoint,
                            device="cuda")
        runs[f"jnp_{adjoint}"] = grad_run(torch, f, u0, w, 0.1, 0.1)
    ref = grad_run(torch, make_diff_solve(n, n, steps, method="jnp",
                                          device="cuda"),
                   u0.double(), w.double(), 0.1, 0.1, reps=1)
    ck, full, b = (runs["jnp_checkpoint"], runs["jnp_full"],
                   runs["band_checkpoint"])
    g64 = {k: float(ref["grads"][i]) for i, k in ((1, "da"), (2, "db"))}
    errs = {route: {k: abs(float(r["grads"][i]) - g64[k])
                    for i, k in ((1, "da"), (2, "db"))}
            for route, r in (("band", b), ("jnp", ck))}
    floor = max(errs["jnp"].values())
    err, tol = max_err(b["out"], ck["out"]), fma_tol(steps, ck["out"])
    info = {"phase": "diff_path", "grid": n, "steps": steps,
            "schedule": list(band.spec.schedule),
            "launches": launches, "band_sweeps": sweeps,
            "band_primal_max_abs_err": err, "band_primal_tol": tol,
            "gradient_f64": g64, "abs_err_vs_f64": errs,
            "band_vs_jnp_rel": {k: abs(float(b["grads"][i])
                                       - float(ck["grads"][i])) / abs(g64[k])
                                for i, k in ((1, "da"), (2, "db"))},
            "runs": {k: {m: r[m] for m in (
                "forward_ms", "backward_ms", "peak_gib", "cold_forward_ms",
                "cold_backward_ms")} for k, r in {**runs,
                                                  "jnp_f64": ref}.items()},
            "inverse": inverse, "device": name, "power_limit": power}
    emit(info)
    fail_unless(torch.equal(ck["out"], full["out"])
                and all(torch.equal(x, y) for x, y in zip(ck["grads"],
                                                          full["grads"])),
                "jnp route: the checkpointed gradient is not bitwise the "
                "full-storage one")
    fail_unless(err <= tol, f"band primal: max_abs_err {err} > {tol}")
    fail_unless(torch.equal(b["grads"][0], ck["grads"][0]),
                f"band du0 not bitwise the jnp route's (max_abs_err "
                f"{max_err(b['grads'][0], ck['grads'][0])})")
    for k, g in g64.items():
        bound = 4 * floor + 2.0 ** -20 * abs(g)
        fail_unless(errs["band"][k] <= bound,
                    f"band {k}: error {errs['band'][k]} against the f64 "
                    f"gradient {g} exceeds {bound} (4x the f32 jnp "
                    f"route's {floor})")
    for r in runs.values():
        fail_unless(all(bool(torch.isfinite(g).all()) for g in r["grads"]),
                    "non-finite gradient")
    info["fd"] = diff_fd_check(torch)
    emit({"phase": "diff_path_fd", **info["fd"]})
    return info


def old_two_point(torch, lo: int, hi: int) -> dict:
    """The headline protocol this script used up to PR 10, timed for
    comparison: min of 3 runs at ``lo`` and of 2 at ``hi`` (each count's
    first run after a warmup), any positive marginal believed."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    best = {}
    for n, reps in ((lo, 3), (hi, 2)):
        solver = Heat2DSolver(HeatConfig(nxprob=4096, nyprob=4096, steps=n,
                                         mode="pallas"))
        best[n] = min(solver.run(warmup=i == 0).elapsed
                      for i in range(reps))
    step_s = (best[hi] - best[lo]) / (hi - lo)
    return {"steps": [lo, hi], "t_lo_s": best[lo], "t_hi_s": best[hi],
            "step_ms": step_s * 1e3,
            "value": 4096 * 4096 / step_s / 1e6 if step_s > 0 else None}


def phase_headline(torch, name: str, power: str) -> dict:
    """Mcells/s at 4096^2, pallas mode, by bench.py's two-point protocol
    (``models.solver.two_point_headline``, which bench_torch.py also
    calls): 4800 and 24000 steps, the marginal believed only past
    ``tune.measure.two_point_estimate``'s noise rules. The protocol of
    earlier runs (480/4800, any positive marginal) is timed in the same
    call beside it."""
    from heat2d_tpu_torch.models.solver import two_point_headline
    old = old_two_point(torch, *OLD_HEADLINE_STEPS)
    lo, hi = HEADLINE_STEPS
    tp = two_point_headline(4096, 4096, lo, hi, device="cuda")
    step_s = tp["step_s"]
    fail_unless(step_s is not None and step_s > 0,
                f"two-point step time {step_s}: the window did not clear "
                f"the noise rules ({tp['times']})")
    info = {"phase": "headline",
            "metric": f"Mcells/s 4096x4096 (pallas, two-point {lo}/{hi})",
            "value": 4096 * 4096 / step_s / 1e6, "step_ms": step_s * 1e3,
            "t_lo_s": tp["t_lo_s"], "t_hi_s": tp["t_hi_s"],
            "times": tp["times"], "old_protocol": old, "device": name,
            "power_limit": power}
    emit(info)
    return info


def _shard_grid(torch, nx, ny, gx, gy, gen):
    """A random nx x ny domain on the card, zero-padded to equal shards,
    as a (gx, gy) grid of blocks."""
    bm, bn = -(-nx // gx), -(-ny // gy)
    full = torch.zeros((gx * bm, gy * bn), device="cuda")
    full[:nx, :ny] = torch.rand((nx, ny), generator=gen, device="cuda")
    return [[full[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn].contiguous()
             for j in range(gy)] for i in range(gx)]


def phase_shard_kernels(torch) -> dict:
    """H12-H14 against their plain versions on the card: every shard of a
    2x2 mesh of 4096^2, of 4 row strips of 4099x4096 and of 543x300 (one
    pad row each) and of a 2x2 mesh of 74x106; T = 8 strips at nsub 8, 3
    and 1; H14 at depth nsub against its plain version and against H12
    bit for bit. ``tile_paths``: the strip sweep's tiles of each mesh's
    shards by path in one sweep, as H12/H13 counted them (``paths``); they
    must equal the planner's count (``cuda_shard.tile_paths``), and every
    path must be taken."""
    from heat2d_tpu_torch.ops import cuda_shard as csh
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.parallel.halo import exchange_halo_strips
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1616)
    cx, cy, t = 0.1, 0.1, 8
    worst = {k: 0.0 for k in csh.LAUNCHES}
    checks = 0

    def judge(name, got, ref, n, form, what):
        nonlocal checks
        err = max_err(got, ref)
        worst[name] = max(worst[name], err)
        tol = 0.0 if form == csh.FORM_LITERAL else fma_tol(n, ref)
        fail_unless(err <= tol, f"{name} {what}: max_abs_err {err} > {tol}")
        checks += 1

    # 4096^2: mostly fast tiles of the strip sweep; 74x106: edge tiles
    # only; 543x300 on 4x1: a tile inside its block that holds a pad row
    cases = [(4096, 4096, 2, 2, (8, 3, 1)), (4099, 4096, 4, 1, (8, 3)),
             (543, 300, 4, 1, (8, 3)), (74, 106, 2, 2, (8, 3, 1))]
    paths = {}
    fused_paths = {}
    for nx, ny, gx, gy, nsubs in cases:
        blocks = _shard_grid(torch, nx, ny, gx, gy, gen)
        bm, bn = blocks[0][0].shape
        strips = exchange_halo_strips(blocks, t)
        plan = cs.plan_strip_sweep(bm, bn, t)
        kinds = [csh.tile_paths(plan, i * bm, j * bn, bm, bn, nx, ny)
                 for i in range(gx) for j in range(gy)]
        planned = {k: sum(d[k] for d in kinds) for k in csh.TILE_PATHS}
        counted = csh.path_counter("cuda")
        counted_f = csh.path_counter("cuda")
        planned_f = dict.fromkeys(csh.TILE_PATHS, 0)
        for form in (csh.FORM_FMA, csh.FORM_LITERAL):
            for nsub in nsubs:
                what = f"{nx}x{ny} on {gx}x{gy} nsub={nsub} form {form}"
                h12 = {}
                for i in range(gx):
                    for j in range(gy):
                        args = (nsub, i * bm, j * bn, nx, ny, cx, cy, form)
                        u, st = blocks[i][j], strips[i][j]
                        h12[i, j] = csh.shard_tile_multi(u, st, *args,
                                                         paths=counted)
                        judge("shard_tile_multi", h12[i, j],
                              csh.shard_tile_multi_plain(u, st, *args),
                              nsub, form, f"{what} shard ({i},{j})")
                        got, r = csh.shard_tile_multi_resid(
                            u, st, *args, paths=counted)
                        ref, r_ref = csh.shard_tile_multi_resid_plain(
                            u, st, *args)
                        judge("shard_tile_multi_resid", got, ref, nsub,
                              form, f"{what} shard ({i},{j})")
                        rtol = 1e-5 if form == csh.FORM_LITERAL else 1e-4
                        fail_unless(abs(float(r) - float(r_ref))
                                    <= rtol * abs(float(r_ref)),
                                    f"H13 residual {what} shard ({i},{j}): "
                                    f"{float(r)} vs {float(r_ref)}")
                fused = csh.shard_fused(blocks, nsub, nx, ny, cx, cy, form,
                                        paths=counted_f)
                for k, v in csh.fused_tile_paths(
                        cs.tile_plan(bm, bn, nsub, "cuda"), gx, gy, bm, bn,
                        nx, ny).items():
                    planned_f[k] += v
                plain = csh.shard_fused_plain(blocks, nsub, nx, ny, cx, cy,
                                              form)
                for i in range(gx):
                    for j in range(gy):
                        judge("shard_fused", fused[i][j], plain[i][j], nsub,
                              form, f"{what} shard ({i},{j})")
                        fail_unless(torch.equal(fused[i][j], h12[i, j]),
                                    f"H14 {what} shard ({i},{j}) differs "
                                    f"from H12")
        # two counted sweeps (H12, H13) of the mesh per form and depth
        sweeps = 2 * 2 * len(nsubs)
        got = dict(zip(csh.TILE_PATHS, counted.tolist()))
        fail_unless(got == {k: v * sweeps for k, v in planned.items()},
                    f"{nx}x{ny}: the kernel's tiles by path {got} over "
                    f"{sweeps} sweeps, the planner's {planned} a sweep")
        paths[f"{nx}x{ny}"] = {k: v // sweeps for k, v in got.items()}
        got = dict(zip(csh.TILE_PATHS, counted_f.tolist()))
        fail_unless(got == planned_f, f"H14 {nx}x{ny}: the kernel's tiles by "
                    f"path {got}, the planner's {planned_f}")
        fused_paths[f"{nx}x{ny}"] = got
    fail_unless(paths["4096x4096"]["fast"] > 0
                and paths["74x106"]["fast"] == 0
                and paths["543x300"]["in_block_held"] > 0,
                f"the shard cases miss a path of the strip sweep: {paths}")
    fail_unless(fused_paths["4096x4096"]["fast"] > 0
                and fused_paths["4096x4096"]["edge"] > 0
                and fused_paths["74x106"]["fast"] == 0,
                f"the H14 cases miss a path of the strip sweep: "
                f"{fused_paths}")
    torch.cuda.synchronize()
    info = {"phase": "shard_kernels", "checks": checks, "max_abs_err": worst,
            "tile_paths": paths, "fused_tile_paths": fused_paths}
    emit(info)
    return info


def noisy_inidat(nx, ny, seed=1617, amplitude=1e11):
    """The reference initial condition plus seeded uniform noise of
    ``amplitude`` on the interior (numpy, float32). From ``inidat`` alone
    a 4096^2 run's residual falls ~0.002% per check of 20 steps, far less
    than the two step forms' roundings move it, so no sensitivity could
    make both routes exit at the same check. The noise's modes decay
    fast: its residual falls ~t^-3, 8x from check 1 to 2, 2.4x from 3 to
    4, and at 1e11 it dominates the smooth part (~3e12 per cell) and the
    roundings to the last check of 240 steps."""
    import numpy as np
    ix = np.arange(nx, dtype=np.float64)[:, None]
    iy = np.arange(ny, dtype=np.float64)[None, :]
    u = ix * (nx - ix - 1) * iy * (ny - iy - 1)
    rng = np.random.default_rng(seed)
    u[1:-1, 1:-1] += amplitude * rng.random((nx - 2, ny - 2))
    return u.astype(np.float32)


def residual_trace(torch, cfg, devices, u0) -> list:
    """The residual of every check of ``cfg``'s route on the card from the
    host grid ``u0`` (None: the configuration's own initial grid), read
    through its runner's ``tap`` in a run that never exits early."""
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    solver = Heat2DSolver(cfg.replace(sensitivity=0.0), devices=devices)
    runner = solver.make_runner()
    seen, count = [], runner.tap
    runner.tap = lambda k, r: (seen.append(r), count(k, r))
    solver.run(u0=None if u0 is None else solver.place(u0), timed=False)
    return seen


def pick_check_sensitivity(traces: dict):
    """A sensitivity at which every route of ``traces`` (route -> the
    residual at each check) exits at the same check: the last check whose
    largest residual lies at least 2x below the smallest residual of all
    earlier checks, at the geometric middle of the gap. Returns the
    sensitivity and the exit check (1-based)."""
    rows = list(zip(*traces.values()))
    best = None
    for k in range(1, len(rows)):
        below = max(rows[k])
        above = min(min(r) for r in rows[:k])
        if above > 2 * below:
            best = (k, below, above)
    fail_unless(best is not None, f"no sensitivity separates a check from "
                f"the earlier ones in {traces}")
    k, below, above = best
    return math.sqrt(below * above), k + 1


def phase_sharded_path(torch) -> dict:
    """The sharded modes through ``Heat2DSolver`` on a 2x2 mesh (or 4 row
    strips) of the one card, against mode serial on the card."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    from heat2d_tpu_torch.ops import cuda_shard as csh
    from heat2d_tpu_torch.parallel.mesh import host_devices
    devs = host_devices(4)
    big = HeatConfig(nxprob=4096, nyprob=4096, steps=240, gridx=2, gridy=2,
                     numworkers=4)
    conv = big.replace(mode="hybrid", convergence=True, interval=20)
    noisy = noisy_inidat(4096, 4096)
    traces = {"hybrid": residual_trace(torch, conv, devs, noisy),
              "serial": residual_trace(torch, conv.replace(mode="serial"),
                                       devs, noisy)}
    sens, exit_check = pick_check_sensitivity(traces)
    conv = conv.replace(sensitivity=sens)
    ref2d = HeatConfig(nxprob=2560, nyprob=2048, steps=1000, mode="hybrid",
                       gridx=2, gridy=2, convergence=True, interval=20,
                       sensitivity=0.1)
    serial = {}

    def reference(cfg, u0):
        key = cfg.replace(mode="serial", halo="collective",
                          bitwise_parity=False)
        if key not in serial:
            solver = Heat2DSolver(key)
            serial[key] = solver.run(
                u0=None if u0 is None else solver.place(u0), timed=False)
        return serial[key]

    def run(cfg, want=None, u0=None):
        before = csh.launch_counts()
        solver = Heat2DSolver(cfg, devices=devs)
        got = solver.run(u0=None if u0 is None else solver.place(u0))
        u = torch.from_numpy(got.u)
        fail_unless(bool(torch.isfinite(u).all()), f"{cfg}: non-finite")
        fail_unless(tuple(u.shape) == cfg.shape, f"{cfg}: shape {u.shape}")
        fail_unless(float(u[0].abs().max()) == 0.0
                    and float(u[:, -1].abs().max()) == 0.0,
                    f"{cfg}: boundary not held")
        ref = reference(cfg, u0) if want is None else want
        fail_unless(got.steps_done == ref.steps_done,
                    f"{cfg}: steps_done {got.steps_done} vs "
                    f"{ref.steps_done}")
        exact = want is not None or cfg.mode != "hybrid" \
            or cfg.bitwise_parity
        ref_u = torch.from_numpy(ref.u)
        err = max_err(u, ref_u)
        tol = 0.0 if exact else fma_tol(got.steps_done, ref_u)
        fail_unless(err <= tol, f"{cfg}: max_abs_err {err} > {tol}")
        after = csh.launch_counts()
        row = {"mode": cfg.mode, "shape": list(cfg.shape),
               "steps": cfg.steps, "halo": cfg.halo,
               "bitwise_parity": cfg.bitwise_parity,
               "convergence": cfg.convergence,
               "initial": "inidat" if u0 is None else "inidat + noise",
               "route": got.route,
               "halo_route": got.halo["route"], "tier": got.halo["tier"],
               "depth": got.halo["depth"], "mesh": list(got.halo["mesh"]),
               "steps_done": got.steps_done, "max_abs_err": err,
               "tol": tol, "against": "hybrid collective" if want
               else "serial", "elapsed_s": got.elapsed,
               "warmup_s": got.warmup_s, "mcells_per_s": got.mcells_per_s,
               "residual_reads": got.residual_reads,
               "launches": {k: after[k] - before[k] for k in after}}
        emit({"phase": "sharded_path_run", **row})
        return got, row

    csh.reset_launch_counts()
    rows = []
    for cfg in (big.replace(mode="dist2d"), big.replace(mode="dist1d"),
                big.replace(mode="hybrid"),
                big.replace(mode="hybrid", bitwise_parity=True)):
        got, row = run(cfg)
        rows.append(row)
        if cfg.mode == "hybrid" and not cfg.bitwise_parity:
            collective = got
    _, row = run(big.replace(mode="hybrid", halo="fused"), want=collective)
    fail_unless(row["tier"] == "ici", f"hybrid fused took tier "
                f"{row['tier']}, not the in-kernel one")
    rows.append(row)
    rows.append(run(conv, u0=noisy)[1])
    rows.append(run(ref2d)[1])
    counts = csh.launch_counts()
    for name, n in counts.items():
        fail_unless(n > 0, f"kernel {name} never launched on the sharded "
                    f"path")
    fail_unless(rows[-2]["steps_done"] == exit_check * conv.interval,
                f"hybrid convergence exited at {rows[-2]['steps_done']}, "
                f"not at check {exit_check}")
    info = {"phase": "sharded_path", "launches": counts,
            "convergence": {"sensitivity": sens, "exit_check": exit_check,
                            "residuals": traces},
            "chunk_ms": shard_chunk_ms(torch, devs)}
    emit(info)
    return {**info, "runs": rows}


# ------------------------------------------------------------------ #
# slice 6: members over slots, mesh serving, the fault tier, scaling
# ------------------------------------------------------------------ #

def _counters():
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_family as cf
    from heat2d_tpu_torch.ops import cuda_shard as csh
    return ce, cf, csh


def reset_counts() -> None:
    for mod in _counters():
        mod.reset_launch_counts()


def read_counts() -> dict:
    out = {}
    for mod in _counters():
        out.update(mod.launch_counts())
    return out


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_sharded_ensembles(torch) -> dict:
    """(a) Members over 4 slots of the card (``host_devices(4)``), each
    slot running the one-slot route on its members: 8 x 640x1024 x 10000
    (H5), 4 x 4096^2 x 240 (H6), and 4 x 640x1024 convergence, interval
    20, method band (H7) with a sensitivity between the members' chunk-1
    residuals; each bit for bit the one-slot run (steps_done equal)."""
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.parallel.mesh import host_devices
    devs = host_devices(4)
    conv_c = [0.01, 0.05, 0.1, 0.2]
    sens, _ = pick_sensitivity(torch, 640, 1024, conv_c, conv_c, 20)
    legs = [
        ("h5", dict(nx=640, ny=1024, steps=10000,
                    cxs=[0.02 + 0.02 * i for i in range(8)],
                    cys=[0.2 - 0.02 * i for i in range(8)],
                    method="auto")),
        ("h6", dict(nx=4096, ny=4096, steps=240,
                    cxs=[0.05 * (i + 1) for i in range(4)],
                    cys=[0.2 - 0.04 * i for i in range(4)],
                    method="auto")),
        ("h7", dict(nx=640, ny=1024, steps=200, cxs=conv_c, cys=conv_c,
                    method="band", interval=20, sensitivity=sens)),
    ]
    total, rows = {}, []
    for name, kw in legs:
        args = (kw["nx"], kw["ny"], kw["steps"])
        conv = "interval" in kw
        reset_counts()
        t0 = time.perf_counter()
        if conv:
            got, k = ensemble.run_ensemble_convergence_sharded(
                *args, kw["interval"], kw["sensitivity"], kw["cxs"],
                kw["cys"], method=kw["method"], devices=devs)
        else:
            got = ensemble.run_ensemble_sharded(
                *args, kw["cxs"], kw["cys"], method=kw["method"],
                devices=devs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        add_counts(total, counts)
        if conv:
            want, kw_ = ensemble.run_ensemble_convergence(
                *args, kw["interval"], kw["sensitivity"], kw["cxs"],
                kw["cys"], method=kw["method"])
            fail_unless(k.tolist() == kw_.tolist(),
                        f"sharded {name}: steps_done {k.tolist()} vs "
                        f"{kw_.tolist()}")
            fail_unless(len(set(k.tolist())) >= 2,
                        f"sharded {name}: members exited together")
        else:
            want = ensemble.run_ensemble(*args, kw["cxs"], kw["cys"],
                                         method=kw["method"])
        fail_unless(bool(torch.isfinite(got).all()),
                    f"sharded {name}: non-finite values")
        fail_unless(torch.equal(got, want),
                    f"sharded {name}: not bitwise the one-slot run "
                    f"(max_abs_err {max_err(got, want)})")
        rows.append({"leg": name, "shape": [kw["nx"], kw["ny"]],
                     "members": len(kw["cxs"]), "steps": kw["steps"],
                     "method": kw["method"], "seconds": seconds,
                     "launches": counts,
                     "steps_done": k.tolist() if conv else None})
    for name in ("ens_resident", "ens_tile_multi", "ens_tile_multi_conv"):
        fail_unless(total.get(name, 0) > 0,
                    f"kernel {name} never launched by the sharded "
                    f"ensembles")
    info = {"phase": "sharded_ensembles", "slots": len(devs),
            "cards": len(set(devs)), "launches": total, "legs": rows,
            "sensitivity": sens}
    emit(info)
    return info


def phase_spatial_ensembles(torch) -> dict:
    """(b) 2 members of 4096^2 x 240 on a 2x2 submesh of 4 slots of the
    card, collective and fused; each member bit for bit the port's
    dist2d run of the same (cx, cy)."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.models import ensemble
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    from heat2d_tpu_torch.parallel.mesh import host_devices
    devs = host_devices(4)
    cxs, cys = [0.1, 0.2], [0.15, 0.05]
    refs = [Heat2DSolver(HeatConfig(nxprob=4096, nyprob=4096, steps=240,
                                    mode="dist2d", gridx=2, gridy=2, cx=cx,
                                    cy=cy), devices=devs).run(timed=False).u
            for cx, cy in zip(cxs, cys)]
    rows = []
    for halo in ("collective", "fused"):
        t0 = time.perf_counter()
        batch, ks = ensemble.run_ensemble_spatial(
            4096, 4096, 240, cxs, cys, gridx=2, gridy=2, halo=halo,
            devices=devs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fail_unless(ks.tolist() == [240, 240],
                    f"spatial {halo}: steps_done {ks.tolist()}")
        for m, ref in enumerate(refs):
            got = batch[m].cpu().numpy()
            fail_unless(bool((got == ref).all()),
                        f"spatial {halo} member {m}: not bitwise the "
                        f"dist2d run")
        rows.append({"halo": halo, "seconds": seconds})
    info = {"phase": "spatial_ensembles", "slots": len(devs),
            "cards": len(set(devs)), "members": len(cxs),
            "shape": [4096, 4096], "steps": 240, "runs": rows}
    emit(info)
    return info


def phase_mesh_serving(torch) -> dict:
    """(c) A ``SolveServer`` over ``MeshEnsembleEngine(host_devices(4),
    fault=FaultPolicy(abft=True))`` with ``MeshAdmission``: 8 requests of
    640x1024 x 10000 (batch route, H5 per slot, ABFT verified), 2 of
    4096^2 x 240 method jnp (spatial by the default threshold, the card's
    on-chip total), 4 heat9 requests of 640x1024 x 2000 (batch route,
    H8); each answer bit for bit the one-card engine's; the halo plan
    stamped compiled; a resubmission is a cache hit."""
    from heat2d_tpu_torch.mesh import (FaultPolicy, MeshAdmission,
                                       MeshEnsembleEngine)
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.parallel.mesh import host_devices
    from heat2d_tpu_torch.serve.engine import EnsembleEngine
    from heat2d_tpu_torch.serve.schema import SolveRequest
    from heat2d_tpu_torch.serve.server import SolveServer
    devs = host_devices(4)
    legs = {
        "batch": [SolveRequest(nx=640, ny=1024, steps=10000,
                               cx=0.03 + 0.02 * i, cy=0.19 - 0.02 * i)
                  for i in range(8)],
        "spatial": [SolveRequest(nx=4096, ny=4096, steps=240,
                                 cx=0.05 * (i + 1), cy=0.1, method="jnp")
                    for i in range(2)],
        "heat9": [SolveRequest(nx=640, ny=1024, steps=2000,
                               cx=0.01 + 0.01 * i, cy=0.1,
                               problem="heat9") for i in range(4)],
    }
    registry = MetricsRegistry()
    engine = MeshEnsembleEngine(registry=registry, devices=devs,
                                fault=FaultPolicy(abft=True))
    admission = MeshAdmission(registry=registry, devices=devs,
                              per_chip_mcells_per_s=1e9)
    server = SolveServer(registry=registry, engine=engine,
                         admission=admission, max_delay=0.5,
                         default_timeout=600.0)
    answers, seconds = {}, {}
    reset_counts()
    with server:
        for name, reqs in legs.items():
            t0 = time.perf_counter()
            answers[name] = [f.result(timeout=900)
                             for f in [server.submit(r) for r in reqs]]
            seconds[name] = time.perf_counter() - t0
        hit = server.submit(legs["batch"][0]).result(timeout=60)
    counts = read_counts()
    fail_unless(hit.cache_hit and hit.u.tobytes()
                == answers["batch"][0].u.tobytes(),
                "mesh serving: the resubmission was not a bitwise cache "
                "hit")
    routes = {}
    single = EnsembleEngine(max_batch=8)
    for name, reqs in legs.items():
        want = single.solve_batch(reqs)
        got = answers[name]
        fail_unless([a.steps_done for a in got] == [k for _, k in want],
                    f"mesh serving {name}: steps_done differ")
        for a, (w, _) in zip(got, want):
            fail_unless(bool(torch.isfinite(torch.from_numpy(a.u)).all()),
                        f"mesh serving {name}: non-finite values")
            fail_unless(a.u.tobytes() == w.tobytes(),
                        f"mesh serving {name}: not bitwise the one-card "
                        f"engine")
        routes[name] = engine.scheduler.decide(reqs[0])["route"]
    fail_unless(routes == {"batch": "batch", "spatial": "spatial",
                           "heat9": "batch"}, f"mesh routes {routes}")
    plan = engine.halo_plans[legs["spatial"][0].signature()]
    fail_unless(plan.get("compiled") is True and plan["mesh"] == (2, 2),
                f"the spatial halo plan was not stamped compiled: {plan}")
    for name in ("ens_resident", "fam_resident"):
        fail_unless(counts.get(name, 0) > 0,
                    f"kernel {name} never launched by mesh serving")
    c = registry.snapshot()["counters"]
    fail_unless(c.get("mesh_abft_checked_total", 0) >= 8
                and not c.get("mesh_abft_mismatch_total"),
                f"ABFT on the batch route: {c}")
    fail_unless(not c.get("mesh_admission_shed_total"),
                "the admission model shed a request")
    rows = [{"signature": str(r["signature"]), "route": r["mesh"]["route"],
             "occupancy": r["occupancy"], "capacity": r["capacity"],
             "setup_s": r.get("setup_s"), "run_s": r.get("run_s"),
             "readback_s": r.get("readback_s")}
            for r in engine.launch_log]
    info = {"phase": "mesh_serving", "slots": len(devs),
            "cards": len(set(devs)), "launches": counts, "routes": routes,
            "spatial_bytes_threshold":
                engine.scheduler.spatial_bytes_threshold,
            "halo_plan": {k: list(v) if isinstance(v, tuple) else v
                          for k, v in plan.items()},
            "leg_seconds": seconds, "launch_rows": rows,
            "abft_checked": c.get("mesh_abft_checked_total")}
    emit(info)
    return info


def phase_mesh_fault(torch) -> dict:
    """(d) ``chaos_gate.run_gate`` on 4 slots of the card: device loss,
    silent bit flip (detected by ABFT and recomputed), hung launch; each
    recovered bit for bit with the serving invariant holding."""
    from heat2d_tpu_torch.mesh import chaos_gate
    from heat2d_tpu_torch.parallel.mesh import host_devices
    t0 = time.perf_counter()
    payload = chaos_gate.run_gate(host_devices(4))
    seconds = time.perf_counter() - t0
    rows = {s["scenario"]: s for s in payload["scenarios"]}
    fail_unless(payload["passed"], f"mesh chaos gate failed: {rows}")
    flips = rows["bit_flip"]["counters"].get("mesh_abft_mismatch_total", 0)
    fail_unless(flips >= 1, "the ABFT tier did not detect the flip")
    info = {"phase": "mesh_fault", "seconds": seconds,
            "scenarios": {n: {k: s[k] for k in (
                "bitwise", "recovery_s", "e2e_recovered_s", "requeues",
                "quarantined")} for n, s in rows.items()},
            "abft_mismatches": flips}
    emit(info)
    return info


def phase_strong_scaling(torch) -> dict:
    """(e) ``measure_strong_scaling(4, 4096, 4096, 240, mode="hybrid")``
    on 4 slots of the card, collective (H12) and fused (H14): the
    records, and how many cards the slots span (one card: the ratio is
    what the decomposition costs there, not scaling)."""
    from heat2d_tpu_torch.parallel.mesh import host_devices
    from heat2d_tpu_torch.parallel.scaling import measure_strong_scaling
    devs = host_devices(4)
    total, records = {}, []
    for halo in ("collective", "fused"):
        reset_counts()
        rec = measure_strong_scaling(4, 4096, 4096, 240, halo=halo,
                                     mode="hybrid", devices=devs)
        counts = read_counts()
        add_counts(total, counts)
        want = "ici" if halo == "fused" else "collective"
        fail_unless(rec["halo_tier"] == want,
                    f"scaling {halo}: tier {rec['halo_tier']}")
        name = "shard_fused" if halo == "fused" else "shard_tile_multi"
        fail_unless(counts[name] > 0, f"scaling {halo}: {name} never "
                    f"launched")
        fail_unless(math.isfinite(rec["strong_scaling_efficiency"]),
                    f"scaling {halo}: {rec}")
        records.append(rec)
        emit({"phase": "strong_scaling_record", "cards": len(set(devs)),
              **rec})
    info = {"phase": "strong_scaling", "slots": len(devs),
            "cards": len(set(devs)), "launches": total,
            "records": records}
    return info


# ------------------------------------------------------------------ #
# slice 7: worlds of several processes on the card
# ------------------------------------------------------------------ #

def _world_run(torch, name: str, cfg, reference, extra=(), env=None,
               steps_done=None) -> dict:
    """One 2-process world of the port's CLI on the card (rank r on
    ``cuda:(r % count)``, two slots each, the 2x2 mesh spanning both),
    spawned by ``dist.harness.spawn_world``, with per-shard binary dumps
    and no gather, ``extra`` flags and ``env`` (``dist.harness.clean_env``
    overrides); its ``final_binary.dat`` against ``reference`` (the
    one-process run's ``RunResult``) bit for bit, steps_done equal (or
    ``steps_done``, for a resumed world)."""
    import shutil
    import tempfile

    from heat2d_tpu_torch.dist.harness import (clean_env, first_error_line,
                                               spawn_world)
    d = tempfile.mkdtemp(prefix=f"heat2d-{name}-")
    rec_path = os.path.join(d, "rec.json")
    args = ["--mode", cfg.mode, "--gridx", str(cfg.gridx), "--gridy",
            str(cfg.gridy), "--nxprob", str(cfg.nxprob), "--nyprob",
            str(cfg.nyprob), "--steps", str(cfg.steps), "--binary-dumps",
            "--dat-layout", "none", "--run-record", rec_path,
            "--outdir", d, "--host-device-count", "2"]
    if cfg.convergence:
        args += ["--convergence", "--interval", str(cfg.interval),
                 "--sensitivity", str(cfg.sensitivity)]
    t0 = time.perf_counter()
    args += list(extra)
    res = spawn_world(2, lambda i, coord: [
        sys.executable, "-m", "heat2d_tpu_torch.cli", "--coordinator",
        coord, "--num-processes", "2", "--process-id", str(i)] + args,
        env=clean_env(env), timeout=300)
    wall = time.perf_counter() - t0
    outs = [r.output for r in res]
    fail_unless(all(r.ok for r in res),
                f"{name}: world exited {[r.returncode for r in res]}: "
                f"{first_error_line(outs)}\n" + "\n".join(
                    o[-2000:] for o in outs))
    with open(rec_path) as f:
        rec = json.load(f)
    import numpy as np
    got = np.fromfile(os.path.join(d, "final_binary.dat"), np.float32)
    shutil.rmtree(d)
    want = np.ascontiguousarray(reference.u, np.float32).reshape(-1)
    fail_unless(got.size == want.size and bool(np.isfinite(got).all()),
                f"{name}: final_binary.dat has {got.size} values")
    fail_unless(got.tobytes() == want.tobytes(),
                f"{name}: final_binary.dat differs from the one-process "
                f"run (max_abs_err {float(np.abs(got - want).max())})")
    want_steps = reference.steps_done if steps_done is None else steps_done
    fail_unless(rec["steps_done"] == want_steps,
                f"{name}: steps_done {rec['steps_done']} vs {want_steps}")
    fail_unless(rec["halo"]["tier"] == "collective",
                f"{name}: tier {rec['halo']['tier']}")
    ex = rec["exchange_by_process"]
    fail_unless(all(e["exchanges"] > 0 and e["seconds"] > 0 for e in ex),
                f"{name}: no timed exchange across ranks: {ex}")
    launches = {}
    for row in rec["launches_by_process"]:
        add_counts(launches, row)
    row = {"leg": name, "shape": list(cfg.shape), "steps": cfg.steps,
           "convergence": cfg.convergence, "route": rec["route"],
           "steps_done": rec["steps_done"], "bitwise": True,
           "elapsed_by_process_s": rec["elapsed_by_process"],
           "max_over_processes_s": rec["elapsed_s"],
           "mcells_per_s": rec["mcells_per_s"],
           "one_process_elapsed_s": reference.elapsed,
           "one_process_mcells_per_s": reference.mcells_per_s,
           "world_wall_s": wall, "warmup_s": rec.get("warmup_s"),
           "launches": launches,
           "timed_chunks": [e["exchanges"] for e in ex],
           "exchange_ms_per_chunk": [
               1e3 * e["seconds"] / e["exchanges"] for e in ex],
           "exchange_bytes_per_chunk": [e["bytes"] / e["exchanges"]
                                        for e in ex],
           "exchange_share_of_elapsed": [
               e["seconds"] / s for e, s in zip(
                   ex, rec["elapsed_by_process"])],
           "host_staged_bytes_per_s": [e["bytes"] / e["seconds"]
                                       for e in ex],
           "exchange_by_process": ex,
           "resuming_lines": [ln for o in outs for ln in o.splitlines()
                              if ln.startswith("Resuming from step")]}
    for key in ("checkpoints_written", "checkpoint_timings",
                "resume_from_step"):
        if key in rec:
            row[key] = rec[key]
    emit({"phase": "multi_process_run", **row})
    return row


def phase_multi_process(torch, name: str, power: str) -> dict:
    """Worlds of 2 processes on the one card (gloo, strips staged through
    pinned host buffers): (a) hybrid 4096^2 x 240 on a 2x2 mesh, two
    2048^2 shards a process (H12 per rank), writing collective managed
    snapshots at steps 120 and 240 under HEAT2D_FORBID_GATHER; (a2) step
    240's snapshot torn, a world resumes from the directory's
    ``latest_valid()`` (step 120) under the same tripwire, bit for bit
    (a)'s reference; (b) the same with
    convergence at 1024^2 (H13 per rank), stopping at step 140 of 240,
    each bit for bit the one-process hybrid run on ``host_devices(4)``;
    (c) the dist worker's ``--selftest`` at 4096^2 x 64, segment 8 (the
    store halo route), bitwise the one-process program and the plain
    loop. Each rank's and
    the slowest rank's elapsed, Mcells/s beside the one-process run's,
    the host-staged exchange's ms and bytes per timed chunk, its share
    and rate, the store halo bytes; the workers' H12/H13 launches, read
    from their records."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.dist import cli as dcli
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    from heat2d_tpu_torch.parallel.mesh import host_devices
    devs = host_devices(4)
    fixed = HeatConfig(nxprob=4096, nyprob=4096, steps=240, mode="hybrid",
                       gridx=2, gridy=2)
    conv = fixed.replace(nxprob=1024, nyprob=1024, convergence=True,
                         interval=20)
    # a sensitivity between the one-process run's 6th and 7th residuals,
    # so that it exits at step 140 of 240: the world must take that same
    # early exit on every rank (its residuals are the one-process run's
    # bit for bit, so no margin for rounding is needed)
    trace = residual_trace(torch, conv, devs, None)
    exit_step = 7 * conv.interval
    conv = conv.replace(sensitivity=math.sqrt(trace[5] * trace[6]))
    rows, launches = [], {}
    import tempfile
    ck = tempfile.mkdtemp(prefix="heat2d-world-ck-") + os.sep
    nogather = {"HEAT2D_FORBID_GATHER": "1"}
    for leg, cfg in (("a_hybrid_4096", fixed), ("b_convergence_1024",
                                                  conv)):
        ref = Heat2DSolver(cfg, devices=devs).run()
        fail_unless(not cfg.convergence or ref.steps_done == exit_step,
                    f"{leg}: the one-process run stopped at "
                    f"{ref.steps_done}, not {exit_step} (residuals "
                    f"{trace})")
        # (a) also writes collective managed snapshots at 120 and 240
        extra = (["--checkpoint", ck, "--checkpoint-every", "120"]
                 if not cfg.convergence else [])
        row = _world_run(torch, leg, cfg, ref, extra=extra,
                         env=nogather if extra else None)
        add_counts(launches, row["launches"])
        rows.append(row)
        if cfg.convergence:
            continue
        # (a2) the managed resume across processes: step 240's snapshot
        # torn, a world resumes from latest_valid() (120), H12 per rank,
        # no rank gathering the grid
        from heat2d_tpu_torch.resil import CheckpointManager
        m = CheckpointManager(ck, keep=None)
        fail_unless(m.steps() == [120, 240],
                    f"{leg}: manifest steps {m.steps()}")
        import numpy as np
        with open(m.path_for(240), "rb") as f:
            fail_unless(f.read() == np.ascontiguousarray(
                ref.u, np.float32).tobytes(),
                f"{leg}: the step-240 snapshot is not the final grid")
        with open(m.path_for(240), "r+b") as f:
            f.write(b"\xff" * 64)
        row = _world_run(torch, "a2_managed_resume_4096", fixed, ref,
                         extra=["--resume", ck], env=nogather,
                         steps_done=120)
        fail_unless(row.get("resume_from_step") == 120
                    and row["resuming_lines"] == ["Resuming from step 120"],
                    f"a2: did not resume from step 120: {row}")
        add_counts(launches, row["launches"])
        rows.append(row)
    import shutil
    shutil.rmtree(ck, ignore_errors=True)
    fail_unless(launches.get("shard_tile_multi", 0) > 0
                and launches.get("shard_tile_multi_resid", 0) > 0,
                f"the workers did not launch H12 and H13: {launches}")
    d = tempfile.mkdtemp(prefix="heat2d-selftest-")
    t0 = time.perf_counter()
    rc = dcli.main(["--selftest", "--nx", "4096", "--ny", "4096",
                    "--steps", "64", "--segment", "8", "--timeout", "300",
                    "--outdir", d])
    rec_path = os.path.join(d, "selftest_record.json")
    st = None
    if os.path.exists(rec_path):
        with open(rec_path) as f:
            st = json.load(f)
    shutil.rmtree(d)
    fail_unless(rc == 0 and st is not None,
                f"heat2d-tpu-torch-dist --selftest exited {rc}")
    fail_unless(st["bitwise_equal"] and st["bitwise_vs_plain_loop"],
                f"dist selftest not bitwise: {st}")
    selftest = {"leg": "c_selftest", "shape": [4096, 4096], "steps": 64,
                "segment": 8, "bitwise": True,
                "kv_halo_bytes_process0": st["halo_bytes"],
                "worker_run_s": st["worker_run_s"],
                "world_s": st["world_s"],
                "wall_s": time.perf_counter() - t0}
    emit({"phase": "multi_process_selftest", **selftest})
    info = {"phase": "multi_process", "card": name, "power_limit": power,
            "launches": launches}
    emit(info)
    return {**info, "runs": rows, "selftest": selftest}


def shard_chunk_ms(torch, devs) -> dict:
    """One T = 8 chunk of the 2x2 mesh of 4096^2 on the card, by CUDA
    events: the collective route (the exchange, then four H12 launches)
    and the fused one (one H14 launch)."""
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.parallel import mesh, sharded
    cfg = HeatConfig(nxprob=4096, nyprob=4096, mode="hybrid", gridx=2,
                     gridy=2)
    m = mesh.make_mesh(2, 2, devs)
    grid = sharded.sharded_inidat(cfg, m)
    out = {}
    for route in ("collective", "fused"):
        chunk = sharded.make_local_chunk(cfg.replace(halo=route), m,
                                         kernel=True)
        out[route] = time_ms(lambda: chunk(grid, 8), 20)
    return out


def shard_kernel_rows(torch) -> list:
    """H12-H14 at the sharded path's shapes: H12/H13 on one 2048^2 shard
    of the 2x2 mesh of 4096^2, one T = 8 sweep; H14 as its one launch for
    all four shards. No PyTorch call advances a shard T steps from its
    strips, so no library time. H12's and H14's ``plan``: the tiles, and
    the tiles by path as one launch counted them. H12/H13's ``device_ms``: the same
    calls with the host's enqueue hidden (``time_device_ms``)."""
    from heat2d_tpu_torch.ops import cuda_shard as csh
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.parallel.halo import exchange_halo_strips
    cx, cy, t, n, bm = 0.1, 0.1, 8, 4096, 2048
    full = inidat(n, n, device="cuda")
    blocks = [[full[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm].contiguous()
               for j in range(2)] for i in range(2)]
    u, st = blocks[0][0], exchange_halo_strips(blocks, t)[0][0]
    args = (t, 0, 0, n, n, cx, cy)
    cells = bm * bm
    moved = 4 * (2 * cells + 2 * t * bm + 2 * (bm + 2 * t) * t)
    rows = []
    b, by = bound_ms(moved, update_flops() * cells * t)
    rows.append(dict(
        name="shard_tile_multi",
        shape="one 2048^2 shard of a 2x2 mesh of 4096^2, one T=8 sweep",
        ms=time_ms(lambda: csh.shard_tile_multi(u, st, *args), 20),
        plain_ms=time_ms(lambda: csh.shard_tile_multi_plain(u, st, *args),
                         5),
        bound_ms=b, bound_by=by, library_ms=None,
        device_ms=time_device_ms(
            lambda: csh.shard_tile_multi(u, st, *args), 20)))
    plan = cs.plan_strip_sweep(bm, bm, t, caps_of(torch)[1])
    counted = csh.path_counter("cuda")
    csh.shard_tile_multi(u, st, *args, paths=counted)
    rows[-1]["plan"] = {"tile": [plan.ty, plan.tx], "ring": plan.tsteps,
                        "warps": cs.STRIP_WARPS,
                        **dict(zip(csh.TILE_PATHS, counted.tolist()))}
    ntiles = plan.ntiles
    b, by = bound_ms(moved + 4 * ntiles,
                     update_flops() * cells * t + 3 * cells)
    rows.append(dict(
        name="shard_tile_multi_resid",
        shape="one 2048^2 shard, one T=8 sweep + residual",
        ms=time_ms(lambda: csh.shard_tile_multi_resid(u, st, *args), 20),
        plain_ms=time_ms(
            lambda: csh.shard_tile_multi_resid_plain(u, st, *args), 5),
        bound_ms=b, bound_by=by, library_ms=None,
        device_ms=time_device_ms(
            lambda: csh.shard_tile_multi_resid(u, st, *args), 20)))
    b, by = bound_ms(2 * 4 * n * n, update_flops() * n * n * t)
    fplan = cs.tile_plan(bm, bm, t, "cuda")
    counted = csh.path_counter("cuda")
    csh.shard_fused(blocks, t, n, n, cx, cy, paths=counted)
    rows.append(dict(
        name="shard_fused",
        shape="four 2048^2 shards (2x2 mesh of 4096^2), one T=8 sweep, "
              "one launch",
        ms=time_ms(lambda: csh.shard_fused(blocks, t, n, n, cx, cy), 20),
        plan={"tile": [fplan.ty, fplan.tx], "ring": fplan.tsteps,
              "warps": cs.STRIP_WARPS, "strip": csh.FUSED_STRIP,
              **dict(zip(csh.TILE_PATHS, counted.tolist()))},
        plain_ms=time_ms(lambda: csh.shard_fused_plain(blocks, t, n, n, cx,
                                                       cy), 3),
        bound_ms=b, bound_by=by, library_ms=None))
    return rows


# ------------------------------------------------------------------ #
# slice 8a: the tuning subsystem on the card
# ------------------------------------------------------------------ #

#: The tune phase's searches: (problem, routes). The fused problem is the
#: shard of a 2x2 mesh of 4096^2 on host_devices(4) of the card.
TUNE_SEARCHES = (((4096, 4096), ("tile",)),
                 ((640, 1024), ("resident", "tile")),
                 ((2048, 2048), ("fused",)))
#: Steps of the bitwise check of every measured candidate, by problem.
TUNE_CHECK_STEPS = {(4096, 4096): 240, (640, 1024): 10000,
                    (2048, 2048): 240}
TUNE_REPS = 2


def _grids_equal(torch, a, b) -> bool:
    """Bitwise equality of two grids, or of two ShardedGrids block by
    block."""
    if hasattr(a, "tensors"):
        return all(torch.equal(x, y) for x, y in zip(a.tensors(),
                                                     b.tensors()))
    return torch.equal(a, b)


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output dropped (the CLI's banner
    and ``Writing ...`` lines)."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _cli_run(outdir, nx, ny, steps) -> tuple:
    """The solver CLI in mode pallas on the card: (run record, the bytes
    of final_binary.dat)."""
    from heat2d_tpu_torch.cli import main as cli_main
    rec = os.path.join(outdir, "rec.json")
    rc = _quiet(cli_main, ["--mode", "pallas", "--nxprob", str(nx),
                           "--nyprob", str(ny), "--steps", str(steps),
                           "--dat-layout", "none", "--binary-dumps",
                           "--outdir", outdir, "--run-record", rec])
    fail_unless(rc == 0, f"cli {nx}x{ny}: rc {rc}")
    with open(rec) as f, open(os.path.join(outdir, "final_binary.dat"),
                              "rb") as g:
        return json.load(f), g.read()


def tune_h6_depths(torch) -> dict:
    """H6/H7 at the depths and tile heights the db may give them, bitwise
    H6/H7 at the planner's T = 8 (frozen members and all): 3 members of
    1000x1100, 60 steps."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    u = torch.rand((3, 1000, 1100), generator=g, device="cuda") * 100
    cxs = torch.tensor([0.05, 0.1, 0.2], device="cuda")
    cys = torch.tensor([0.1, 0.2, 0.05], device="cuda")
    act = torch.tensor([1, 0, 1], dtype=torch.int32, device="cuda")
    want = ce.ens_tiled_chunk(u, 60, cxs, cys)
    want_act = ce.ens_tiled_chunk(u, 60, cxs, cys, act)
    checked = []
    for t, ty in ((4, 16), (12, 32), (16, 32), (8, 16)):
        fail_unless(torch.equal(ce.ens_tiled_chunk(
            u, 60, cxs, cys, tsteps=t, ty=ty), want),
            f"H6 at T={t} ty={ty} differs from T=8")
        fail_unless(torch.equal(ce.ens_tiled_chunk(
            u, 60, cxs, cys, act, tsteps=t, ty=ty), want_act),
            f"H7 at T={t} ty={ty} differs from T=8")
        checked.append([t, ty])
    return {"members": 3, "shape": [1000, 1100], "steps": 60,
            "t_ty": checked}


def phase_tune(torch, name: str, power: str) -> dict:
    """The tuning subsystem on the card, its db in a temporary directory:

    (a) search on the card's real backend: 4096^2 on the tile route (its
    T ladder and tile heights), 640x1024 on the resident (the K ladder)
    and tile routes, the fused route on the 2048^2 shards of a 2x2 mesh
    of 4096^2 on host_devices(4) (its T ladder); the frontier table, and
    each shape's planner point beside its best;
    (b) resume: a second search over the same file measures no point;
    (c) bitwise: every measured candidate after 240 steps (4096^2, and
    the fused mesh) or 10,000 (640x1024) equals the default plan's, and
    H6/H7 at the depths the db may give them equal T = 8;
    (d) apply: with ``set_tuning_db`` the main path (the solver CLI) at
    4096^2 x 240 and 640x1024 x 10000 is bitwise the untuned run and its
    record's ``tuned_config`` names the db's best (source exact) where
    the main path's route takes it; a hybrid --halo fused 2x2 run is
    bitwise at the db's depth; a serving request at 640x1024 carries the
    db's answer in its launch row, bitwise; the mesh scheduler's
    decision carries the db's rate;
    (e) clear: the plans are the defaults again."""
    import io
    import shutil
    import tempfile

    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.mesh.scheduler import MeshScheduler
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.parallel.mesh import host_devices
    from heat2d_tpu_torch.serve.engine import EnsembleEngine
    from heat2d_tpu_torch.serve.schema import SolveRequest
    from heat2d_tpu_torch.tune import cli as tcli
    from heat2d_tpu_torch.tune import runtime as tr
    from heat2d_tpu_torch.tune.db import TuningDB
    from heat2d_tpu_torch.tune.measure import candidate_runner
    from heat2d_tpu_torch.tune.space import Candidate, Problem, planner_pick

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="heat2d-tune-")
    path = os.path.join(tmp, "tune_db.json")
    kind = tr.device_kind("cuda")
    problems = [(Problem(*shape), routes) for shape, routes in
                TUNE_SEARCHES]

    # (a) search
    searches, log = [], []
    db = TuningDB(path)
    for problem, routes in problems:
        buf = io.StringIO()
        s = tcli.search_problem(db, problem, routes=routes, reps=TUNE_REPS,
                                device="cuda", out=buf)
        log.append(buf.getvalue())
        fail_unless(s["measured"] > 0 and s["failed"] == 0,
                    f"tune search {problem.key()}: {s}\n{buf.getvalue()}")
        searches.append(s)
    t_search = time.perf_counter() - t0
    table = tcli.frontier_table(TuningDB(path), kind)
    print(table, flush=True)
    rows = []
    for problem, _ in problems:
        for r in tcli.planner_rows(TuningDB(path), kind, problem, "cuda"):
            fail_unless(r["planner_point"] is not None,
                        f"tune {r['key']}: the planner's point "
                        f"{r['planner']} was not measured")
            row = {"key": r["key"], "route": r["route"],
                   "planner": r["planner"],
                   "planner_step_ms": r["planner_point"]["step_time_s"]
                   * 1e3,
                   "best": Candidate(r["route_best"]["route"],
                                     r["route_best"]["bm"],
                                     r["route_best"]["tsteps"]).label(),
                   "best_step_ms": r["route_best"]["step_time_s"] * 1e3,
                   "best_steps": r["route_best"].get("steps"),
                   "frontier_best": r["is_best"]}
            rows.append(row)
            emit({"phase": "tune_frontier", **row})

    # (b) resume
    db2 = TuningDB(path)
    for problem, routes in problems:
        s = tcli.search_problem(db2, problem, routes=routes, reps=TUNE_REPS,
                                device="cuda", out=io.StringIO())
        fail_unless(s["measured"] == 0 and s["cached"] > 0,
                    f"tune resume {problem.key()} measured again: {s}")

    # (c) bitwise: every measured candidate against the default plan
    checked = 0
    for problem, _ in problems:
        n = TUNE_CHECK_STEPS[(problem.nx, problem.ny)]
        fused = problem.nx == 2048
        key = problem.fused_key() if fused else problem.key()
        if fused:
            ref_fn, u0 = candidate_runner(
                problem, planner_pick(problem, "fused", "cuda"), "cuda")
        else:
            ref_fn = cs.make_single_chip_runner(HeatConfig(
                nxprob=problem.nx, nyprob=problem.ny, steps=0,
                mode="pallas"), "cuda").chunk
            u0 = inidat(problem.nx, problem.ny, device="cuda")
        want = ref_fn(u0, n)
        for p in TuningDB(path).entry(kind, key)["points"]:
            if p["status"] != "ok":
                continue
            cand = Candidate(p["route"], p["bm"], p["tsteps"])
            fn, u = candidate_runner(problem, cand, "cuda")
            fail_unless(_grids_equal(torch, fn(u, n), want),
                        f"tune {key} {cand.label()}: {n} steps differ "
                        f"from the default plan's")
            checked += 1
    h6 = tune_h6_depths(torch)

    # (d) apply
    untuned = {}
    for nx, ny, steps in ((4096, 4096, 240), (640, 1024, 10000)):
        d = os.path.join(tmp, f"base{nx}")
        untuned[(nx, ny)] = _cli_run(d, nx, ny, steps)
    devs = host_devices(4)
    hyb = HeatConfig(nxprob=4096, nyprob=4096, steps=240, mode="hybrid",
                     gridx=2, gridy=2, halo="fused")
    hyb_base = Heat2DSolver(hyb, devices=devs).run(timed=False)
    req = SolveRequest(nx=640, ny=1024, steps=10000, cx=0.1, cy=0.1)
    best640 = TuningDB(path).entry(kind, "640x1024:float32")["best"]
    if best640["route"] == "tile":
        req = SolveRequest(nx=640, ny=1024, steps=10000, cx=0.1, cy=0.1,
                           method="band")
    serve_base = EnsembleEngine(max_batch=8).solve_batch([req])[0][0]

    tr.set_tuning_db(path)
    try:
        applied = {}
        for (nx, ny), (rec0, bytes0) in untuned.items():
            tr.reset_applied()
            rec, got = _cli_run(os.path.join(tmp, f"tuned{nx}"), nx, ny,
                                rec0["steps_done"])
            fail_unless(got == bytes0, f"tuned main path {nx}x{ny}: "
                        f"final_binary.dat differs from the untuned run")
            best = TuningDB(path).entry(kind, f"{nx}x{ny}:float32")["best"]
            takes = "resident" if cs.fits_resident((nx, ny),
                                                   "cuda") else "tile"
            tuned = rec.get("tuned_config") or []
            if best["route"] == takes:
                fail_unless(len(tuned) == 1 and tuned[0]["source"] == "exact"
                            and {k: tuned[0][k] for k in best} == best,
                            f"tuned main path {nx}x{ny}: tuned_config "
                            f"{tuned} does not name the db's best {best}")
            else:
                fail_unless(not tuned, f"{nx}x{ny}: the db's best {best} "
                            f"is not the main path's route {takes}, yet "
                            f"tuned_config is {tuned}")
            applied[f"{nx}x{ny}"] = {"best": best, "route": takes,
                                     "tuned_config": tuned}
            emit({"phase": "tune_apply", "shape": [nx, ny],
                  **applied[f"{nx}x{ny}"]})
        fbest = TuningDB(path).entry(kind, "fused:2048x2048:float32")["best"]
        hyb_got = Heat2DSolver(hyb, devices=devs).run(timed=False)
        fail_unless(hyb_got.halo["depth"] == fbest["tsteps"]
                    and hyb_got.halo["tier"] == "ici",
                    f"tuned hybrid fused: halo {hyb_got.halo}, db best "
                    f"{fbest}")
        fail_unless(bool((hyb_got.u == hyb_base.u).all()),
                    "tuned hybrid fused differs from the untuned run")
        eng = EnsembleEngine(max_batch=8)
        serve_got = eng.solve_batch([req])[0][0]
        row = eng.launch_log[-1]["tuned_config"]
        fail_unless(row is not None and {k: row[k] for k in best640}
                    == best640, f"serve 640x1024: tuned_config {row}, db "
                    f"best {best640}")
        fail_unless(bool((serve_got == serve_base).all()),
                    "tuned serving request differs from the untuned one")
        rate = TuningDB(path).entry(kind, "640x1024:float32")["mcells_per_s"]
        decision = MeshScheduler(devices=devs).decide(req)
        fail_unless(decision["tuned_mcells_per_s"] == rate,
                    f"scheduler rate {decision['tuned_mcells_per_s']} != "
                    f"the db's {rate}")
    finally:
        tr.set_tuning_db(None)

    # (e) clear
    for nx, ny in ((4096, 4096), (640, 1024)):
        cfg = HeatConfig(nxprob=nx, nyprob=ny, steps=1, mode="pallas")
        plan = cs.make_single_chip_runner(cfg).plan
        default = (cs.resident_plan(nx, ny, "cuda")
                   if cs.fits_resident((nx, ny), "cuda")
                   else cs.tile_plan(nx, ny, cs.DEFAULT_TSTEPS, "cuda"))
        fail_unless(plan == default, f"cleared db: {nx}x{ny} plan {plan} "
                    f"is not the default {default}")
    fail_unless(tr.applied_configs() == [], "cleared db still applied")
    out_db = os.path.join(HERE, "chiprun_out", "tune_db.json")
    os.makedirs(os.path.dirname(out_db), exist_ok=True)
    shutil.copyfile(path, out_db)
    shutil.rmtree(tmp)
    info = {"phase": "tune", "device": name, "power_limit": power,
            "search_s": t_search, "seconds": time.perf_counter() - t0,
            "measured": sum(s["measured"] for s in searches),
            "bitwise_checked": checked, "h6_depths": h6,
            "frontier": rows, "applied": applied,
            "fused_depth": fbest["tsteps"],
            "scheduler_mcells_per_s": rate, "search_log": log}
    emit({k: v for k, v in info.items() if k != "search_log"})
    return info


# ------------------------------------------------------------------ #
# resil: managed checkpoints, kill and resume, the build sentinel, the
# implicit gate
# ------------------------------------------------------------------ #

def _resil_cli(argv) -> tuple:
    """The solver CLI in process on the card: (rc, its standard output,
    the launches it made)."""
    import contextlib
    import io

    from heat2d_tpu_torch.analysis.launch_pin import launch_counts
    from heat2d_tpu_torch.cli import main as cli_main
    before = launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    after = launch_counts()
    return rc, buf.getvalue(), {k: after[k] - before.get(k, 0)
                                for k in after if after[k] - before.get(k, 0)}


def _resil_pair(tmp, name, base, every) -> dict:
    """``base`` uninterrupted and with ``--checkpoint DIR/
    --checkpoint-every every``: both records, final bytes, launches and
    wall seconds."""
    out = {}
    for leg, extra in (("whole", []),
                       ("segmented", ["--checkpoint",
                                      os.path.join(tmp, name + "_ck") + "/",
                                      "--checkpoint-every", str(every),
                                      "--checkpoint-keep", "0"])):
        d = os.path.join(tmp, f"{name}_{leg}")
        rec = os.path.join(d, "rec.json")
        t0 = time.perf_counter()
        rc, _, launches = _resil_cli(base + extra + [
            "--binary-dumps", "--dat-layout", "none", "--outdir", d,
            "--run-record", rec])
        wall = time.perf_counter() - t0
        fail_unless(rc == 0, f"resil {name} {leg}: rc {rc}")
        with open(rec) as f, open(os.path.join(d, "final_binary.dat"),
                                  "rb") as g:
            out[leg] = {"record": json.load(f), "bytes": g.read(),
                        "launches": launches, "wall_s": wall}
    a, b = out["whole"], out["segmented"]
    fail_unless(a["bytes"] == b["bytes"],
                f"resil {name}: the segmented run's grid differs")
    for key in ("steps_done", "route", "residual_reads"):
        fail_unless(a["record"][key] == b["record"][key],
                    f"resil {name}: {key} {a['record'][key]} vs "
                    f"{b['record'][key]}")
    return out


def _pinned_d2h_ms(torch, nbytes: int, reps: int = 5) -> dict:
    """One grid's device-to-host copy: pageable (``snapshot_state``'s
    ``.to("cpu", copy=True)``) against a pinned staging buffer."""
    n = nbytes // 4
    src = torch.rand(n, device="cuda")
    pinned = torch.empty(n, dtype=torch.float32, pin_memory=True)

    def pageable():
        src.to("cpu", copy=True)

    def staged():
        pinned.copy_(src)
    out = {}
    for key, fn in (("pageable_ms", pageable), ("pinned_ms", staged)):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[key] = min(times)
    return out


def phase_resil(torch, name: str, power: str) -> dict:
    """The resil and analysis modules on the card, through the solver
    CLI: (a) 4096^2 x 240 in mode pallas (H2), uninterrupted against
    ``--checkpoint DIR/ --checkpoint-every 48`` (5 snapshots), bitwise;
    (b) the same killed at the 3rd checkpoint's mid_write (a subprocess,
    ``HEAT2D_CHAOS_KILL_CKPT_AT=3``): rc 137, manifest [48, 96], a flight
    dump, then ``--resume DIR`` from step 96 bitwise (a); (c) 640x1024 x
    10000 (H4) every 2000 steps, bitwise; (d) convergence at 2048^2 (the
    smallest square past the resident gate, so H2 + H3), every 100 steps,
    stopping at the unsegmented run's step 160; (e) the build sentinel
    over the serve occupancy sweep (H5); (f) the implicit gate (H6,
    H10/H11)."""
    import shutil
    import tempfile

    from heat2d_tpu_torch.analysis import implicit_gate
    from heat2d_tpu_torch.analysis.launch_pin import launch_counts
    from heat2d_tpu_torch.analysis.recompile import serve_compile_report
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.resil import CheckpointManager

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="heat2d-resil-")
    launches: dict = {}
    legs = {}
    try:
        # (a) 4096^2 x 240 on H2
        base = ["--mode", "pallas", "--nxprob", "4096", "--nyprob", "4096",
                "--steps", "240"]
        a = _resil_pair(tmp, "a_4096", base, 48)
        seg = a["segmented"]["record"]
        fail_unless(seg["checkpoints_written"] == 5,
                    f"resil a: {seg['checkpoints_written']} checkpoints")
        # the same 5 fenced segments with no snapshot and no write: what
        # segmenting alone costs, apart from the writer beside it
        from heat2d_tpu_torch.models.solver import Heat2DSolver
        s48 = Heat2DSolver(HeatConfig(nxprob=4096, nyprob=4096, steps=48,
                                      mode="pallas"))
        u, bare_s = s48.init_state(), 0.0
        before = launch_counts()
        for i in range(5):
            r48 = s48.run(u0=u, warmup=i == 0, gather=False)
            u, bare_s = r48.u, bare_s + r48.elapsed
        del u
        add_counts(launches, {k: v - before.get(k, 0)
                              for k, v in launch_counts().items()})
        timings = seg["checkpoint_timings"]
        legs["a_4096x240"] = {
            "bitwise": True, "route": seg["route"],
            "elapsed_s": a["whole"]["record"]["elapsed_s"],
            "segmented_elapsed_s": seg["elapsed_s"],
            "segments_without_writer_s": bare_s,
            "wall_s": a["whole"]["wall_s"],
            "segmented_wall_s": a["segmented"]["wall_s"],
            "snapshot_d2h_ms": [1e3 * x["snapshot_s"] for x in timings],
            "write_sha256_commit_ms": [1e3 * x["write_s"]
                                       for x in timings],
            "launches": a["whole"]["launches"],
            "segmented_launches": a["segmented"]["launches"],
            "d2h_64mib": _pinned_d2h_ms(torch, 4096 * 4096 * 4)}
        for leg in a.values():
            add_counts(launches, leg["launches"])

        # (b) killed at the 3rd checkpoint, mid_write; resumed
        from heat2d_tpu_torch.dist.harness import clean_env
        ck = os.path.join(tmp, "b_ck") + os.sep
        flight = os.path.join(tmp, "b_flight")
        env = {k: v for k, v in clean_env().items()
               if not k.startswith("HEAT2D_CHAOS_")}
        env.update(HEAT2D_CHAOS_KILL_CKPT_AT="3",
                   HEAT2D_FLIGHT_DIR=flight)
        tk = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "heat2d_tpu_torch.cli"] + base
            + ["--dat-layout", "none", "--outdir",
               os.path.join(tmp, "b_killed"), "--checkpoint", ck,
               "--checkpoint-every", "48"],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
        killed_s = time.perf_counter() - tk
        fail_unless(r.returncode == 137,
                    f"resil b: the killed run exited {r.returncode}: "
                    f"{r.stderr[-2000:]}")
        steps = CheckpointManager(ck, keep=None).steps()
        fail_unless(steps == [48, 96], f"resil b: manifest steps {steps}")
        dumps = os.listdir(flight) if os.path.isdir(flight) else []
        fail_unless(bool(dumps), "resil b: no flight-recorder dump")
        d = os.path.join(tmp, "b_resumed")
        rc, out, got = _resil_cli(base + [
            "--resume", ck, "--binary-dumps", "--dat-layout", "none",
            "--outdir", d])
        fail_unless(rc == 0 and "Resuming from step 96" in out,
                    f"resil b: resume rc {rc}: {out[-500:]}")
        with open(os.path.join(d, "final_binary.dat"), "rb") as f:
            fail_unless(f.read() == a["whole"]["bytes"],
                        "resil b: the resumed grid differs from (a)")
        add_counts(launches, got)
        legs["b_kill_resume"] = {"rc": r.returncode, "manifest": steps,
                                 "flight_dumps": dumps,
                                 "killed_run_wall_s": killed_s,
                                 "resumed_from": 96, "bitwise": True,
                                 "launches": got}

        # (c) 640x1024 x 10000 on H4
        c = _resil_pair(tmp, "c_640x1024", [
            "--mode", "pallas", "--nxprob", "640", "--nyprob", "1024",
            "--steps", "10000"], 2000)
        fail_unless(c["segmented"]["record"]["route"] == "resident",
                    f"resil c: route {c['segmented']['record']['route']}")
        ct = c["segmented"]["record"]["checkpoint_timings"]
        legs["c_640x1024x10000"] = {
            "bitwise": True,
            "elapsed_s": c["whole"]["record"]["elapsed_s"],
            "segmented_elapsed_s": c["segmented"]["record"]["elapsed_s"],
            "snapshot_d2h_ms": [1e3 * x["snapshot_s"] for x in ct],
            "write_sha256_commit_ms": [1e3 * x["write_s"] for x in ct],
            "launches": c["whole"]["launches"],
            "segmented_launches": c["segmented"]["launches"]}
        for leg in c.values():
            add_counts(launches, leg["launches"])

        # (d) convergence at 2048^2 through H2 + H3
        conv = HeatConfig(nxprob=2048, nyprob=2048, steps=400,
                          mode="pallas", convergence=True, interval=20)
        trace = residual_trace(torch, conv, None, None)
        sens = math.sqrt(trace[6] * trace[7])      # stops at step 160
        dres = _resil_pair(tmp, "d_conv_2048", [
            "--mode", "pallas", "--nxprob", "2048", "--nyprob", "2048",
            "--steps", "400", "--convergence", "--interval", "20",
            "--sensitivity", repr(sens)], 100)
        dw = dres["whole"]["record"]
        fail_unless(dw["steps_done"] == 160 and
                    dw["route"] == "streamed-fused",
                    f"resil d: steps_done {dw['steps_done']}, route "
                    f"{dw['route']}")
        fail_unless(dres["segmented"]["launches"].get("tile_multi_resid",
                                                      0) > 0,
                    f"resil d: no H3 launch {dres['segmented']['launches']}")
        legs["d_convergence_2048"] = {
            "steps_done": dw["steps_done"], "sensitivity": sens,
            "bitwise": True, "elapsed_s": dw["elapsed_s"],
            "segmented_elapsed_s": dres["segmented"]["record"]["elapsed_s"],
            "launches": dres["whole"]["launches"],
            "segmented_launches": dres["segmented"]["launches"]}
        for leg in dres.values():
            add_counts(launches, leg["launches"])

        # (e) the build sentinel over the serve occupancy sweep (H5)
        before = launch_counts()
        rep = serve_compile_report(nx=256, ny=256, steps=100,
                                   method="pallas", max_batch=8,
                                   device="cuda")
        got = {k: v - before.get(k, 0) for k, v in launch_counts().items()
               if v - before.get(k, 0)}
        fail_unless(rep["ok"] and got.get("ens_resident", 0) > 0,
                    f"resil e: sentinel {rep}, launches {got}")
        add_counts(launches, got)
        legs["e_build_sentinel"] = {**rep, "launch_counts": got}

        # (f) the implicit gate on the card
        before = launch_counts()
        import contextlib
        import io
        buf = io.StringIO()
        tg = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = implicit_gate.run_gate("cuda", out=sys.stdout)
        got = {k: v - before.get(k, 0) for k, v in launch_counts().items()
               if v - before.get(k, 0)}
        fail_unless(rc == 0, f"resil f: implicit gate rc {rc}: "
                    f"{buf.getvalue()[-1500:]}")
        fail_unless(got.get("td_rows", 0) > 0 and got.get("td_lanes", 0) > 0,
                    f"resil f: the gate did not launch H10/H11: {got}")
        add_counts(launches, got)
        legs["f_implicit_gate"] = {"rc": rc, "seconds":
                                   time.perf_counter() - tg,
                                   "lines": buf.getvalue().splitlines(),
                                   "launch_counts": got}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key, leg in legs.items():
        emit({"phase": f"resil_{key}", "card": name, "power_limit": power,
              **{k: v for k, v in leg.items() if k != "lines"}})
    info = {"phase": "resil", "card": name, "power_limit": power,
            "seconds": time.perf_counter() - t0, "launches": launches}
    emit(info)
    return {**info, "legs": legs}


# ------------------------------------------------------------------ #
# fleet: supervised worker processes sharing the card
# ------------------------------------------------------------------ #

#: the pickup at which worker 0's chaos env kills it (its first generation)
FLEET_KILL_AFTER = 4


def _fleet_steps(route_signature, SolveRequest, nx, ny, base, slot,
                 alive) -> int:
    """The first step count from ``base`` whose signature rendezvous
    routes onto ``slot`` of ``alive`` (so that each worker's part of the
    load is known in advance)."""
    for steps in range(base, base + 256):
        sig = str(SolveRequest(nx=nx, ny=ny, steps=steps).signature())
        if route_signature(sig, alive) == slot:
            return steps
    raise SmokeFailure(f"no step count near {base} routes to slot {slot}")


def _wire_ms(wire, res, reps: int = 3) -> dict:
    """Host ms to put one answer on the wire as a worker does
    (``wire.result_line``) and to take it off as the supervisor does
    (JSON + decode), the least of ``reps``; the decoded grid must be
    bitwise the answer."""
    enc, dec = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        line = wire.result_line(1, res)
        t1 = time.perf_counter()
        back = wire.decode_result(json.loads(line))
        t2 = time.perf_counter()
        enc.append((t1 - t0) * 1e3)
        dec.append((t2 - t1) * 1e3)
    fail_unless(back.u.tobytes() == res.u.tobytes(),
                "fleet: the wire did not carry a grid bit for bit")
    return {"shape": list(res.u.shape), "line_bytes": len(line),
            "encode_ms": min(enc), "decode_ms": min(dec)}


def _compute_apps():
    """Contexts on the card as ``nvidia-smi --query-compute-apps`` lists
    them (None when it cannot say)."""
    import shutil
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.splitlines() if line.strip()]


def _quantiles(vals) -> dict:
    v = sorted(vals)
    if not v:
        return {"n": 0}
    pick = lambda q: v[min(len(v) - 1, int(math.ceil(q * len(v))) - 1)]
    return {"n": len(v), "p50_s": pick(0.50), "p99_s": pick(0.99),
            "max_s": v[-1]}


def phase_fleet(torch, name: str, power: str, trace_dir: str) -> dict:
    """The fleet (``heat2d_tpu_torch.fleet``) on the card: a
    ``FleetServer(device="cuda")`` of 3 worker processes, each a CUDA
    context on the one card, answers 24 requests of 640x1024 x ~2000
    steps (two signatures, H5) and 6 of 4096^2 x ~240 (H6), with 2
    duplicates in the burst (coalesced) and 3 repeats after it (cache
    hits). Worker 0 is armed with ``HEAT2D_CHAOS_WORKER_KILL_AFTER`` and
    dies at its 4th pickup; worker 1 is hard-killed (``kill_worker``)
    with its 4096^2 requests in flight. Must hold: completed ==
    submitted, every distinct answer bitwise the one-process
    ``SolveServer(device="cuda")``'s, >= 2 deaths and restarts and no
    death on heartbeat age, no resident give-up, no kernel build in a
    worker and ``build/kernels/`` unchanged, H5 and H6 launched in the
    workers (their heartbeats' counts, from 0 at each worker's start),
    a clean stop. Reports the workers' start and recovery seconds by
    part, wire encode/decode ms per answer at both widths, the wire's
    share of the traced requests, latency p50/p99 per width and the
    compute apps ``nvidia-smi`` lists during the leg. The spans land in
    ``trace_dir`` (an empty directory the caller owns: the load phase
    replays them)."""
    import numpy as np

    from heat2d_tpu_torch.fleet import FleetServer, route_signature, wire
    from heat2d_tpu_torch.obs import trace_cli, tracing
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.ops import _build
    from heat2d_tpu_torch.serve.schema import SolveRequest
    from heat2d_tpu_torch.serve.server import SolveServer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kdir = _build.BUILD_DIR

    def listing():
        return sorted((p.name, p.stat().st_size) for p in kdir.iterdir())

    kernels_before = listing()
    alive = [0, 1, 2]
    sa = _fleet_steps(route_signature, SolveRequest, 640, 1024, 2000, 0,
                      alive)
    sb = _fleet_steps(route_signature, SolveRequest, 640, 1024, 2000, 2,
                      alive)
    sc = _fleet_steps(route_signature, SolveRequest, 4096, 4096, 240, 1,
                      alive)
    small = [SolveRequest(nx=640, ny=1024, steps=(sa, sb)[i % 2],
                          cx=0.02 + 0.005 * i, cy=0.2 - 0.005 * i)
             for i in range(24)]
    big = [SolveRequest(nx=4096, ny=4096, steps=sc, cx=0.02 * (i + 1),
                        cy=0.12 - 0.01 * i) for i in range(6)]
    burst = small + big + [small[2], small[3]]
    repeats = [small[0], small[1], big[0]]
    reg = MetricsRegistry()
    fs = FleetServer(
        workers=3, registry=reg, max_batch=8, max_delay=0.05,
        default_timeout=300.0, worker_timeout=300.0, max_replays=4,
        env={"HEAT2D_TRACE_DIR": trace_dir, "HEAT2D_FLIGHT_DIR": trace_dir},
        per_worker_env={0: {"HEAT2D_CHAOS_WORKER_KILL_AFTER":
                            str(FLEET_KILL_AFTER)}}, device="cuda")
    tracing.install(tracing.Tracer(trace_dir, service="router"))
    lat: dict = {}
    answers: list = []
    apps = {}
    try:
        t0 = time.monotonic()
        fs.start()
        t_started = time.monotonic()
        # only the first generation of slot 0 is armed: a restart of the
        # slot rebuilds from this durable env
        fs.sup.update_slot_env(0, {"HEAT2D_CHAOS_WORKER_KILL_AFTER": "0"})
        apps["started"] = _compute_apps()

        def timed(r):
            ts = time.monotonic()
            fut = fs.submit(r)
            fut.add_done_callback(lambda f, r=r, ts=ts: lat.setdefault(
                (r.nx, r.content_hash()), []).append(time.monotonic() - ts))
            return fut

        futs = [timed(r) for r in burst]
        deadline = time.monotonic() + 30
        while not any(rec.slot == 1 and rec.sig == str(big[0].signature())
                      for rec in list(fs._records.values())):
            fail_unless(time.monotonic() < deadline,
                        "fleet: no 4096^2 request in flight on worker 1")
            time.sleep(0.005)
        in_flight_1 = sum(1 for rec in list(fs._records.values())
                          if rec.slot == 1)
        t_kill = time.monotonic()
        fs.sup.kill_worker(1)
        outcomes = []
        for r, f in zip(burst, futs):
            try:
                answers.append((r, f.result(timeout=600)))
                outcomes.append("completed")
            except Exception as e:  # noqa: BLE001 (every failure counts)
                outcomes.append(repr(e))
        t_answered = time.monotonic()
        deadline = time.monotonic() + 120
        while not (len(fs.sup.alive_slots()) == 3 and not fs._cold
                   and fs.sup.restarts >= 2):
            fail_unless(time.monotonic() < deadline,
                        f"fleet: not whole again (alive "
                        f"{fs.sup.alive_slots()}, cold {fs._cold}, "
                        f"restarts {fs.sup.restarts})")
            time.sleep(0.05)
        t_whole = time.monotonic()
        apps["recovered"] = _compute_apps()
        hits = [fs.solve(r, timeout=600) for r in repeats]
        gens = fs.sup.generations_snapshot()
        warmed = list(fs.warmed)
        deaths, restarts, replays = (fs.sup.deaths, fs.sup.restarts,
                                     fs.replays)
        clean = fs.stop()
        launches = fs.sup.kernel_launches()
    finally:
        fs.stop()
        tracing.uninstall()
    kernels_after = listing()

    # -- what must hold ------------------------------------------------- #
    gave_up = sum(1 for o in outcomes if "gave up" in o)
    failed = [o for o in outcomes if o != "completed"]
    fail_unless(not failed, f"fleet: {len(failed)} of {len(burst)} "
                f"requests failed ({gave_up} resident give-ups): "
                f"{failed[:3]}")
    counters = reg.snapshot()["counters"]
    false_deaths = counters.get("fleet_worker_deaths_total{cause=heartbeat}",
                                0)
    fail_unless(false_deaths == 0,
                f"fleet: {false_deaths} death(s) declared on heartbeat age")
    fail_unless(deaths >= 2 and restarts >= 2,
                f"fleet: deaths {deaths}, restarts {restarts}")
    fail_unless(in_flight_1 > 0, "fleet: the kill found nothing in flight")
    fail_unless(clean, "fleet: the pool did not stop cleanly")
    fail_unless(kernels_after == kernels_before,
                f"fleet: build/kernels/ changed: {kernels_before} -> "
                f"{kernels_after}")
    builds = [g["startup"].get("builds") for g in gens]
    fail_unless(all(b == 0 for b in builds),
                f"fleet: a worker ran nvcc ({builds})")
    fail_unless(launches.get("ens_resident", 0) > 0
                and launches.get("ens_tile_multi", 0) > 0,
                f"fleet: the workers did not launch H5 and H6: {launches}")
    fail_unless(counters.get("fleet_coalesced_total", 0) >= 2,
                f"fleet: duplicates not coalesced ({counters})")
    for r, h in zip(repeats, hits):
        first = next(a for q, a in answers if q is r)
        fail_unless(h.cache_hit and h.u.tobytes() == first.u.tobytes(),
                    "fleet: a repeat was not a bitwise cache hit")

    # -- the oracle: one process on the card, every distinct hash ------- #
    distinct = {}
    for r, a in answers:
        distinct.setdefault(r.content_hash(), (r, a))
    t_or = time.perf_counter()
    with SolveServer(max_batch=8, max_delay=0.05, registry=MetricsRegistry(),
                     default_timeout=600.0) as one:
        ofuts = [(r, a, one.submit(r)) for r, a in distinct.values()]
        mismatched = [r.content_hash()[:12] for r, a, f in ofuts
                      if f.result(timeout=600).u.tobytes() != a.u.tobytes()]
    oracle_s = time.perf_counter() - t_or
    for _r, a in distinct.values():
        fail_unless(bool(np.isfinite(a.u).all()),
                    "fleet: non-finite answer")
    fail_unless(not mismatched, f"fleet: {len(mismatched)} answers differ "
                f"bitwise from the one-process server: {mismatched}")

    # -- what it reports ------------------------------------------------ #
    def parts(g):
        st = g["startup"]
        out = {"slot": g["slot"], "via": g["via"],
               "spawn_to_main_s": st["main"] - g["spawned_at"],
               "context_s": st["context"] - st["main"],
               "libraries_s": st["libraries"] - st["context"],
               "server_s": st["ready"] - st["libraries"],
               "ready_seen_s": g["ready_at"] - st["ready"],
               "spawn_to_ready_s": g["ready_at"] - g["spawned_at"]}
        warm = [t for s, t in warmed if s == g["slot"]
                and t >= g["ready_at"]]
        if g["via"] == "restart":
            out["warmup_s"] = (min(warm) - g["ready_at"]) if warm else None
            if g["slot"] == 1:
                out["kill_to_spawn_s"] = g["spawned_at"] - t_kill
                if warm:
                    out["kill_to_warm_s"] = min(warm) - t_kill
        return out

    report = trace_cli.merge_report(trace_dir)
    rows = [r for r in report["traces"] if r["root"] == "fleet.request"]
    wire_share = {}
    widths = (("640x1024", 640), ("4096x4096", 4096))
    for label, nx in widths:
        sel = [r for r in rows
               if (r["signature"] or "").startswith(f"({nx}, ")]
        total = sum(r["breakdown"]["total"] for r in sel)
        wire_share[label] = {
            "traces": len(sel),
            "wire_s": sum(r["breakdown"]["wire"] for r in sel),
            "total_s": total,
            "share": (sum(r["breakdown"]["wire"] for r in sel) / total
                      if total else None)}
    connected = sum(1 for r in rows if r.get("connected"))
    latency = {label: _quantiles([t for (nx, _h), ts in lat.items()
                                  if nx == w for t in ts])
               for label, w in widths}
    info = {
        "phase": "fleet", "card": name, "power_limit": power,
        "workers": 3, "requests": len(burst) + len(repeats),
        "submitted": len(burst), "completed": len(answers),
        "distinct": len(distinct),
        "steps": {widths[0][0]: [sa, sb], widths[1][0]: sc},
        "deaths": deaths, "restarts": restarts, "replays": replays,
        "false_deaths": false_deaths, "give_ups": gave_up,
        "killed_in_flight": in_flight_1, "clean_exit": clean,
        "launches": launches,
        "coalesced": counters.get("fleet_coalesced_total", 0),
        "start_s": t_started - t0,
        "starts": [parts(g) for g in gens if g["via"] == "start"],
        "recoveries": [parts(g) for g in gens if g["via"] == "restart"],
        "answered_s": t_answered - t_started,
        "whole_again_s": t_whole - t_kill,
        "wire": {label: _wire_ms(wire, next(a for r, a in answers
                                            if r.nx == nx))
                 for label, nx in widths},
        "wire_share": wire_share, "traces": len(rows),
        "traces_connected": connected, "latency": latency,
        "compute_apps": {k: (None if v is None else len(v))
                         for k, v in apps.items()},
        "compute_apps_rows": apps, "oracle_s": oracle_s,
        "kernels_dir_unchanged": kernels_after == kernels_before,
        "seconds": time.perf_counter() - t_phase}
    emit({k: v for k, v in info.items() if k != "compute_apps_rows"})
    return info


# ------------------------------------------------------------------ #
# load: the open-loop runner on the card
# ------------------------------------------------------------------ #

#: The committed card baseline that leg 2's surface is gated against.
LOAD_BASELINE = os.path.join(HERE, "heat2d_tpu_torch", "load",
                             "baseline_h100.json")
#: where the phase serves (the card; a rehearsal on the CPU sets "cpu")
LOAD_DEVICE = "cuda"
LOAD_SEED = 17
#: seconds of schedule per sweep point (the 4096^2 pool points take more:
#: one answer a half second on the router's decode)
LOAD_POINT_S = 2.0
LOAD_POOL_H6_S = (4.0, 3.0)
#: leg 1's bound on the replay's p99 submit skew (``--max-skew``): 14x
#: the 3.6 ms the pacing thread showed on an H100 host, well below the
#: recorded gaps' scale (the burst's admissions sit ms apart, the
#: repeats seconds later), so a replay that keeps it kept the gaps
LOAD_REPLAY_MAX_SKEW_S = 0.05
#: leg 2's probe: base rates doubling from this one, 1 s a point
LOAD_PROBE_START_RPS = 50.0
LOAD_PROBE_POINTS = 6
#: leg 2's gated surface: base rates at these fractions of the probe's
#: knee (the committed baseline's, once there is one). The gate's margins
#: judge a point below the knee, where the shed rate is 0 on any host; past
#: it, the shed rate is 1 - capacity / offered, and the in-process server's
#: capacity is host-bound: 355-479 req/s at the sweep's top point over the
#: H100 hosts measured, so its shed rate spans 0.41-0.54 there, more than
#: the 0.05 shed slack. The sweep's overloaded points are measured and
#: checked, not gated.
LOAD_GATE_FRACTIONS = (0.25, 0.5)
#: the chaos campaign of the gate's seeded regression: a sleep inside
#: every launch, and the per-request deadline that bounds its drain
LOAD_CHAOS_LATENCY_S = 0.25
LOAD_CHAOS_TIMEOUT_S = 2.0
#: the pool's base rates: the 640x1024 mix about its knee (probes
#: doubling from 10 req/s, 2 s a point, on an H100 host: the pool kept
#: up at 10 in three runs of three, at 20 in two, at 40 in none), the
#: 4096^2 mix at about 1 and 4 req/s; the in-process 4096^2 point's base
#: rate (past its knee: its achieved rate is the capacity)
LOAD_POOL_H5_RPS = (10.0, 40.0)
LOAD_POOL_H6_RPS = (1.0, 4.0)
LOAD_SERVE_H6_RPS = 60.0


def load_mixes():
    """The load phase's full-width mixes: ``smoke``'s shape at the
    serving legs' width on H5, and one 4096^2 signature on H6 (the named
    profiles are 16x16 on method "jnp": the plain loop, no hand
    kernel)."""
    from heat2d_tpu_torch.load import synth
    h5 = synth.MixProfile(
        name="card_h5", signatures=2, zipf_s=1.0, nx=640, ny=1024,
        steps=2000, method="auto", burst_factor=2.0, burst_on_s=1.0,
        burst_off_s=2.0,
        tenants=(("interactive", 0.8, 0), ("batch", 0.2, 1)))
    h6 = synth.MixProfile(name="card_h6", signatures=1, nx=4096, ny=4096,
                          steps=240, method="auto")
    return h5, h6


def _load_point(target, profile, rate, duration, launch_log=None,
                timeout=30.0) -> dict:
    """One open-loop point of ``profile`` at base ``rate`` (no warmup:
    the caller warmed the target), with its schedule's fingerprint and,
    for an in-process target, the launch rows it added: count, mean
    occupancy, median run and readback seconds."""
    from heat2d_tpu_torch.load import synth
    from heat2d_tpu_torch.load.runner import measure_point
    sched = synth.synthesize(profile, rate, duration, seed=LOAD_SEED)
    n0 = len(launch_log) if launch_log is not None else 0
    t_wall = time.time()
    row = measure_point(sched, target, warmup=False, timeout=timeout)
    reg = row.pop("_registry")
    row["window"] = (t_wall, time.time())
    row["rate"] = rate
    row["fingerprint"] = sched.fingerprint()[:16]
    row["submit_skew"] = reg.snapshot()["histograms"].get(
        "load_submit_skew_s")
    if launch_log is not None:
        rows = launch_log[n0:]
        med = lambda k: sorted(r[k] for r in rows)[len(rows) // 2]
        row["launch_rows"] = {
            "n": len(rows),
            "occupancy_mean": (sum(r["occupancy"] for r in rows)
                               / len(rows)) if rows else None,
            "run_s_p50": med("run_s") if rows else None,
            "readback_s_p50": med("readback_s") if rows else None,
            "methods": sorted({r["method"] for r in rows})}
    return row


def _load_surface(rows) -> list:
    """The lines a surface prints: offered and achieved req/s, p50 and
    p99, shed rate, submit-skew p99."""
    return [{"rate": r["rate"], "offered_rps": r["offered_rps"],
             "achieved_rps": r["achieved_rps"],
             "p50_s": (r.get("latency") or {}).get("p50"),
             "p99_s": (r.get("latency") or {}).get("p99"),
             "shed_rate": r["shed_rate"],
             "skew_p99_s": r["fidelity"]["p99_skew_s"],
             "arrivals": r["arrivals"], "outcomes": r["outcomes"],
             **({"launch_rows": r["launch_rows"]} if "launch_rows" in r
                else {})} for r in rows]


def _load_checks(label: str, rows, fit) -> None:
    """Every arrival answered, no error outcome, no shedding at or below
    the knee (the best qualifying point)."""
    for r in rows:
        fail_unless(r["unanswered"] == 0,
                    f"load {label}: {r['unanswered']} of {r['arrivals']} "
                    f"unanswered at {r['rate']:g} rps")
        fail_unless("error" not in r["outcomes"],
                    f"load {label}: error outcomes at {r['rate']:g} rps: "
                    f"{r['outcomes']}")
    from heat2d_tpu_torch.load.capacity import _qualifies
    crit = fit["criteria"]
    knee = max((r["offered_rps"] for r in rows
                if _qualifies(r, crit["keepup_margin"],
                              crit["max_shed_rate"])), default=0.0)
    for r in rows:
        if r["offered_rps"] <= knee:
            fail_unless(r["shed"] == 0,
                        f"load {label}: {r['shed']} shed at "
                        f"{r['offered_rps']:g} rps, at or below the knee")


def _load_replay_leg(torch, trace_dir, tmp) -> dict:
    """Leg 1: the fleet phase's recorded admissions replayed through
    ``heat2d-tpu-torch-load --replay`` against an in-process server on
    the card, with the recorded gaps and ``--max-skew``."""
    from heat2d_tpu_torch.load import cli, replay
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    sched = replay.schedule_from_trace_dir(trace_dir)
    widths = {}
    for a in sched:
        key = f"{a.spec['nx']}x{a.spec['ny']}"
        widths[key] = widths.get(key, 0) + 1
    out = os.path.join(tmp, "replay.jsonl")
    ce.reset_launch_counts()
    t0 = time.perf_counter()
    rc = _quiet(cli.main, ["--replay", trace_dir, "--target", "serve",
                           "--device", LOAD_DEVICE, "--max-skew",
                           str(LOAD_REPLAY_MAX_SKEW_S), "--metrics-out",
                           out])
    seconds = time.perf_counter() - t0
    launches = ce.launch_counts()
    with open(out) as f:
        rec = [json.loads(line) for line in f
               if '"run_record"' in line][0]
    row = rec["surface"][0]
    fail_unless(rc == 0, f"load replay: rc {rc}, failures "
                f"{rec['failures']}")
    fail_unless(row["arrivals"] == len(sched) == row["completed"]
                and row["unanswered"] == 0,
                f"load replay: {row['completed']} of {row['arrivals']} "
                f"completed ({row['outcomes']})")
    fail_unless(launches["ens_resident"] > 0
                and launches["ens_tile_multi"] > 0,
                f"load replay: H5/H6 not launched: {launches}")
    return {"arrivals": len(sched), "widths": widths,
            "span_s": sched.duration(), "offered_rps": row["offered_rps"],
            "achieved_rps": row["achieved_rps"],
            "completed": row["completed"], "outcomes": row["outcomes"],
            "latency": row.get("latency"), "fidelity": row["fidelity"],
            "max_skew_s": LOAD_REPLAY_MAX_SKEW_S,
            "fingerprint": sched.fingerprint()[:16],
            "launches": launches, "seconds": seconds}


def _load_probe(target, profile, launch_log) -> dict:
    """Base rates doubling from ``LOAD_PROBE_START_RPS``, 1 s a point,
    until the server no longer keeps up: the knee is the last base rate
    whose achieved rate came within the fit's keep-up margin of the
    offered one with nothing shed."""
    from heat2d_tpu_torch.load.capacity import _qualifies
    points, knee = [], None
    rate = LOAD_PROBE_START_RPS
    for _ in range(LOAD_PROBE_POINTS):
        r = _load_point(target, profile, rate, 1.0, launch_log)
        points.append(_load_surface([r])[0])
        if not _qualifies(r, 0.2, 0.0):
            break
        knee = rate
        rate *= 2
    return {"points": points, "knee_rate": knee}


def _h5_warm_schedule(h5):
    """Every signature of the 640x1024 mix, for ``warm_target``."""
    from heat2d_tpu_torch.load import synth
    from heat2d_tpu_torch.load.schedule import Schedule
    warm = Schedule([a for r in (25.0, 400.0)
                     for a in synth.synthesize(h5, r, 1.0, seed=LOAD_SEED)])
    fail_unless(len(warm.signatures()) == h5.signatures,
                f"load: the warm schedule misses a signature: "
                f"{warm.signatures()}")
    return warm


def _load_sweep(target, profile, rates, units, launch_log=None,
                timeout=30.0, chips_per_unit=1):
    from heat2d_tpu_torch.load.capacity import fit_capacity
    rows = [_load_point(target, profile, r, LOAD_POINT_S, launch_log,
                        timeout) for r in rates]
    return rows, fit_capacity(rows, units, chips_per_unit=chips_per_unit)


def _load_serve_leg(torch, name, power, measure: bool) -> dict:
    """Leg 2: the in-process server's surface at 640x1024 (H5) and its
    fit; the gate's round trip and the committed baseline on the gated
    surface below the knee (``LOAD_GATE_FRACTIONS``); a one-point probe
    at 4096^2 (H6)."""
    from heat2d_tpu_torch.load import gate, synth
    from heat2d_tpu_torch.load.runner import ServeTarget, warm_target
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.resil import chaos

    h5, h6 = load_mixes()
    committed = None
    if os.path.exists(LOAD_BASELINE):
        with open(LOAD_BASELINE) as f:
            committed = json.load(f)
    fail_unless(measure or committed is not None,
                f"load: no committed baseline at {LOAD_BASELINE}")
    reg = MetricsRegistry()
    ce.reset_launch_counts()
    t0 = time.perf_counter()
    target = ServeTarget(registry=reg, device=LOAD_DEVICE)
    log = target.server.engine.launch_log
    out = {"target": "serve", "device": LOAD_DEVICE}
    try:
        t_warm = time.perf_counter()
        warm = _h5_warm_schedule(h5)
        out["warm_requests"] = warm_target(target, warm)
        out["warm_s"] = time.perf_counter() - t_warm
        out["probe"] = _load_probe(target, h5, log)
        knee = out["probe"]["knee_rate"]
        fail_unless(knee is not None, f"load: the probe found no rate the "
                    f"server keeps up with: {out['probe']['points']}")
        rates = [knee / 2, knee, knee * 2]
        out["rates"] = rates
        rows, fit = _load_sweep(target, h5, rates, 1, log)
        out["surface"], out["fit"] = _load_surface(rows), fit
        _load_checks("serve 640x1024", rows, fit)
        fail_unless(fit["saturated"], f"load: the in-process fit never "
                    f"found the knee (a lower bound): {out['surface']}")
        # the gated surface, and the gate's round trip against it
        gate_rates = (committed["meta"]["rates"] if not measure
                      else [knee * f for f in LOAD_GATE_FRACTIONS])
        out["gate_rates"] = gate_rates
        grows, gfit = _load_sweep(target, h5, gate_rates, 1, log)
        _load_checks("serve gate 640x1024", grows, gfit)
        out["gate_surface"] = _load_surface(grows)
        out["gate_fit"] = gfit
        own = gate.build_baseline(grows, gfit)
        rows2, fit2 = _load_sweep(target, h5, gate_rates, 1, log)
        out["healthy"] = {"surface": _load_surface(rows2), "fit": fit2,
                          "failures": gate.compare(rows2, fit2, own)}
        fail_unless(not out["healthy"]["failures"],
                    f"load: a healthy re-run failed the gate: "
                    f"{out['healthy']['failures']}")
        chaos.install(chaos.ChaosConfig(
            launch_latency_s=LOAD_CHAOS_LATENCY_S))
        try:
            rows3, fit3 = _load_sweep(target, h5, gate_rates, 1, log,
                                      timeout=LOAD_CHAOS_TIMEOUT_S)
        finally:
            chaos.uninstall()
        out["chaos"] = {"launch_latency_s": LOAD_CHAOS_LATENCY_S,
                        "timeout_s": LOAD_CHAOS_TIMEOUT_S,
                        "surface": _load_surface(rows3), "fit": fit3,
                        "failures": gate.compare(rows3, fit3, own)}
        fail_unless(out["chaos"]["failures"],
                    "load: the chaos-slowed run passed the gate")
        meta = {"profile": _profile_dict(h5), "seed": LOAD_SEED,
                "rates": gate_rates, "knee_rate": knee,
                "duration_s": LOAD_POINT_S,
                "target": "serve", "device": LOAD_DEVICE, "card": name,
                "power_limit": power,
                "measured_by": "chip_smoke.py, phase load, leg 2",
                "commit": "the commit that added this file"}
        if measure:
            from heat2d_tpu_torch.io.binary import write_json_atomic
            write_json_atomic(gate.build_baseline(grows, gfit, meta=meta),
                              _out_path("load_baseline_h100.json"))
        if committed is not None:
            out["committed_gate"] = gate.compare(grows, gfit, committed)
            out["committed_meta"] = committed.get("meta")
            fail_unless(measure or not out["committed_gate"],
                        f"load: the surface failed the committed card "
                        f"baseline: {out['committed_gate']}")
        # the in-process server at 4096^2: one point past its knee
        t_warm = time.perf_counter()
        warm6 = synth.synthesize(h6, LOAD_SERVE_H6_RPS, LOAD_POINT_S,
                                 seed=LOAD_SEED)
        out["h6_warm_requests"] = warm_target(target, warm6)
        out["h6_warm_s"] = time.perf_counter() - t_warm
        r6 = _load_point(target, h6, LOAD_SERVE_H6_RPS, LOAD_POINT_S, log)
        out["h6_point"] = _load_surface([r6])[0]
        _load_checks("serve 4096^2", [r6], {"criteria": fit["criteria"]})
        # past its knee the achieved rate is the capacity; a point that
        # kept up gives a lower bound only
        out["h6_point"]["past_knee"] = (r6["achieved_rps"]
                                        < 0.8 * r6["offered_rps"])
        failures = reg.snapshot()["counters"].get(
            "serve_launch_failures_total", 0)
        fail_unless(failures == 0, f"load: {failures} launch failures")
    finally:
        target.close()
    out["launches"] = ce.launch_counts()
    fail_unless(out["launches"]["ens_resident"] > 0
                and out["launches"]["ens_tile_multi"] > 0,
                f"load serve: H5/H6 not launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    return out


def _profile_dict(profile) -> dict:
    import dataclasses
    return {k: (list(map(list, v)) if k == "tenants" else v)
            for k, v in dataclasses.asdict(profile).items()}


def _pool_segments(report, row) -> dict:
    """Where the pool's requests of one point spent their time: the
    per-segment statistics (``trace_cli.segment_stats``: worker queue,
    launch, wire = dispatch to answer less the worker's request span,
    other = the router's wait before dispatch) over the fleet roots
    admitted in the point's window."""
    from heat2d_tpu_torch.obs import trace_cli
    t0, t1 = row["window"]
    sel = [r for r in report["traces"] if r["root"] == "fleet.request"
           and t0 <= r["t0"] <= t1]
    stats = trace_cli.segment_stats({"traces": sel})
    return {"traces": len(sel),
            **{seg: {k: stats[seg][k] for k in ("mean", "p50", "p99")}
               for seg in ("queue", "launch", "wire", "other", "total")}}


def _load_pool_leg(torch, tmp) -> dict:
    """Leg 3: one pool of 2 workers on the card (``FleetTarget``), traced
    (router and workers): two rates of the 640x1024 mix, two of the
    4096^2 mix, each width's fit over 2 units and the segments of
    each width's top point; the router's decode ms of a 4096^2 answer in
    the same run; the compute apps during the leg; a clean stop."""
    from heat2d_tpu_torch.fleet import route_signature, wire
    from heat2d_tpu_torch.load import synth
    from heat2d_tpu_torch.load.capacity import fit_capacity
    from heat2d_tpu_torch.load.runner import FleetTarget, warm_target
    from heat2d_tpu_torch.obs import trace_cli, tracing
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry

    h5, h6 = load_mixes()
    reg = MetricsRegistry()
    tdir = os.path.join(tmp, "pool_trace")
    os.makedirs(tdir)
    t0 = time.perf_counter()
    tracing.install(tracing.Tracer(tdir, service="router"))
    try:
        target = FleetTarget(workers=2, registry=reg,
                             quotas=h5.quotas(256), device=LOAD_DEVICE,
                             default_timeout=120.0,
                             env={"HEAT2D_TRACE_DIR": tdir,
                                  "HEAT2D_FLIGHT_DIR": tdir})
    except BaseException:
        tracing.uninstall()
        raise
    out = {"target": "fleet", "workers": 2, "device": LOAD_DEVICE,
           "traced": True, "start_s": time.perf_counter() - t0}
    fs = target.fleet
    try:
        out["compute_apps"] = _compute_apps()
        t_warm = time.perf_counter()
        warm = _h5_warm_schedule(h5)
        out["h5_warm_requests"] = warm_target(target, warm)
        out["h5_warm_s"] = time.perf_counter() - t_warm
        out["h5_routes"] = {str(s): route_signature(str(s), [0, 1])
                            for s in warm.signatures()}
        rates5 = list(LOAD_POOL_H5_RPS)
        rows5, fit5 = _load_sweep(target, h5, rates5, 2)
        _load_checks("pool 640x1024", rows5, fit5)
        out["h5"] = {"rates": rates5, "surface": _load_surface(rows5),
                     "fit": fit5}
        t_warm = time.perf_counter()
        warm6 = synth.synthesize(h6, 4.0, 2.0, seed=LOAD_SEED)
        out["h6_warm_requests"] = warm_target(target, warm6)
        out["h6_warm_s"] = time.perf_counter() - t_warm
        # one answer kept, to time the router's decode of its line
        res = target.submit(warm6.arrivals[0].build_request(), "default",
                            120.0).result(timeout=300)
        out["h6_wire"] = _wire_ms(wire, res, reps=2)
        del res
        rows6 = [_load_point(target, h6, r, d, timeout=120.0)
                 for r, d in zip(LOAD_POOL_H6_RPS, LOAD_POOL_H6_S)]
        fit6 = fit_capacity(rows6, 2)
        _load_checks("pool 4096^2", rows6, fit6)
        out["h6"] = {"rates": list(LOAD_POOL_H6_RPS),
                     "durations_s": list(LOAD_POOL_H6_S),
                     "surface": _load_surface(rows6), "fit": fit6}
        out["compute_apps_after"] = _compute_apps()
        deaths = fs.sup.deaths
        out["clean_stop"] = fs.stop()
        out["launches"] = fs.sup.kernel_launches()
        gens = fs.sup.generations_snapshot()
    finally:
        target.close()
        tracing.uninstall()
    fail_unless(deaths == 0, f"load pool: {deaths} worker deaths")
    fail_unless(out["clean_stop"], "load pool: the pool did not stop "
                "cleanly")
    builds = [g["startup"].get("builds") for g in gens]
    fail_unless(all(b == 0 for b in builds),
                f"load pool: a worker ran nvcc ({builds})")
    fail_unless(out["launches"].get("ens_resident", 0) > 0
                and out["launches"].get("ens_tile_multi", 0) > 0,
                f"load pool: the workers did not launch H5 and H6: "
                f"{out['launches']}")
    report = trace_cli.merge_report(tdir)
    out["segments"] = {"640x1024": _pool_segments(report, rows5[-1]),
                       "4096x4096": _pool_segments(report, rows6[-1])}
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_load(torch, name: str, power: str, trace_dir: str,
               measure: bool = False) -> dict:
    """The load runner (``heat2d_tpu_torch.load``) on the card (item 24
    of the docstring). ``measure``: the committed baseline is compared
    and reported but not required (without one, leg 2's rates come from
    its probe), and the surface is written as a baseline candidate to
    ``chiprun_out/load_baseline_h100.json``."""
    import tempfile

    from heat2d_tpu_torch.io.binary import write_json_atomic
    from heat2d_tpu_torch.ops import _build

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kdir = _build.BUILD_DIR

    def listing():
        return sorted((p.name, p.stat().st_size) for p in kdir.iterdir())

    kernels_before = listing()
    with tempfile.TemporaryDirectory(prefix="heat2d-load-") as tmp:
        replay_leg = _load_replay_leg(torch, trace_dir, tmp)
        serve_leg = _load_serve_leg(torch, name, power, measure)
        torch.cuda.empty_cache()
        pool_leg = _load_pool_leg(torch, tmp)
    torch.cuda.empty_cache()
    kernels_after = listing()
    fail_unless(kernels_after == kernels_before,
                f"load: build/kernels/ changed: {kernels_before} -> "
                f"{kernels_after}")
    launches: dict = {}
    for leg in (replay_leg, serve_leg, pool_leg):
        add_counts(launches, leg["launches"])
    fit5 = serve_leg["fit"]
    info = {"phase": "load", "card": name, "power_limit": power,
            "replay": replay_leg, "serve": serve_leg, "pool": pool_leg,
            # the fits' per-unit rates, and each target's achieved rate
            # at its top (overloaded) point of each width: what it
            # carries saturated
            "per_unit_rps": {
                "serve_640x1024": fit5["per_unit_rps"],
                "pool_640x1024": pool_leg["h5"]["fit"]["per_unit_rps"],
                "pool_4096x4096": pool_leg["h6"]["fit"]["per_unit_rps"]},
            "saturated_rps": {
                "serve_640x1024": serve_leg["surface"][-1]["achieved_rps"],
                "pool_640x1024": pool_leg["h5"]["surface"][-1][
                    "achieved_rps"],
                "serve_4096x4096": serve_leg["h6_point"]["achieved_rps"],
                "pool_4096x4096": pool_leg["h6"]["surface"][-1][
                    "achieved_rps"]},
            "launches": launches,
            "kernels_dir_unchanged": kernels_after == kernels_before,
            "seconds": time.perf_counter() - t0}
    write_json_atomic(info, _out_path("load_phase.json"))
    emit({"phase": "load", "card": name, "power_limit": power,
          "replay": {k: replay_leg[k] for k in (
              "arrivals", "widths", "span_s", "completed", "fidelity",
              "max_skew_s", "seconds")},
          "serve": {"warm_s": serve_leg["warm_s"],
                    "knee_rate": serve_leg["probe"]["knee_rate"],
                    "rates": serve_leg["rates"],
                    "surface": serve_leg["surface"],
                    "fit": serve_leg["fit"],
                    "gate_rates": serve_leg["gate_rates"],
                    "gate_surface": serve_leg["gate_surface"],
                    "healthy_failures": serve_leg["healthy"]["failures"],
                    "chaos_failures": serve_leg["chaos"]["failures"],
                    "committed_gate": serve_leg.get("committed_gate"),
                    "h6_point": serve_leg["h6_point"],
                    "seconds": serve_leg["seconds"]},
          "pool": {k: pool_leg[k] for k in (
              "start_s", "h5_warm_s", "h6_warm_s", "h5_routes", "h5", "h6",
              "h6_wire", "segments", "compute_apps", "clean_stop",
              "seconds")},
          "per_unit_rps": info["per_unit_rps"],
          "saturated_rps": info["saturated_rps"], "launches": launches,
          "seconds": info["seconds"]})
    return info


# ------------------------------------------------------------------ #
# obs: the telemetry layer on the card
# ------------------------------------------------------------------ #

def _out_path(name: str) -> str:
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    return os.path.join(out, name)


def _traced_cli(outdir, nx, ny, steps, traced: bool) -> dict:
    """The solver CLI in mode pallas on the card, with ``--profile`` and
    ``--trace-dir`` when ``traced``: its record, final_binary.dat's bytes
    and the launch counts of the run (zeroed just before)."""
    from heat2d_tpu_torch.cli import main as cli_main
    from heat2d_tpu_torch.obs import tracing
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    rec = os.path.join(outdir, "rec.json")
    argv = ["--mode", "pallas", "--nxprob", str(nx), "--nyprob", str(ny),
            "--steps", str(steps), "--dat-layout", "none",
            "--binary-dumps", "--outdir", outdir, "--run-record", rec]
    if traced:
        argv += ["--profile", os.path.join(outdir, "prof"),
                 "--trace-dir", os.path.join(outdir, "trace")]
    cs.reset_launch_counts()
    try:
        rc = _quiet(cli_main, argv)
    finally:
        os.environ.pop("HEAT2D_TRACE_DIR", None)
        tracing.set_ambient(None)
        tracing.uninstall()
    counts = cs.launch_counts()
    fail_unless(rc == 0, f"cli {nx}x{ny} traced={traced}: rc {rc}")
    with open(rec) as f, open(os.path.join(outdir, "final_binary.dat"),
                              "rb") as g:
        return {"record": json.load(f), "bytes": g.read(),
                "launches": counts}


def _digest_case(torch, tmp, name, nx, ny, steps, kernel, wrapper,
                 kernel_ms) -> dict:
    """One main-path case, untraced then traced; the digest's checks."""
    from heat2d_tpu_torch.io.binary import write_json_atomic
    from heat2d_tpu_torch.obs import trace_cli, trace_report
    plain = _traced_cli(os.path.join(tmp, name + "_plain"), nx, ny, steps,
                        False)
    d = os.path.join(tmp, name + "_traced")
    traced = _traced_cli(d, nx, ny, steps, True)
    fail_unless(traced["bytes"] == plain["bytes"],
                f"obs {name}: the traced run's grid differs from the "
                f"untraced run's")
    fail_unless(traced["launches"] == plain["launches"],
                f"obs {name}: launches traced {traced['launches']} vs "
                f"untraced {plain['launches']}")
    digest = trace_report.report(os.path.join(d, "prof"))
    write_json_atomic(digest, _out_path(f"obs_digest_{name}.json"))
    kern = {k["kernel"]: k for k in digest["kernels"]}
    n_events = kern.get(kernel, {}).get("count", 0)
    fail_unless(n_events == traced["launches"][wrapper] > 0,
                f"obs {name}: {n_events} {kernel} events in the capture, "
                f"{traced['launches'][wrapper]} {wrapper} launches")
    fail_unless(digest["top_ops"][0]["kernel"] == kernel,
                f"obs {name}: top op {digest['top_ops'][0]}")
    annotated = {a["name"] for a in digest["annotations"]}
    fail_unless("stencil_chunk" in annotated,
                f"obs {name}: no stencil_chunk annotation ({annotated})")
    report = trace_cli.merge_report(os.path.join(d, "trace"))
    fail_unless(len(report["traces"]) == 1
                and report["traces"][0]["connected"],
                f"obs {name}: the cli trace is not one connected trace")
    fail_unless(traced["record"].get("trace_id")
                == report["traces"][0]["trace_id"],
                f"obs {name}: the record's trace_id is not the trace's")
    lanes = [{k: lane[k] for k in ("lane", "total_s", "busy_s", "idle_s",
                                   "idle_pct", "gaps")}
             for lane in digest["lanes"]]
    t_plain = plain["record"]["elapsed_s"]
    t_traced = traced["record"]["elapsed_s"]
    return {"shape": [nx, ny], "steps": steps, "kernel": kernel,
            "route": traced["record"]["route"],
            "launches": traced["launches"][wrapper], "events": n_events,
            "event_mean_ms": kern[kernel]["mean_ms"],
            "kernels_line_ms": kernel_ms,
            "kernels": digest["kernels"], "window_s": digest["window_s"],
            "categories": digest["categories"], "lanes": lanes,
            "sync": digest["sync"],
            "annotations": digest["annotations"],
            "elapsed_untraced_s": t_plain, "elapsed_traced_s": t_traced,
            "traced_over_untraced": t_traced / t_plain}


def _served_with_obs(torch, tmp) -> dict:
    """A SolveServer on the card with tracing, cost cards and an SLO
    armed: an H5 bucket (4 x 640x1024 x 2000) and an H6 bucket
    (4 x 4096^2 x 240)."""
    import numpy as np

    from heat2d_tpu_torch.io.binary import write_json_atomic
    from heat2d_tpu_torch.obs import perf, slo, trace_cli, tracing
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.serve.schema import SolveRequest
    from heat2d_tpu_torch.serve.server import Client, SolveServer

    tdir = os.path.join(tmp, "serve_trace")
    registry = MetricsRegistry()
    tracing.install(tracing.Tracer(tdir, service="serve"))
    observer = perf.PerfObserver(registry=registry, dir=tdir,
                                 service="serve")
    perf.install(observer)
    buckets = [
        [SolveRequest(nx=640, ny=1024, steps=2000, cx=0.02 + 0.02 * i,
                      cy=0.2 - 0.02 * i) for i in range(4)],
        [SolveRequest(nx=4096, ny=4096, steps=240, cx=0.05 * (i + 1),
                      cy=0.2 - 0.04 * i) for i in range(4)]]
    server = SolveServer(max_batch=8, max_delay=0.5, registry=registry,
                         default_timeout=600.0)
    client = Client(server)
    ce.reset_launch_counts()
    try:
        with server:
            for reqs in buckets:
                futs = [client.submit(r) for r in reqs]
                for f in futs:
                    u = f.result(timeout=900).u
                    fail_unless(bool(np.isfinite(u).all()),
                                "obs serving: non-finite result")
        counts = ce.launch_counts()
        cards = observer.cards()
    finally:
        perf.uninstall()
        tracing.uninstall()
    rows = slo.evaluate(registry, prefix="serve",
                        default=slo.SLOPolicy(latency_p99_s=60.0))
    report = trace_cli.merge_report(tdir)
    write_json_atomic(report, _out_path("obs_serve_traces.json"))
    n_req = sum(len(b) for b in buckets)
    fail_unless(len(report["traces"]) == n_req,
                f"obs serving: {len(report['traces'])} traces for {n_req} "
                f"requests")
    spans = trace_cli.assemble(trace_cli.load_dir(tdir)["spans"])
    for r in report["traces"]:
        kinds = {s.get("kind") for s in spans[r["trace_id"]]}
        fail_unless(r["connected"] and {"request", "queue",
                                        "launch"} <= kinds,
                    f"obs serving: trace {r['trace_id']} connected="
                    f"{r['connected']}, kinds {sorted(kinds)}")
    fail_unless(counts["ens_resident"] > 0 and counts["ens_tile_multi"] > 0,
                f"obs serving: launches {counts}")
    log = server.engine.launch_log
    for row in log:
        p = row.get("perf") or {}
        fail_unless(p.get("pct_of_bound") is not None,
                    f"obs serving: launch row without a bound: {row}")
        fail_unless(p["pct_of_bound"] <= 100.0,
                    f"obs serving: {p['pct_of_bound']}% of the bound: the "
                    f"byte model undercounts ({p})")
    fail_unless(len(cards) == len(log), f"obs serving: {len(cards)} cards "
                f"for {len(log)} launch keys")
    for c in cards:
        fail_unless(bool(c.get("peak_bytes")) and bool(c.get("plan")),
                    f"obs serving: card without a peak or a plan: {c}")
    return {"requests": n_req, "launches": server.engine.launches,
            "launch_counts": counts,
            "traces": [{k: r[k] for k in ("trace_id", "spans", "connected",
                                          "breakdown")}
                       for r in report["traces"]],
            "launch_rows": [{"signature": str(row["signature"]),
                             "method": row["method"],
                             "run_s": row["run_s"], "perf": row["perf"]}
                            for row in log],
            "cards": [{k: c[k] for k in (
                "signature", "kernel", "plan", "flops", "bytes_accessed",
                "argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes", "registers", "local_bytes",
                "arithmetic_intensity")} for c in cards],
            "slo": rows}


def phase_obs(torch, name: str, power: str, rows: list) -> dict:
    """The telemetry layer on the card (item 21 of the docstring)."""
    import tempfile

    from heat2d_tpu_torch.obs import roofline
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    bound = roofline.roofline_bound(4096, 4096, steps=240, device="cuda",
                                    device_kind=kind)
    fail_unless(bound is not None,
                f"obs: no roofline bound for the card {kind!r}")
    kms = {r["name"]: r["ms"] for r in rows}
    with tempfile.TemporaryDirectory() as tmp:
        main = _digest_case(torch, tmp, "main_4096", 4096, 4096, 240, "H2",
                            "tile_multi", kms["tile_multi"])
        emit({"phase": "obs_main_4096", "card": name, "power_limit": power,
              **{k: main[k] for k in (
                  "route", "launches", "events", "event_mean_ms",
                  "kernels_line_ms", "kernels", "window_s", "categories",
                  "lanes", "sync", "traced_over_untraced")}})
        res = _digest_case(torch, tmp, "resident_640x1024", 640, 1024,
                           10000, "H4", "resident", kms["resident"])
        emit({"phase": "obs_resident_640x1024", "card": name,
              "power_limit": power,
              **{k: res[k] for k in (
                  "route", "launches", "events", "event_mean_ms",
                  "kernels_line_ms", "kernels", "categories", "sync",
                  "traced_over_untraced")}})
        served = _served_with_obs(torch, tmp)
    emit({"phase": "obs_serving", "card": name, "power_limit": power,
          **{k: served[k] for k in ("requests", "launches",
                                    "launch_counts", "launch_rows",
                                    "cards", "slo")}})
    info = {"phase": "obs", "card": name, "power_limit": power,
            "bound_4096": bound, "main": main, "resident": res,
            "serving": served, "seconds": time.perf_counter() - t0}
    emit({"phase": "obs", "seconds": info["seconds"],
          "bound_4096_mcells_per_s": bound["bound_mcells_per_s"],
          "bound_by": bound["bound_by"]})
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
        fam_kern = phase_family_kernels(torch)
        td_kern = phase_tridiag_kernels(torch)
        main_path = phase_main_path(torch)
        serve = phase_serve(torch)
        implicit = phase_implicit_path(torch)
        serve_fam = phase_serve_families(torch)
        tts = phase_time_to_solution(torch)
        shard_kern = phase_shard_kernels(torch)
        sharded_path = phase_sharded_path(torch)
        sharded_ens = phase_sharded_ensembles(torch)
        spatial_ens = phase_spatial_ensembles(torch)
        mesh_serve = phase_mesh_serving(torch)
        mesh_fault = phase_mesh_fault(torch)
        scaling = phase_strong_scaling(torch)
        multi = phase_multi_process(torch, tool["name"],
                                    tool["power_limit"])
        diff_path = phase_diff_path(torch, tool["name"],
                                    tool["power_limit"])
        resil = phase_resil(torch, tool["name"], tool["power_limit"])
        fleet_dir = tempfile.mkdtemp(prefix="heat2d-fleet-")
        try:
            fleet = phase_fleet(torch, tool["name"], tool["power_limit"],
                                fleet_dir)
            load = phase_load(torch, tool["name"], tool["power_limit"],
                              fleet_dir)
        finally:
            shutil.rmtree(fleet_dir, ignore_errors=True)
        launches = {**main_path["launches"], **serve["launch_counts"],
                    **serve_fam["launch_counts"],
                    **sharded_path["launches"]}
        launches["ens_tile_multi"] += diff_path["launches"]["ens_tile_multi"]
        for leg in (sharded_ens, mesh_serve, scaling, multi, resil, fleet,
                    load):
            add_counts(launches, leg["launches"])
        for name in ("td_coeffs", "td_rows", "td_lanes"):
            launches[name] += implicit["launches"][name]
        rows = phase_kernel_times(
            torch, launches,
            {**kern["max_abs_err"], **ens_kern["max_abs_err"],
             **fam_kern["max_abs_err"], **td_kern["max_abs_err"],
             **shard_kern["max_abs_err"]})
        head = phase_headline(torch, tool["name"], tool["power_limit"])
        tune = phase_tune(torch, tool["name"], tool["power_limit"])
        obs = phase_obs(torch, tool["name"], tool["power_limit"], rows)
        for r in rows:
            fail_unless(all(math.isfinite(r[k]) for k in
                            ("ms", "plain_ms", "bound_ms")),
                        f"non-finite time in {r}")
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    write_results({"toolchain": tool, "build": build, "kernels_check": kern,
                   "ensemble_kernels_check": ens_kern,
                   "family_kernels_check": fam_kern,
                   "tridiag_kernels_check": td_kern,
                   "main_path": main_path, "serve": serve,
                   "implicit_path": implicit, "serve_families": serve_fam,
                   "time_to_solution": tts,
                   "shard_kernels_check": shard_kern,
                   "sharded_path": sharded_path,
                   "sharded_ensembles": sharded_ens,
                   "spatial_ensembles": spatial_ens,
                   "mesh_serving": mesh_serve, "mesh_fault": mesh_fault,
                   "strong_scaling": scaling, "multi_process": multi,
                   "diff_path": diff_path, "resil": resil,
                   "fleet": fleet, "load": load,
                   "kernels": rows,
                   "headline": head, "tune": tune, "obs": obs,
                   "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    print(smi("name,power.limit"))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
