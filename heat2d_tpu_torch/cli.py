"""Command-line driver of the port: ``python -m heat2d_tpu_torch.cli``
(installed as ``heat2d-tpu-torch``).

The flags this slice implements keep the JAX CLI's names and defaults
(``heat2d_tpu/cli.py``); ``--device {cuda,cpu}`` takes the place of
``--platform``. The output matches the JAX CLI's: the startup banner,
``initial.dat``/``final.dat`` in either layout, optional binary dumps and
checkpoint, ``Exiting after N iterations`` and ``Elapsed time: %e sec``.

    python -m heat2d_tpu_torch.cli --mode pallas --nxprob 640 \\
        --nyprob 1024 --steps 10000
    python -m heat2d_tpu_torch.cli --device cpu --accum-dtype float64

``--method adi|mg`` steps with Crank-Nicolson (ADI through the H10/H11
tridiagonal kernels in mode pallas, multigrid V-cycles), ``--problem``
picks a problem family (mode serial in the solver; every family's kernel
routes on the ensemble path). ``--ensemble-cx/--ensemble-cy`` run a batch
of (cx, cy) members in one launch instead (``models/ensemble.py``),
writing ``final_m<i>.dat`` per member and, on convergence runs, the
``Members exited after ...`` line. With ``--mode dist1d|dist2d|hybrid``
the members shard over the device slots (each slot running the
single-device ensemble route on its members), and ``--mode dist2d
--gridx/--gridy`` decomposes each member over a submesh of slots;
``--numworkers`` is refused for ensembles, and ``--gridx/--gridy`` in any
other mode, as the JAX CLI refuses them.

    python -m heat2d_tpu_torch.cli --mode pallas --method adi \\
        --nxprob 4096 --nyprob 4096 --steps 20 --cx 51.2 --cy 51.2

The distributed modes take the decomposition flags (``--gridx``,
``--gridy``, ``--numworkers``, ``--halo-depth``, ``--halo``).
``--host-device-count N`` gives the mesh N slots on the chosen device
(the visible cards in turn, or the CPU), so shards can share a card, as
the JAX CLI's virtual host devices share the host:

    python -m heat2d_tpu_torch.cli --mode hybrid --gridx 2 --gridy 2 \\
        --host-device-count 4 --nxprob 4096 --nyprob 4096 --steps 240

``--device-info`` prints the device summary (name, count, power limit)
and exits without running a kernel. ``--metrics-out PATH`` writes the
JAX CLI's telemetry JSONL (the ``run_start`` event, the registry's
snapshot, the run record with ``metrics_aggregate``, and on convergence
runs the ``residual_trajectory`` the loops read, or the ensembles'
``chunk_progress``); ``--log-level`` sets the ``heat2d_tpu_torch``
loggers. ``--profile LOGDIR`` captures the run (warmup and timed run)
with ``torch.profiler`` for ``heat2d-tpu-torch-prof LOGDIR``;
``--trace-dir DIR`` arms request tracing (the ``cli.run`` root span, the
``phase.*`` spans under it, the record's ``trace_id``; merge with
``heat2d-tpu-torch-trace DIR``). ``HEAT2D_FLIGHT_DIR`` arms the crash
flight recorder. With a tuning db active
(``HEAT2D_TUNE_DB``, ``tune/``) the run record carries the configs the
planners took as ``tuned_config``.

``--coordinator/--num-processes/--process-id`` (the mpiexec launch line)
or ``--multihost`` (torchrun's environment) run N processes as one world
over ``torch.distributed`` (``parallel/multihost.py``): the mesh spans
them, each process runs its own shards (``--host-device-count`` of them,
default one), and process 0 prints, writes the ``.dat`` files and the
run record. A binary dump and a checkpoint are written by every process
into one file; with ``--dat-layout none`` nothing is gathered.

    python -m heat2d_tpu_torch.cli --device cpu --mode dist2d --gridx 2 \\
        --gridy 2 --host-device-count 2 --coordinator 127.0.0.1:29500 \\
        --num-processes 2 --process-id 0      # and --process-id 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from heat2d_tpu_torch.config import (MODES, SHARDED_MODES, ConfigError,
                                     HeatConfig)
from heat2d_tpu_torch.utils.device import DeviceUnavailableError
from heat2d_tpu_torch.utils.logs import add_log_level_flag, configure_logging
from heat2d_tpu_torch.vocab import PROBLEMS, TIME_METHODS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch",
        description="2D heat-equation solver on PyTorch and CUDA (the "
                    "port of heat2d-tpu; capabilities of patschris/Heat2D)")
    p.add_argument("--mode", default="serial", choices=list(MODES),
                   help="serial = plain PyTorch golden model; pallas = "
                        "the hand-written CUDA kernels; dist1d/dist2d = "
                        "the golden model over a mesh of row strips or "
                        "blocks; hybrid = the mesh with a hand kernel "
                        "per shard")
    p.add_argument("--method", default="explicit",
                   choices=list(TIME_METHODS),
                   help="time-stepping scheme: explicit forward Euler "
                        "(stability-limited cx+cy <= 1/2), Crank-Nicolson "
                        "ADI on batched tridiagonal solves, or multigrid-"
                        "solved CN; the implicit schemes are "
                        "unconditionally stable, so --cx/--cy become "
                        "dt-scaled diffusion numbers chosen by accuracy")
    g = p.add_argument_group("problem (reference #define names)")
    g.add_argument("--problem", default="heat5", choices=list(PROBLEMS),
                   help="spatial-operator family: heat5 is the reference "
                        "5-point stencil; the others run their own "
                        "updates with per-family stability bounds and "
                        "capability gating")
    g.add_argument("--nxprob", type=int, default=10)
    g.add_argument("--nyprob", type=int, default=10)
    g.add_argument("--steps", type=int, default=100)
    g.add_argument("--cx", type=float, default=0.1)
    g.add_argument("--cy", type=float, default=0.1)
    d = p.add_argument_group("decomposition")
    d.add_argument("--gridx", type=int, default=1)
    d.add_argument("--gridy", type=int, default=1)
    d.add_argument("--numworkers", type=int, default=None,
                   help="dist1d row-strip count (defaults to --gridx)")
    d.add_argument("--strict-baseline", action="store_true",
                   help="enforce mpi_heat2Dn.c's 3..8 worker range")
    d.add_argument("--halo-depth", type=int, default=None,
                   help="wide-halo depth T for distributed modes: one "
                        "T-deep ghost exchange per T steps (default auto; "
                        "1 = the reference's per-step exchange)")
    d.add_argument("--halo", default="collective",
                   choices=["collective", "fused"],
                   help="halo-exchange route: 'collective' = exchange, "
                        "then compute; 'fused' = the exchange inside the "
                        "shard kernel (hybrid, H14) or the inner/boundary "
                        "split (dist1d/dist2d); bitwise-identical "
                        "results, degrades to collective where not viable")
    d.add_argument("--host-device-count", type=int, default=None,
                   metavar="N",
                   help="give the mesh N device slots on --device (the "
                        "visible cards in turn, or the CPU), so that "
                        "several shards share a card; default: one slot "
                        "per visible device")
    e = p.add_argument_group(
        "ensemble (batched parameter sweep: one launch advances every "
        "(cx, cy) member; members that fit the card's L2 run the resident "
        "ensemble kernel, bigger ones the tile sweeps)")
    e.add_argument("--ensemble-cx", default=None, metavar="LIST",
                   help="comma-separated cx values; with --ensemble-cy "
                        "runs the whole batch in one launch")
    e.add_argument("--ensemble-cy", default=None, metavar="LIST",
                   help="comma-separated cy values (same length as "
                        "--ensemble-cx)")
    c = p.add_argument_group("convergence")
    c.add_argument("--convergence", action="store_true")
    c.add_argument("--interval", type=int, default=20)
    c.add_argument("--sensitivity", type=float, default=0.1)
    o = p.add_argument_group("output")
    o.add_argument("--outdir", default=".")
    o.add_argument("--dat-layout", default="rowmajor",
                   choices=["rowmajor", "baseline", "none"],
                   help="text dump layout; 'baseline' matches "
                        "mpi_heat2Dn.c prtdat orientation")
    o.add_argument("--binary-dumps", action="store_true",
                   help="also write initial_binary.dat/final_binary.dat "
                        "(MPI-IO byte format)")
    o.add_argument("--checkpoint", default=None,
                   help="path to write a loadable checkpoint of the final "
                        "state (the JAX package's format)")
    o.add_argument("--resume", default=None,
                   help="checkpoint file to resume from (the remaining "
                        "steps run); either stack's checkpoints load")
    o.add_argument("--run-record", default=None,
                   help="path for the JSON run record")
    o.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the run's telemetry as JSONL: the "
                        "registry's events (run_start) and snapshot "
                        "(steps_done, elapsed_s, warmup_compile_s "
                        "gauges), then the run record; on convergence "
                        "runs the loops' residual reads stream into it "
                        "(the same reads, no extra launch)")
    o.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace of the run "
                        "(warmup and timed run) into LOGDIR; digest it "
                        "with heat2d-tpu-torch-prof LOGDIR, or view it "
                        "at ui.perfetto.dev. On the card a capture "
                        "without a kernel event is an error")
    o.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="arm request tracing (obs/tracing.py): host "
                        "spans (the run root, phase() entries) land as "
                        "JSONL in DIR; merge with heat2d-tpu-torch-trace "
                        "DIR. The launches are the same either way. The "
                        "run record gains trace_id")
    add_log_level_flag(p)
    p.add_argument("--accum-dtype", default="float32",
                   choices=["float32", "float64"],
                   help="float64 mirrors the C reference's double promotion")
    p.add_argument("--bitwise-parity", action="store_true",
                   help="pallas mode: use the literal reference stencil "
                        "expression instead of the FMA factoring, making "
                        "results bitwise identical to --mode serial")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device-info", action="store_true",
                   help="print device summary (detailsGPU analogue) and exit")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the CUDA card (default) or, with the "
                        "plain PyTorch versions of the kernels, the CPU")
    m = p.add_argument_group(
        "multi-process (the mpiexec launch line; under torchrun pass "
        "--multihost and none of the others)")
    m.add_argument("--coordinator", default=None,
                   help="coordinator address host:port, where process 0 "
                        "serves the torch.distributed store")
    m.add_argument("--num-processes", type=int, default=None)
    m.add_argument("--process-id", type=int, default=None)
    m.add_argument("--multihost", action="store_true",
                   help="initialize torch.distributed from torchrun's "
                        "environment (MASTER_ADDR, MASTER_PORT, "
                        "WORLD_SIZE, RANK)")
    return p


def _add_tuned(record: dict) -> None:
    """The tuned configs this process applied (``tune.runtime``), as the
    record's ``tuned_config``; no key when none was (no db, or no answer
    the planners took)."""
    from heat2d_tpu_torch.tune import runtime as tune_runtime
    tuned = tune_runtime.applied_configs()
    if tuned:
        record["tuned_config"] = tuned


def _registry(args, cfg):
    """The metrics registry of ``--metrics-out`` (None without it), its
    ``run_start`` event recorded."""
    if not args.metrics_out:
        return None
    from heat2d_tpu_torch.obs import MetricsRegistry
    registry = MetricsRegistry()
    registry.event("run_start", mode=cfg.mode,
                   grid=f"{cfg.nxprob}x{cfg.nyprob}", steps=cfg.steps)
    return registry


def _add_trace(record: dict, args) -> None:
    """The run's trace (``--trace-dir``) as the record's ``trace_id``."""
    if getattr(args, "trace_span", None) is not None:
        record["trace_id"] = args.trace_span.ctx.trace_id


def _run_ensemble_cli(args, cfg) -> int:
    """A batched (cx, cy) parameter sweep in one launch: the JAX CLI's
    ensemble route (``heat2d_tpu/cli.py``). Modes serial and pallas run
    on one device; dist1d, dist2d and hybrid shard the members over the
    slots of ``--host-device-count`` (or the visible cards); ``--mode
    dist2d --gridx/--gridy`` decomposes each member over a submesh.
    Flags the route would silently ignore are refused."""
    from heat2d_tpu_torch.io.binary import write_json_atomic
    from heat2d_tpu_torch.io.writers import (write_grid_baseline,
                                             write_grid_rowmajor)
    from heat2d_tpu_torch.models.ensemble import (ensemble_summary,
                                                  timed_ensemble)
    from heat2d_tpu_torch.obs.record import build_record

    try:
        cxs = [float(s) for s in (args.ensemble_cx or "").split(",") if s]
        cys = [float(s) for s in (args.ensemble_cy or "").split(",") if s]
    except ValueError as e:
        print(f"bad ensemble list: {e}\nQuitting...", file=sys.stderr)
        return 1
    if not cxs or len(cxs) != len(cys):
        print("--ensemble-cx and --ensemble-cy must be non-empty, "
              "equal-length comma-separated lists\nQuitting...",
              file=sys.stderr)
        return 1
    spatial_grid = None
    if cfg.numworkers is not None:
        print(f"ensemble runs do not take --numworkers "
              f"{cfg.numworkers}: members shard over a batch mesh axis "
              f"(use --mode dist2d --gridx/--gridy for members too big "
              f"for one device)\nQuitting...", file=sys.stderr)
        return 1
    if cfg.gridx != 1 or cfg.gridy != 1:
        if cfg.mode != "dist2d":
            print(f"ensemble spatial decomposition (--gridx {cfg.gridx} "
                  f"--gridy {cfg.gridy}) is only supported with --mode "
                  f"dist2d (members run the 2D wide-halo scheme on a "
                  f"batch x spatial mesh)\nQuitting...", file=sys.stderr)
            return 1
        spatial_grid = (cfg.gridx, cfg.gridy)
    unsupported = [flag for flag, on in [
        ("--binary-dumps", args.binary_dumps),
        ("--checkpoint", args.checkpoint is not None),
        ("--resume", args.resume is not None),
        ("--profile", args.profile is not None),
        # the batched routes evaluate steps and residuals in f32, and the
        # ensemble kernels take the FMA form only
        ("--accum-dtype float64", cfg.accum_dtype == "float64"),
        ("--bitwise-parity", cfg.bitwise_parity)] if on]
    if unsupported:
        print(f"ensemble runs do not support {', '.join(unsupported)} "
              f"(members are dumped as final_m<i>.dat only)\nQuitting...",
              file=sys.stderr)
        return 1

    sharded = cfg.mode in SHARDED_MODES
    registry = _registry(args, cfg)
    telemetry = None
    if (registry is not None and cfg.convergence and not sharded
            and spatial_grid is None):
        # chunk progress where one device reads the whole batch (the
        # sharded loops read each slot's members)
        from heat2d_tpu_torch.obs import TelemetryStream
        telemetry = TelemetryStream(registry=registry)
    try:
        devices = None
        if sharded:
            from heat2d_tpu_torch.parallel.mesh import (host_devices,
                                                        visible_devices)
            devices = (host_devices(args.host_device_count, args.device)
                       if args.host_device_count
                       else visible_devices(args.device))
        print(f"Starting ensemble of {len(cxs)} members"
              + (f" over {len(devices)} devices" if sharded else ""))
        print(f"Problem size:{cfg.nxprob}x{cfg.nyprob}")
        if cfg.problem != "heat5":
            print(f"Problem family: {cfg.problem}")
        if spatial_grid:
            print(f"Each member decomposed over a "
                  f"{spatial_grid[0]}x{spatial_grid[1]} spatial submesh")
        print(f"Amount of iterations: {cfg.steps}")
        if cfg.convergence:
            print(f"Check for convergence every {cfg.interval} iterations")
        run = timed_ensemble(
            cfg.nxprob, cfg.nyprob, cfg.steps, cxs, cys,
            method="auto" if cfg.method == "explicit" else cfg.method,
            convergence=cfg.convergence, interval=cfg.interval,
            sensitivity=cfg.sensitivity, problem=cfg.problem,
            device=args.device, sharded=sharded, devices=devices,
            spatial_grid=spatial_grid, halo_depth=cfg.halo_depth,
            halo=cfg.halo,
            tap=telemetry.tap_members if telemetry is not None else None)
    except (ConfigError, ValueError, DeviceUnavailableError) as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    steps_done = (None if run.steps_done is None
                  else [int(k) for k in run.steps_done.cpu()])
    if steps_done is not None:
        print(f"Members exited after {steps_done} iterations")
    print(f"Elapsed time: {run.elapsed:e} sec")
    batch = run.batch.cpu().numpy()
    os.makedirs(args.outdir, exist_ok=True)
    if args.dat_layout != "none":
        writer = (write_grid_baseline if args.dat_layout == "baseline"
                  else write_grid_rowmajor)
        for i, member in enumerate(batch):
            name = f"final_m{i}.dat"
            writer(member, os.path.join(args.outdir, name))
            print(f"Writing {name} ...")
    record = build_record(
        "ensemble", config=cfg, elapsed_s=run.elapsed,
        warmup_s=run.warmup_s, device=args.device,
        extra={"members": [{"cx": cx, "cy": cy}
                           for cx, cy in zip(cxs, cys)],
               "summary": ensemble_summary(batch, steps_done=steps_done),
               "route": run.method,
               "residual_reads": run.residual_reads})
    if telemetry is not None and telemetry.chunk_progress():
        # present only when chunks were read: an empty list would read
        # as 'zero chunks ran'
        record["chunk_progress"] = telemetry.chunk_progress()
    _add_tuned(record)
    _add_trace(record, args)
    if registry is not None:
        registry.gauge("elapsed_s", float(run.elapsed))
        registry.gauge("members", len(cxs))
        registry.write_jsonl(args.metrics_out,
                             extra_records=[{"event": "run_record",
                                             **record}])
    if args.run_record:
        write_json_atomic(record, args.run_record)
    if cfg.debug:
        print(json.dumps(record, indent=2))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure_logging(args.log_level)
    args.trace_span = None
    if args.trace_dir:
        # the explicit flag wins over a stale HEAT2D_TRACE_DIR (else the
        # campaign splits across two directories); the root span gives
        # phase() spans a parent and the record a trace_id
        os.environ["HEAT2D_TRACE_DIR"] = args.trace_dir
        from heat2d_tpu_torch.obs import tracing
        tracing.install(tracing.Tracer(args.trace_dir, service="cli"))
        args.trace_span = tracing.begin(
            "cli.run", kind="request", mode=args.mode,
            grid=f"{args.nxprob}x{args.nyprob}", steps=args.steps)
        tracing.set_ambient(args.trace_span.ctx)
    from heat2d_tpu_torch.obs import flight
    flight.maybe_install_from_env(service="cli")
    try:
        return _main_world(args)
    finally:
        if args.trace_span is not None:
            args.trace_span.end()


def _main_world(args) -> int:
    multihost = (args.multihost or args.coordinator is not None
                 or args.num_processes is not None
                 or args.process_id is not None)
    if not multihost:
        return _main(args)
    from heat2d_tpu_torch.parallel import multihost as mh
    try:
        world = mh.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id,
            force=True)
    except ValueError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    try:
        if args.debug:
            print(f"multihost world: {world}")
        return _main(args)
    finally:
        mh.shutdown_distributed()


def _main(args) -> int:
    from heat2d_tpu_torch.parallel import multihost as mh
    if args.device_info:
        from heat2d_tpu_torch.utils.device import print_device_summary
        print_device_summary(args.device)
        return 0
    try:
        cfg = HeatConfig(
            nxprob=args.nxprob, nyprob=args.nyprob, steps=args.steps,
            cx=args.cx, cy=args.cy, convergence=args.convergence,
            interval=args.interval, sensitivity=args.sensitivity,
            mode=args.mode, accum_dtype=args.accum_dtype, debug=args.debug,
            bitwise_parity=args.bitwise_parity, method=args.method,
            problem=args.problem, gridx=args.gridx, gridy=args.gridy,
            numworkers=args.numworkers,
            strict_baseline=args.strict_baseline,
            halo_depth=args.halo_depth, halo=args.halo)
    except ConfigError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1
    if args.ensemble_cx or args.ensemble_cy:
        if mh.is_multiprocess():
            print("ensemble runs across processes are not ported yet "
                  "(ROADMAP.md); run them in one process\nQuitting...",
                  file=sys.stderr)
            return 1
        return _run_ensemble_cli(args, cfg)
    registry = _registry(args, cfg)
    telemetry = None
    if registry is not None and cfg.convergence:
        from heat2d_tpu_torch.obs import TelemetryStream
        telemetry = TelemetryStream(registry=registry)
    try:
        from heat2d_tpu_torch.models.solver import Heat2DSolver
        devices = owners = None
        if mh.is_multiprocess():
            devices, owners = mh.world_slots(args.host_device_count or 1,
                                             args.device)
        elif args.host_device_count:
            from heat2d_tpu_torch.parallel.mesh import host_devices
            devices = host_devices(args.host_device_count, args.device)
        solver = Heat2DSolver(cfg, device=args.device, devices=devices,
                              owners=owners, telemetry=telemetry)
    except (ConfigError, ValueError, DeviceUnavailableError) as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1

    from heat2d_tpu_torch.io.binary import (CheckpointCorruptError,
                                            load_checkpoint, read_binary,
                                            save_checkpoint, write_binary,
                                            write_binary_sharded,
                                            write_json_atomic)
    from heat2d_tpu_torch.io.writers import (write_grid_baseline,
                                             write_grid_rowmajor)

    # Output and logging are process 0's (the master prints and writes
    # final.dat; grad1612_mpi_heat.c:66-69, 319-323).
    primary = mh.process_index() == 0

    def say(msg):
        if primary:
            print(msg)

    # Startup banner (grad1612_mpi_heat.c:66-69).
    say(f"Starting with {cfg.n_shards} shards")
    say(f"Problem size:{cfg.nxprob}x{cfg.nyprob}")
    if cfg.problem != "heat5":
        say(f"Problem family: {cfg.problem}")
    if cfg.mode in ("dist2d", "hybrid"):
        say(f"Each shard will take: {cfg.xcell}x{cfg.ycell}")
    say(f"Amount of iterations: {cfg.steps}")
    if cfg.convergence:
        say(f"Check for convergence every {cfg.interval} iterations")
    if cfg.debug and solver.mesh is not None:
        # The DEBUG topology dump (grad1612_mpi_heat.c:170-175), -1 = no
        # neighbour (MPI_PROC_NULL).
        from heat2d_tpu_torch.parallel.mesh import neighbor_table
        for row in neighbor_table(*solver.mesh.shape):
            say(f"shard {row['shard']} at ({row['x']},{row['y']}): "
                f"N={row['north']} S={row['south']} "
                f"W={row['west']} E={row['east']}")

    start_step = 0
    if args.resume:
        try:
            grid, start_step, _ = load_checkpoint(args.resume,
                                                  shape=cfg.shape)
        except CheckpointCorruptError as e:
            print(f"ERROR: checkpoint failed integrity verification "
                  f"({e})\nQuitting...", file=sys.stderr)
            return 1
        say(f"Resuming from step {start_step}")
        if tuple(grid.shape) != cfg.shape:
            print(f"ERROR: checkpoint grid is {grid.shape[0]}x"
                  f"{grid.shape[1]} but config is {cfg.nxprob}x"
                  f"{cfg.nyprob}\nQuitting...", file=sys.stderr)
            return 1
        solver = Heat2DSolver(
            cfg.replace(steps=max(cfg.steps - start_step, 0)),
            device=args.device, devices=devices, owners=owners,
            telemetry=telemetry)
        u0 = solver.place(grid)
    else:
        u0 = solver.init_state()

    def write_dat(u_host, name):
        if args.dat_layout == "none" or not primary:
            return
        path = os.path.join(args.outdir, name)
        if args.dat_layout == "baseline":
            write_grid_baseline(u_host, path)
        else:
            write_grid_rowmajor(u_host, path)
        print(f"Writing {name} ...")

    def dump_binary(u, name):
        """A sharded state is written shard by shard (the MPI-IO
        analogue; collective when it spans processes), a single grid as
        it is. Returns the path."""
        path = os.path.join(args.outdir, name)
        if solver.mesh is not None:
            write_binary_sharded(u, path, shape=cfg.shape)
        else:
            write_binary(u, path)
        return path

    def to_host(u, binary_path=None):
        """The grid on the host for text output. A grid that spans
        processes and was just dumped is read back by process 0 (the
        reference's binary->text conversion, grad1612_mpi_heat.c:
        319-323) instead of gathered; others get None."""
        if binary_path is not None and getattr(u, "spans_processes", False):
            return read_binary(binary_path, cfg.shape) if primary else None
        return mh.gather_to_host(u)[:cfg.nxprob, :cfg.nyprob]

    os.makedirs(args.outdir, exist_ok=True)
    init_bin = None
    if args.binary_dumps:
        init_bin = dump_binary(u0, "initial_binary.dat")
    if args.dat_layout != "none":
        write_dat(to_host(u0, init_bin), "initial.dat")

    from heat2d_tpu_torch.utils.profiling import profile_span
    # the capture wraps the whole run; the timed window inside it is
    # fenced as without it
    with profile_span(args.profile, device=solver.device):
        result = solver.run(u0=u0, gather=False)
    total_steps = start_step + result.steps_done
    say(f"Exiting after {result.steps_done} iterations")
    say(f"Elapsed time: {result.elapsed:e} sec")
    fin_bin = None
    if args.binary_dumps:
        fin_bin = dump_binary(result.u, "final_binary.dat")
    u_host = None
    if args.dat_layout != "none":
        u_host = to_host(result.u, fin_bin)
        write_dat(u_host, "final.dat")
    if args.checkpoint:
        if getattr(result.u, "spans_processes", False):
            # the per-shard collective write (every process)
            save_checkpoint(result.u, total_steps, cfg, args.checkpoint,
                            shape=cfg.shape)
        else:
            if u_host is None:
                u_host = to_host(result.u)
            if primary:
                save_checkpoint(u_host, total_steps, cfg, args.checkpoint)

    record = result.to_record()
    record["total_steps_including_resume"] = total_steps
    if args.resume:
        record["resume_from_step"] = start_step
    if solver.mesh is not None and mh.is_multiprocess():
        # every process's shard-kernel launches (warmup included) and
        # cross-rank exchange totals over the timed run, gathered (a
        # collective: every process calls it)
        from heat2d_tpu_torch.ops.cuda_shard import launch_counts
        from heat2d_tpu_torch.utils.timing import gather_over_processes
        for key, counts in (("launches_by_process", launch_counts()),
                            ("exchange_by_process", result.exchange)):
            cols = {k: gather_over_processes(v) for k, v in counts.items()}
            record[key] = [{k: type(counts[k])(col[p])
                            for k, col in cols.items()}
                           for p in range(mh.process_count())]
    _add_tuned(record)
    _add_trace(record, args)
    if telemetry is not None:
        # a resumed run's engine counts from 0: shift the streamed steps
        # to absolute step numbers (total_steps_including_resume)
        record["residual_trajectory"] = [
            {"step": p["step"] + start_step, "residual": p["residual"]}
            for p in telemetry.trajectory()]
    if registry is not None:
        registry.gauge("steps_done", result.steps_done)
        registry.gauge("elapsed_s", result.elapsed)
        if result.warmup_s is not None:
            registry.gauge("warmup_compile_s", result.warmup_s)
        # a collective in a world: every process calls it
        record["metrics_aggregate"] = registry.aggregate_multihost()
        if primary:
            registry.write_jsonl(args.metrics_out,
                                 extra_records=[{"event": "run_record",
                                                 **record}])
    if args.run_record and primary:
        write_json_atomic(record, args.run_record)
    if cfg.debug and primary:
        print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
