"""``heat2d-tpu-torch-dist``: the mpiexec-style multi-process launch
surface. The port of ``heat2d_tpu/dist/cli.py``.

Three shapes, one program (the reference's ``mpiexec -np N ./heat``
launch line, with the launcher legs on top):

- **worker** (``--process-id`` given, or ``--num-processes 1``): one
  process of the world. Rendezvous, heartbeats, the store halo route
  (``dist/exchange.py``) on the process's device, collective
  store-gathered checkpoints, and, on a ``HostLostError``, the unified
  shrink+failover transaction (``dist/topology.py``) finishing the run
  from the last committed checkpoint, under the seq-fenced
  ``serving_invariant``.
- ``--selftest``: spawns its own 2-process world, then checks that the
  final grid is BITWISE the one-process program's on the same grid, and
  the plain step loop's.
- ``--soak --kill-host``: spawns a paced 2-process soak, SIGKILLs the
  process that does not serve the store after its first committed
  checkpoint, and checks that the survivor recovered through the
  coordinated shrink+failover: bitwise final parity AND
  ``serving_invariant.ok`` in the kind="dist" run record.

Every process runs on ``--device`` (``cuda`` by default: rank r on
``cuda:(r % device_count)``; ``cpu`` when asked). Post-loss exits use
``os._exit``: tearing the world down would wait on the dead peer, and a
survivor that already wrote and fsync'd its outputs owes it nothing.

    heat2d-tpu-torch-dist --selftest --device cpu
    heat2d-tpu-torch-dist --selftest --nx 4096 --ny 4096 --steps 64 \\
        --segment 8            # on the card
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time

import numpy as np

from heat2d_tpu_torch.dist.exchange import (DcnHaloExchanger,
                                            run_process_slab, slab_split)
from heat2d_tpu_torch.dist.runtime import (KV_NS, Heartbeat, HostLostError,
                                           KVBarrier, bring_up,
                                           elect_recovery_owner, kv_client)
from heat2d_tpu_torch.dist.topology import (FailureDomainBridge,
                                            PodTopology, pod_monitor)
from heat2d_tpu_torch.utils.device import DeviceUnavailableError


def _args(argv=None):
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-dist",
        description="the multi-process runtime of the port (KV barriers, "
                    "heartbeats, the store halo route, host loss)")
    w = p.add_argument_group("world (mpiexec-style)")
    w.add_argument("--coordinator", default=None,
                   help="host:port where process 0 serves the store")
    w.add_argument("--num-processes", type=int, default=1)
    w.add_argument("--process-id", type=int, default=None)
    w.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run every process on the card (default; rank r "
                        "on cuda:(r %% device_count)) or on the CPU")
    g = p.add_argument_group("problem")
    g.add_argument("--nx", type=int, default=48)
    g.add_argument("--ny", type=int, default=32)
    g.add_argument("--steps", type=int, default=16)
    g.add_argument("--segment", type=int, default=4,
                   help="halo depth = steps per exchange segment")
    g.add_argument("--cx", type=float, default=0.1)
    g.add_argument("--cy", type=float, default=0.1)
    s = p.add_argument_group("state")
    s.add_argument("--checkpoint", default=None,
                   help="collective checkpoint path (store-gathered, "
                        "committed crash-consistently by process 0)")
    s.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between checkpoints (0 = off)")
    s.add_argument("--resume", default=None,
                   help="checkpoint to resume from (any saving process "
                        "count: a reshard is a slice)")
    s.add_argument("--out", default=None,
                   help="final full-grid raw f32 (written by the recovery "
                        "owner / process 0)")
    s.add_argument("--run-record", default=None)
    t = p.add_argument_group("liveness")
    t.add_argument("--halo-timeout", type=float, default=60.0,
                   help="bounded wait for a peer's strip or shard before "
                        "declaring it lost")
    t.add_argument("--heartbeat", type=float, default=0.0,
                   help="beacon interval seconds (0 = off)")
    t.add_argument("--pace", type=float, default=0.0,
                   help="sleep per segment (soak windowing)")
    t.add_argument("--marker", default=None,
                   help="file process 0 writes after the first committed "
                        "checkpoint (the soak's kill window)")
    d = p.add_argument_group("launcher legs (spawn their own world)")
    d.add_argument("--selftest", action="store_true",
                   help="2-process vs one-process bitwise parity")
    d.add_argument("--soak", action="store_true")
    d.add_argument("--kill-host", action="store_true",
                   help="SIGKILL the process that does not serve the "
                        "store mid-soak")
    d.add_argument("--outdir", default=None)
    d.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a spawned world may run before all its "
                        "processes are killed")
    return p.parse_args(argv)


def _say(world, msg: str) -> None:
    print(f"[dist p{world.process_index}/{world.process_count}] {msg}",
          flush=True)


def _metric_totals(reg) -> dict:
    """The dist_* families as plain numbers for the run record."""
    out = {}
    for name in ("dist_halo_bytes_total", "dist_host_lost_total",
                 "dist_checkpoint_gather_bytes_total"):
        vals = reg.find_counters(name)
        if vals:
            out[name] = float(sum(vals.values()))
    for name in ("dist_rendezvous_s", "dist_heartbeat_age_s"):
        vals = reg.find_gauges(name)
        if vals:
            out[name] = {("" if not k else str(dict(k))): v
                         for k, v in vals.items()}
    return out


def _write_record(path, extra: dict, device=None) -> None:
    from heat2d_tpu_torch.io.binary import write_text_atomic
    from heat2d_tpu_torch.obs.record import build_record

    rec = build_record("dist", extra=extra, device=device)
    write_text_atomic(json.dumps(rec, indent=2, default=str,
                                 sort_keys=True), path)


# ------------------------------------------------------------------ #
# worker
# ------------------------------------------------------------------ #

def _load_state(args):
    """(full grid at start, start step): a resume is process-count
    agnostic, every process loads the FULL committed grid and slices its
    own slab (the N-save -> M-restore reshard contract)."""
    from heat2d_tpu_torch.io.binary import load_checkpoint
    from heat2d_tpu_torch.ops.init import inidat

    if args.resume:
        grid, step, _ = load_checkpoint(args.resume)
        return np.asarray(grid, np.float32), int(step)
    return inidat(args.nx, args.ny, device="cpu").numpy(), 0


def _save_collective(args, world, barrier, owned, step, reg) -> None:
    """An N-process checkpoint: every process publishes its OWNED slab to
    the store; process 0 assembles the full grid and commits it through
    the crash-consistent one-file path (``io/binary.py``), and the
    closing barrier keeps every process behind the commit."""
    from heat2d_tpu_torch.io.binary import save_checkpoint

    cfg = {"nx": args.nx, "ny": args.ny, "steps": args.steps,
           "segment": args.segment, "cx": args.cx, "cy": args.cy,
           "processes": world.process_count}
    if world.process_count == 1:
        save_checkpoint(owned, step, cfg, args.checkpoint)
        return
    kv = kv_client()
    kv.set_blob(f"{KV_NS}ck/{step}/{world.process_index}", owned.tobytes())
    reg.counter("dist_checkpoint_gather_bytes_total", float(owned.nbytes))
    if world.process_index == 0:
        slabs = []
        for pr, (lo, hi) in enumerate(
                slab_split(args.nx, world.process_count)):
            buf = kv.get_blob(f"{KV_NS}ck/{step}/{pr}", args.halo_timeout,
                              lost_host=pr, phase=f"checkpoint:{step}")
            slabs.append(np.frombuffer(buf, np.float32)
                         .reshape(hi - lo, args.ny))
        save_checkpoint(np.concatenate(slabs, axis=0), step, cfg,
                        args.checkpoint)
    barrier.wait(f"ck{step}", timeout_s=args.halo_timeout)
    if world.process_index == 0:
        for pr in range(world.process_count):
            kv.delete_blob(f"{KV_NS}ck/{step}/{pr}")


def _gather_final(args, world, owned) -> np.ndarray:
    """Process 0 assembles the final grid from every process's owned slab
    (peers publish and wait at the closing barrier)."""
    if world.process_count == 1:
        return owned
    kv = kv_client()
    me = world.process_index
    if me != 0:
        kv.set_blob(f"{KV_NS}final/{me}", owned.tobytes())
        return owned
    slabs = [owned]
    for pr, (lo, hi) in list(enumerate(
            slab_split(args.nx, world.process_count)))[1:]:
        buf = kv.get_blob(f"{KV_NS}final/{pr}", args.halo_timeout,
                          lost_host=pr, phase="final_gather")
        kv.delete_blob(f"{KV_NS}final/{pr}")
        slabs.append(np.frombuffer(buf, np.float32)
                     .reshape(hi - lo, args.ny))
    return np.concatenate(slabs, axis=0)


def _depart(world, timeout_s: float) -> None:
    """Leave the world with process 0, the store's server, last: every
    other process counts itself out and stops touching the store, and
    process 0 waits (bounded) for the count, so no peer still polling a
    barrier finds the server gone."""
    if world.process_count <= 1:
        return
    kv = kv_client()
    if world.process_index != 0:
        kv.add(f"{KV_NS}departed", 1)
        return
    deadline = time.monotonic() + timeout_s
    while (kv.add(f"{KV_NS}departed", 0) < world.process_count - 1
           and time.monotonic() < deadline):
        time.sleep(0.01)


def _worker(args) -> int:
    from heat2d_tpu_torch.mesh.degrade import serving_invariant
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    world = bring_up(args.coordinator, args.num_processes, args.process_id,
                     registry=reg, device=args.device)
    from heat2d_tpu_torch.parallel.multihost import process_device
    device = process_device(world.process_index, args.device)
    _say(world, f"world up: {world.summary()}")
    barrier = KVBarrier(world, registry=reg)
    hb = None
    if args.heartbeat > 0 and world.process_count > 1:
        hb = Heartbeat(world, interval_s=args.heartbeat, registry=reg)
        hb.start()

    topology = PodTopology.from_world(world)
    monitor = pod_monitor(topology.n_devices, registry=reg)
    bridge = FailureDomainBridge(topology, monitor, registry=reg)
    sig = f"dist:{args.nx}x{args.ny}:s{args.steps}"
    launch_log = [{"signature": sig,
                   "mesh": {"devices": list(range(topology.n_devices)),
                            "health_seq": monitor.seq()}}]

    u0, start = _load_state(args)
    exchanger = None
    if world.process_count > 1:
        exchanger = DcnHaloExchanger(
            world, args.segment, timeout_s=args.halo_timeout, registry=reg)

    state = {"last_ck": start if args.resume else None}

    def on_segment(step, owned):
        if args.pace > 0:
            time.sleep(args.pace)
        if hb is not None:
            hb.ages()     # sample dist_heartbeat_age_s each segment
        due = (args.checkpoint and args.checkpoint_every
               and step % args.checkpoint_every == 0)
        if due:
            _save_collective(args, world, barrier, owned.cpu().numpy(),
                             step, reg)
            state["last_ck"] = step
            if args.marker and world.process_index == 0 \
                    and not os.path.exists(args.marker):
                from heat2d_tpu_torch.io.binary import write_text_atomic
                write_text_atomic(str(step), args.marker)

    try:
        barrier.wait("world-up", timeout_s=args.halo_timeout)
        t0 = time.perf_counter()
        owned, step = run_process_slab(
            args.nx, args.ny, args.steps, cx=args.cx, cy=args.cy,
            depth=args.segment, process_index=world.process_index,
            process_count=world.process_count, exchanger=exchanger,
            u0=u0, start_step=start, on_segment=on_segment, device=device)
        run_s = time.perf_counter() - t0
        full = _gather_final(args, world, owned)
        if world.process_index == 0:
            if args.out:
                from heat2d_tpu_torch.io.binary import write_binary
                write_binary(full, args.out)
            if args.run_record:
                _write_record(args.run_record, {
                    "leg": "run", "world": world.summary(),
                    "steps_done": step, "resume_from_step": start,
                    "last_checkpoint_step": state["last_ck"],
                    "run_s": run_s, "launch_log": launch_log,
                    "serving_invariant":
                        serving_invariant(monitor, launch_log),
                    "bridge": bridge.snapshot(),
                    "metrics": _metric_totals(reg),
                }, device=device)
            _say(world, f"done: steps={step}")
        barrier.wait("done", timeout_s=args.halo_timeout)
        if hb is not None:
            hb.stop()
        _depart(world, args.halo_timeout)
        return 0
    except HostLostError as e:
        return _recover(args, world, e, bridge, monitor, launch_log,
                        hb, reg, sig, device)


def _recover(args, world, e, bridge, monitor, launch_log, hb, reg,
             sig, device) -> int:
    """The unified shrink+failover transaction, run by the elected
    recovery owner; standby survivors exit clean. Never returns: outputs
    are flushed and the process leaves through ``os._exit`` (module
    docstring)."""
    from heat2d_tpu_torch.mesh.degrade import serving_invariant

    lost = set(e.hosts)
    survivors = [p for p in range(world.process_count) if p not in lost]
    _say(world, f"HOST LOST: {e}")
    ages = {}
    if hb is not None:
        try:
            ages = hb.ages()
        except Exception:      # noqa: BLE001 (the store may be gone)
            pass
        hb.stop()
    owner = elect_recovery_owner(survivors)
    if world.process_index != owner:
        _say(world, f"standby survivor; p{owner} owns recovery")
        sys.stdout.flush()
        os._exit(0)

    def failover() -> dict:
        fence = monitor.seq()
        surv_devices = monitor.survivors()
        ck = args.checkpoint
        u0, ck_step = _load_state(argparse.Namespace(
            resume=(ck if ck and os.path.exists(str(ck) + ".meta.json")
                    else None),
            nx=args.nx, ny=args.ny))
        owned, step = run_process_slab(
            args.nx, args.ny, args.steps, cx=args.cx, cy=args.cy,
            depth=args.segment, u0=u0, start_step=ck_step, device=device)
        launch_log.append({"signature": sig,
                           "mesh": {"devices": list(surv_devices),
                                    "health_seq": fence}})
        if args.out:
            from heat2d_tpu_torch.io.binary import write_binary
            write_binary(owned, args.out)
        return {"resume_step": ck_step, "steps_done": step,
                "survivor_devices": list(surv_devices)}

    for i, host in enumerate(sorted(lost)):
        last = i == len(lost) - 1
        txn = bridge.on_host_lost(
            host, failover=failover if last else None)
    inv = serving_invariant(monitor, launch_log)
    if args.run_record:
        _write_record(args.run_record, {
            "leg": "host_loss_recovery", "world": world.summary(),
            "lost_hosts": sorted(lost), "phase": e.phase,
            "error": str(e), "heartbeat_ages": ages,
            "transaction": txn, "launch_log": launch_log,
            "serving_invariant": inv,
            "bridge": bridge.snapshot(),
            "metrics": _metric_totals(reg),
        }, device=device)
    _say(world, f"recovered through shrink+failover: {txn['failover']}"
                f" serving_invariant_ok={inv['ok']}")
    sys.stdout.flush()
    os._exit(0 if inv["ok"] else 4)


# ------------------------------------------------------------------ #
# launcher legs
# ------------------------------------------------------------------ #

def _reference(args) -> np.ndarray:
    """The one-process program on the same global grid: the bitwise
    anchor both launcher legs compare against."""
    ref, _ = run_process_slab(args.nx, args.ny, args.steps, cx=args.cx,
                              cy=args.cy, depth=args.segment,
                              device=args.device)
    return ref


def _plain_loop(args) -> np.ndarray:
    """The UN-segmented one-process program: one golden ``stencil_step``
    per step on the whole grid, no segments: proves the segmenting
    changes nothing."""
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.ops.stencil import stencil_step

    u = inidat(args.nx, args.ny, device=args.device)
    for _ in range(args.steps):
        u = stencil_step(u, args.cx, args.cy)
    return u.cpu().numpy()


def _worker_argv(args, outdir, extra):
    def argv_fn(i, coordinator):
        return [sys.executable, "-m", "heat2d_tpu_torch.dist.cli",
                "--coordinator", coordinator,
                "--num-processes", "2", "--process-id", str(i),
                "--device", args.device,
                "--nx", str(args.nx), "--ny", str(args.ny),
                "--steps", str(args.steps),
                "--segment", str(args.segment),
                "--cx", str(args.cx), "--cy", str(args.cy),
                "--out", os.path.join(outdir, "dist_final.bin"),
                "--run-record",
                os.path.join(outdir, "worker_record.json"),
                "--heartbeat", "0.5"] + extra
    return argv_fn


def _selftest(args) -> int:
    from heat2d_tpu_torch.dist.harness import spawn_world

    outdir = args.outdir or tempfile.mkdtemp(prefix="heat2d-dist-")
    os.makedirs(outdir, exist_ok=True)
    t0 = time.perf_counter()
    results = spawn_world(2, _worker_argv(args, outdir, []),
                          timeout=args.timeout)
    world_s = time.perf_counter() - t0
    if not all(r.ok for r in results):
        for r in results:
            print(f"--- process {r.process_id} "
                  f"(rc={r.returncode}) ---\n{r.output}")
        print("DIST SELFTEST FAILED: world did not complete")
        return 1
    got = np.fromfile(os.path.join(outdir, "dist_final.bin"),
                      np.float32).reshape(args.nx, args.ny)
    ref = _reference(args)
    plain = _plain_loop(args)
    bitwise = got.tobytes() == ref.tobytes()
    bitwise_plain = got.tobytes() == plain.tobytes()
    worker = json.load(open(os.path.join(outdir, "worker_record.json")))
    _write_record(
        args.run_record or os.path.join(outdir, "selftest_record.json"),
        {"leg": "selftest",
         "config": {"nx": args.nx, "ny": args.ny, "steps": args.steps,
                    "segment": args.segment},
         "bitwise_equal": bitwise,
         "bitwise_vs_plain_loop": bitwise_plain,
         "world_s": world_s, "worker_run_s": worker.get("run_s"),
         "halo_bytes": worker["metrics"].get("dist_halo_bytes_total"),
         "outdir": outdir}, device=args.device)
    print(f"DIST SELFTEST nx={args.nx} ny={args.ny} "
          f"steps={args.steps} segment={args.segment} "
          f"bitwise_equal={bitwise} "
          f"bitwise_vs_plain_loop={bitwise_plain}")
    return 0 if bitwise and bitwise_plain else 1


def _soak_kill_host(args) -> int:
    import subprocess

    from heat2d_tpu_torch.dist.harness import clean_env, free_port

    outdir = args.outdir or tempfile.mkdtemp(prefix="heat2d-dist-")
    os.makedirs(outdir, exist_ok=True)
    ck = os.path.join(outdir, "ck.bin")
    marker = os.path.join(outdir, "marker")
    wrec = os.path.join(outdir, "worker_record.json")
    coordinator = f"127.0.0.1:{free_port()}"
    argv_fn = _worker_argv(
        args, outdir,
        ["--checkpoint", ck,
         "--checkpoint-every", str(args.checkpoint_every or 8),
         "--pace", str(args.pace or 0.4),
         "--marker", marker,
         "--halo-timeout", str(min(args.halo_timeout, 8.0))])
    procs = [subprocess.Popen(
        argv_fn(i, coordinator), env=clean_env(), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]

    def fail(why: str) -> int:
        for q in procs:
            if q.poll() is None:
                q.kill()
        outs = [q.communicate()[0] for q in procs]
        for i, o in enumerate(outs):
            print(f"--- process {i} ---\n{o}")
        print(f"DIST SOAK FAILED: {why}")
        return 1

    deadline = time.monotonic() + args.timeout
    while not os.path.exists(marker):
        if time.monotonic() > deadline:
            return fail(f"no checkpoint marker within {args.timeout}s")
        if any(q.poll() is not None for q in procs):
            return fail("a worker exited before the kill window")
        time.sleep(0.02)
    victim = procs[1]                 # not the store's server: it lives
    if victim.poll() is not None:     # inside process 0
        return fail("victim finished before the kill")
    os.kill(victim.pid, signal.SIGKILL)
    kill_t = time.monotonic()
    print(f"killed host 1 (pid {victim.pid}) after marker {marker}",
          flush=True)
    victim.communicate()
    try:
        out0 = procs[0].communicate(
            timeout=max(deadline - time.monotonic(), 1.0))[0]
    except subprocess.TimeoutExpired:
        return fail(f"survivor did not finish within {args.timeout}s")
    print(f"--- survivor (host 0) ---\n{out0}")
    if procs[0].returncode != 0:
        return fail(f"survivor exited {procs[0].returncode}")
    recovery_wall = time.monotonic() - kill_t

    with open(wrec) as f:
        rec = json.load(f)
    inv = rec.get("serving_invariant") or {}
    got = np.fromfile(os.path.join(outdir, "dist_final.bin"),
                      np.float32).reshape(args.nx, args.ny)
    bitwise = got.tobytes() == _reference(args).tobytes()
    ok = (bitwise and rec.get("leg") == "host_loss_recovery"
          and bool(inv.get("ok")) and rec.get("lost_hosts") == [1])
    _write_record(
        args.run_record or os.path.join(outdir, "soak_record.json"),
        {"leg": "soak_kill_host", "bitwise_equal": bitwise,
         "recovery_wall_s": recovery_wall,
         "worker_record": rec, "verdict_ok": ok, "outdir": outdir},
        device=args.device)
    print(f"DIST SOAK kill-host recovered={rec.get('leg')} "
          f"serving_invariant_ok={inv.get('ok')} "
          f"bitwise_equal={bitwise} ok={ok}")
    return 0 if ok else 1


def main(argv=None) -> int:
    from heat2d_tpu_torch.utils.device import resolve_device
    args = _args(argv)
    try:
        resolve_device(args.device)
        if args.selftest:
            return _selftest(args)
        if args.soak:
            if not args.kill_host:
                print("--soak requires --kill-host (the one soak shape "
                      "so far)")
                return 2
            return _soak_kill_host(args)
        if args.num_processes > 1 and (args.coordinator is None
                                       or args.process_id is None):
            print("multi-process worker needs --coordinator and "
                  "--process-id (mpiexec-style)")
            return 2
        return _worker(args)
    except DeviceUnavailableError as e:
        print(f"{e}\nQuitting...", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
