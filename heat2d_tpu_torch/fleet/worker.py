"""Fleet worker: one ``SolveServer`` behind a stdio wire. The port's copy
of ``heat2d_tpu/fleet/worker.py``.

Runs as a subprocess of the fleet supervisor (``python -m
heat2d_tpu_torch.fleet.worker --device cuda|cpu``): a full serving stack
(micro-batcher, worker-local result cache, retry/watchdog/breaker) whose
front door is the JSONL protocol of ``fleet/wire.py`` instead of an
in-process ``submit()``. All fleet policy (routing, failover,
cross-worker dedup, quotas) lives in the router's process; a worker
serves what it is handed and proves it is alive.

Device: ``--device`` (``cuda`` by default) is where the server's engine
runs; on ``cuda`` the worker makes its CUDA context and loads the hand
kernels' libraries before it reports ready, so that its ``startup``
stamps (the host's monotonic clock, which the supervisor's spawn time
shares) split a start into the interpreter with its imports (up to
``main``), the context and the library loads. A worker that cannot
reach its device raises, so the process exits nonzero with the error on
stderr: it never answers from another device.

Liveness: a daemon thread heartbeats every ``--heartbeat`` seconds,
carrying the process's hand-kernel launch counts and the tuning-db
configs its launches took (``TunedTally``: what a rollout's canary ran,
read by the supervisor). The chaos hook
``chaos.heartbeat_point()`` sits in front of each beat
(``HEAT2D_CHAOS_HEARTBEAT_DROP_AFTER``), and
``chaos.worker_request_point()`` in each request pickup
(``HEAT2D_CHAOS_WORKER_KILL_AFTER``, ``HEAT2D_CHAOS_SLOW_WORKER_S``).
Chaos config arrives through the environment, so the supervisor can aim
a campaign at one worker with per-slot env vars.

Shutdown: a ``{"event": "shutdown"}`` line, or stdin EOF (what a dead
supervisor looks like), drains the server (``stop(drain=True)``: every
admitted request resolves and its response line is flushed) and exits 0.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time

from heat2d_tpu_torch.analysis.locks import AuditedLock

log = logging.getLogger("heat2d_tpu_torch.fleet.worker")

#: the kernel libraries a serving worker launches from (``ops/_build``)
SERVE_LIBRARIES = ("stencil", "ensemble", "family")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat2d-tpu-torch-fleet-worker",
        description="fleet worker: a SolveServer behind the JSONL "
                    "stdio wire (spawned by the fleet supervisor)")
    p.add_argument("--worker-id", type=int, default=0)
    p.add_argument("--heartbeat", type=float, default=0.25, metavar="S")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the worker's engine runs (default cuda)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay", type=float, default=0.005)
    p.add_argument("--queue-depth", type=int, default=256)
    p.add_argument("--cache-size", type=int, default=256)
    p.add_argument("--timeout", type=float, default=30.0)
    return p


class TunedTally:
    """The tuning-db plans a worker's launches took, as its heartbeat
    carries them: [signature, capacity, tuned_config, launches] per
    distinct (signature, capacity, tuned config) among the engine's
    launch rows (``tuned_config`` None for the planner's own). Each call
    reads only the rows appended since the last one, so a beat costs
    the launches since the previous beat plus the groups, however long
    the worker has served (``launch_log`` only grows)."""

    def __init__(self):
        self._seen = 0
        self._groups: dict = {}
        # the heartbeat thread and the exit path's last beat
        self._lock = AuditedLock("fleet.worker.tuned")

    def rows(self, launch_log) -> list:
        with self._lock:
            end = len(launch_log)
            for i in range(self._seen, end):
                row = launch_log[i]
                tuned = row.get("tuned_config")
                key = (str(row.get("signature")), row.get("capacity"),
                       json.dumps(tuned, sort_keys=True))
                group = self._groups.get(key)
                if group is None:
                    self._groups[key] = group = [key[0], key[1], tuned, 0]
                group[3] += 1
            self._seen = end
            return [list(g) for _k, g in sorted(self._groups.items())]


def _bring_up(device: str) -> dict:
    """Make the device usable before the ready line: on ``cuda`` the
    context (one tensor, synchronized) and the kernel libraries. Returns
    the monotonic stamps of each stage."""
    import torch

    from heat2d_tpu_torch.utils.device import resolve_device
    stamps = {}
    dev = resolve_device(device)
    torch.zeros(1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stamps["context"] = time.monotonic()
    if dev.type == "cuda":
        from heat2d_tpu_torch.ops import _build
        for name in SERVE_LIBRARIES:
            _build.load(name)
        stamps["builds"] = sum(1 for ev, _ in _build.EVENTS
                               if ev == "build")
    stamps["libraries"] = time.monotonic()
    return stamps


def _warm_signature(server, emit, rid: int, spec: dict) -> None:
    """Run the signature's base program (capacity 1) and report warm: one
    launch per hot signature keeps a fully cold worker out of the hot
    path; wider capacities run on demand."""
    from heat2d_tpu_torch.serve.schema import SolveRequest
    try:
        req = SolveRequest.from_dict(spec)
        server.engine.solve_batch([req])
    except Exception as e:  # noqa: BLE001 (a failed warmup must not
        #                     keep the worker out of the routing set)
        log.warning("warmup failed for %s: %r", spec, e)
    emit({"id": rid, "ok": True, "warm": True})


def main(argv=None) -> int:
    t_main = time.monotonic()
    args = build_parser().parse_args(argv)
    from heat2d_tpu_torch.fleet import wire
    from heat2d_tpu_torch.obs import MetricsRegistry, flight, tracing
    from heat2d_tpu_torch.ops._build import launch_counts
    from heat2d_tpu_torch.resil import chaos
    from heat2d_tpu_torch.serve.schema import (Rejected, SolveRequest,
                                               attach_trace)
    from heat2d_tpu_torch.serve.server import SolveServer

    stamps = _bring_up(args.device)
    registry = MetricsRegistry()
    service = f"worker{args.worker_id}"
    # Observability is env-armed (opt-in, free when unset): the fleet CLI
    # sets HEAT2D_TRACE_DIR / HEAT2D_FLIGHT_DIR and the supervisor passes
    # the environment through, so every worker joins the tracing campaign
    # and carries a black box the chaos kill points flush.
    tracing.activate_from_env(service=service)
    flight.maybe_install_from_env(service=service, registry=registry)

    # HEAT2D_MESH_SERVE=1 swaps the one-device engine for the mesh-aware
    # one over the worker's visible devices; --max-batch becomes the
    # per-slot bound.
    engine = None
    if os.environ.get("HEAT2D_MESH_SERVE", "") not in ("", "0"):
        from heat2d_tpu_torch.mesh import MeshEnsembleEngine
        from heat2d_tpu_torch.parallel.mesh import visible_devices
        engine = MeshEnsembleEngine(
            registry=registry, max_batch_per_chip=args.max_batch,
            devices=visible_devices(args.device))
    server = SolveServer(
        max_batch=args.max_batch, max_delay=args.max_delay,
        max_queue=args.queue_depth, cache_size=args.cache_size,
        default_timeout=args.timeout, device=args.device,
        registry=registry, engine=engine).start()

    wlock = AuditedLock("fleet.worker.wire")

    def emit(obj: dict) -> None:
        line = json.dumps(obj)
        with wlock:
            try:
                sys.stdout.write(line + "\n")
                sys.stdout.flush()
            except (BrokenPipeError, OSError):
                # the supervisor is gone; stdin EOF ends the loop
                pass

    def emit_line(line: bytes) -> None:
        # an answer's line, already encoded (``wire.result_line``): the
        # text layer is flushed after every emit, so the two never mix
        with wlock:
            try:
                sys.stdout.buffer.write(line)
                sys.stdout.buffer.flush()
            except (BrokenPipeError, OSError):
                pass

    tally = TunedTally()

    def beat() -> None:
        emit({"event": "hb", "worker": args.worker_id,
              "launches": launch_counts(),
              "tuned": tally.rows(server.engine.launch_log)})

    stop_hb = threading.Event()

    def hb_loop() -> None:
        while not stop_hb.wait(args.heartbeat):
            if chaos.heartbeat_point():
                beat()

    threading.Thread(target=hb_loop, name="heat2d-fleet-hb",
                     daemon=True).start()
    warm_threads: list = []
    stamps["ready"] = time.monotonic()
    ready = {"event": "ready", "pid": os.getpid(),
             "worker": args.worker_id, "protocol": wire.PROTOCOL,
             "device": args.device,
             "startup": {"main": t_main, **stamps}}
    # The tuning-db stamp this worker serves under (HEAT2D_TUNE_DB comes
    # through the supervisor's env): path, epoch, validated.
    try:
        from heat2d_tpu_torch.tune import runtime as tune_runtime
        info = tune_runtime.describe_active()
        if info is not None:
            ready["tune"] = info
    except Exception as e:  # noqa: BLE001 (a broken db must not keep
        #                     the worker from serving)
        log.warning("tune-db stamp unavailable: %r", e)
    emit(ready)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except ValueError:
            log.warning("worker %d: skipping unparseable line",
                        args.worker_id)
            continue
        if msg.get("event") == "shutdown":
            break
        if "id" not in msg:
            continue
        rid = msg["id"]
        if msg.get("event") == "warmup":
            # Warm restart: run this signature's base program off the
            # request path, then report warm. Not client load: it
            # bypasses the chaos request hook and the batcher.
            t = threading.Thread(
                target=_warm_signature,
                args=(server, emit, rid, msg.get("req") or {}),
                name="heat2d-fleet-warmup", daemon=True)
            warm_threads.append(t)
            t.start()
            continue
        # The pickup marker goes out BEFORE the chaos point: when
        # HEAT2D_CHAOS_WORKER_KILL_AFTER fires here, the flushed flight
        # ring already holds the in-flight request's span.
        ctx = wire.decode_trace(msg)
        if ctx is not None and tracing.enabled():
            tracing.event("fleet.recv", parent=ctx, rid=rid,
                          worker=args.worker_id)
        # Slow-worker latency and the mid-load hard kill land here: the
        # request is accepted (the supervisor holds it in flight) but may
        # never be answered.
        chaos.worker_request_point()
        try:
            req = SolveRequest.from_dict(msg.get("req") or {})
        except Rejected as e:
            emit(wire.encode_rejection(rid, e))
            continue
        if ctx is not None:
            attach_trace(req, ctx)  # serve spans nest under the wire's
        fut = server.submit(req)

        def _done(f, rid=rid, ctx=ctx):
            exc = f.exception()
            if exc is None:
                emit_line(wire.result_line(rid, f.result()))
            else:
                emit(wire.encode_rejection(rid, exc))
            if ctx is not None and tracing.enabled():
                tracing.event("fleet.reply", parent=ctx, rid=rid,
                              ok=exc is None, worker=args.worker_id)

        fut.add_done_callback(_done)

    # Graceful exit: drain resolves every in-flight future, and each
    # resolution's done-callback emits its response before we return; an
    # in-flight warmup launch finishes first. One last beat carries the
    # final launch counts.
    for t in warm_threads:
        t.join(timeout=120)
    server.stop(drain=True)
    stop_hb.set()
    beat()
    return 0


if __name__ == "__main__":
    sys.exit(main())
