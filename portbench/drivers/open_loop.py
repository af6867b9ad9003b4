"""Open loop: requests sent to the program's in-process server
(``serve.SolveServer`` at its defaults) at their due times, whatever the
server's state, each request one solve with its own ``(cx, cy)`` from the
seed.

Traffic parameters (``traffic/<mix>.json``): ``rate`` (requests a
second, fixed in the cell's file under ``traffic_params``), ``cx_range``, ``warm_batches`` (the
occupancies warmed before the window: each of the launch capacities the
window's traffic meets). Cell parameters: ``check.samples`` (answers
compared with the reference, drawn from the seed among every request due
in the window), ``check.block`` (members the reference steps together),
``trace.seconds`` (the traced slice, in the middle of the window).

Every request is timed from the time it was due to the time its answer
(or its refusal) reached the client; a request that failed, was refused
or was not answered within a minute of the window's close counts as
missing any limit. ``solve_p95_ms`` is the 95th percentile over every
request due in the window.
"""

from __future__ import annotations

import sys
import threading
import time

import torch

from portbench import generate, yardstick
from portbench.reference import heat5

#: How long after the window's close an answer is waited for.
DRAIN_S = 60.0
#: The percentile of ``solve_p95_ms``.
PCT = 95.0


def _recording_registry(watch):
    """A metrics registry of the program that also keeps every value
    observed under the names in ``watch`` (the batcher's histograms keep
    a summary only)."""
    from heat2d_tpu_torch.obs.metrics import MetricsRegistry

    class Recording(MetricsRegistry):
        def __init__(self):
            super().__init__()
            self.raw = {n: [] for n in watch}
            self._raw_lock = threading.Lock()

        def observe(self, name, value, **labels):
            super().observe(name, value, **labels)
            if name in self.raw:
                with self._raw_lock:
                    self.raw[name].append(float(value))

        def take(self, name):
            with self._raw_lock:
                out, self.raw[name] = self.raw[name], []
            return out

    return Recording()


class Driver:
    kind = "serve"

    def __init__(self, cell, seed: int, devices):
        self.cell = cell
        self.seed = seed
        self.devices = devices
        c = cell.config
        self.nx, self.ny, self.steps = c["nxprob"], c["nyprob"], c["steps"]
        lo, hi = cell.traffic["cx_range"]
        self.pairs = generate.Pairs(seed, lo, hi)
        self.server = None
        self.sampled = {}       # arrival index -> (cx, cy, u, steps_done)
        self.occupancy, self.queue_wait = [], []
        self.wrap = None        # a test's fault around the engine's call

    # -- the program ------------------------------------------------------ #

    def _request(self, cx: float, cy: float):
        from heat2d_tpu_torch.serve import SolveRequest
        return SolveRequest(nx=self.nx, ny=self.ny, steps=self.steps,
                            cx=cx, cy=cy)

    def setup(self) -> None:
        from heat2d_tpu_torch.serve import SolveServer
        self.reg = _recording_registry(("serve_batch_occupancy",
                                        "serve_queue_wait_s"))
        self.server = SolveServer(registry=self.reg, device=self.devices[0])
        engine = self.server.engine
        solve_batch = engine.solve_batch
        if self.wrap is not None:
            solve_batch = self.wrap(solve_batch)
        upd, flops, nbytes = yardstick.solve_work(self.nx, self.ny,
                                                  self.steps)

        def marked(reqs):
            n = len(reqs)
            with torch.profiler.record_function(
                    f"portbench.work:{n * upd}:{n * flops}:{n * nbytes}"):
                return solve_batch(reqs)

        engine.solve_batch = marked
        self.server.start()
        for n in self.cell.traffic["warm_batches"]:
            futs = [self.server.submit(self._request(*self.pairs.next()))
                    for _ in range(n)]
            for f in futs:
                f.result(timeout=600)

    def run_rate(self, rate: float, seconds: float, capture=None) -> dict:
        """Offer ``rate`` requests a second for ``seconds``; wait for
        every answer. Returns the latencies (None for a request that
        failed or never came), the counts and the drain time."""
        due = generate.arrivals(self.seed, rate, seconds)
        n = len(due)
        pairs = self.pairs.take(n)
        keep = set(generate.sample(self.seed, n,
                                   self.cell.check.get("samples", 0)))
        done_at = [None] * n
        outcome = [None] * n
        all_done = threading.Event()
        left = [n]
        lock = threading.Lock()
        self.reg.take("serve_batch_occupancy")
        self.reg.take("serve_queue_wait_s")

        def on_done(i, fut):
            t = time.perf_counter()
            exc = fut.exception()
            if exc is None:
                res = fut.result()
                outcome[i] = "completed"
                if i in keep:
                    self.sampled[i] = (pairs[i][0], pairs[i][1], res.u,
                                       res.steps_done)
            else:
                outcome[i] = type(exc).__name__ + ":" + str(
                    getattr(exc, "code", ""))
            done_at[i] = t
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()

        t0 = time.perf_counter() + 0.05

        def pace():
            for i, (dt, (cx, cy)) in enumerate(zip(due, pairs)):
                wait = t0 + dt - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                fut = self.server.submit(self._request(cx, cy))
                fut.add_done_callback(lambda f, i=i: on_done(i, f))

        pacer = threading.Thread(target=pace, name="portbench-pacer")
        pacer.start()
        if capture is not None:
            slice_s = self.cell.trace.get("seconds", 2.0)
            lead = max(0.0, (seconds - slice_s) / 2)
            time.sleep(max(0.0, t0 + lead - time.perf_counter()))
            capture.start()
            time.sleep(slice_s)
            capture.stop()
        pacer.join()
        t_close = t0 + seconds
        all_done.wait(timeout=max(0.0, t_close + DRAIN_S
                                  - time.perf_counter()))
        lat = [done_at[i] - (t0 + due[i])
               if outcome[i] == "completed" else None for i in range(n)]
        unanswered = sum(o is None for o in outcome)
        failed = sum(o not in (None, "completed") for o in outcome)
        errors = sum(o is not None and o != "completed"
                     and not o.startswith("Rejected") for o in outcome)
        last = max((t for t in done_at if t is not None), default=t_close)
        self.occupancy = self.reg.take("serve_batch_occupancy")
        self.queue_wait = self.reg.take("serve_queue_wait_s")
        return {"latencies": lat, "attempted": n, "failed": failed
                + unanswered, "unanswered": unanswered, "errors": errors,
                "completed_in_window": sum(
                    1 for t in done_at if t is not None and t <= t_close),
                "drain_s": last - t_close}

    def window(self, seconds: float, capture) -> dict:
        r = self.run_rate(self.cell.traffic["rate"], seconds, capture)
        p = yardstick.percentile_missing_inf(r["latencies"], PCT)
        if p == float("inf"):
            # more requests failed than the percentile leaves out: report
            # the longest wait the run could see, the window and the drain
            p = seconds + DRAIN_S
            print(f"more than {100 - PCT:g}% of the requests failed or "
                  f"never came: p{PCT:g} reported as {p:g} s",
                  file=sys.stderr)
        r["metrics"] = {"solve_p95_ms": (p * 1e3, "ms")}
        return r

    def release(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self.devices[0].type == "cuda":
            torch.cuda.synchronize(self.devices[0])
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------- #

    def check(self) -> dict:
        """The widest grid gaps over the sampled answers, each against the
        reference's solve of its own ``(cx, cy)``, and the widest
        difference in steps done."""
        items = [self.sampled[i] for i in sorted(self.sampled)]
        if not items:
            # no sampled request was answered: nothing passes
            return {}
        return heat5.check_answers(
            items, self.nx, self.ny, self.steps,
            block=self.cell.check.get("block", 8), device=self.devices[0])

    def layer_ctx(self) -> dict:
        return {"kind": self.kind, "occupancy": self.occupancy,
                "queue_wait_s": self.queue_wait}
