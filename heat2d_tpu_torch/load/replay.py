"""Trace replay — recorded span timelines back into arrival schedules.
The port's copy of ``heat2d_tpu/load/replay.py``: a trace directory
written by either package's tracer replays here.

Tracing leaves one root span per served request (``fleet.
request`` at the router, ``serve.request`` at a standalone server)
carrying the request's compiled signature, tenant, and admission time.
That is exactly an arrival process: this module parses a trace
directory (the same ``load_dir``/``assemble`` reader ``heat2d-tpu-
torch-trace`` merges with — factored once in obs/trace_cli.py, consumed
twice) into a ``Schedule`` the open-loop runner can fire at a live
target, preserving every inter-arrival gap so queueing behavior is
faithful to what production saw.

What replay preserves vs synthesizes:

- **preserved** — arrival times (the whole point: burst phase and gap
  structure drive queueing), compiled signatures (grid/steps/dtype/
  method — the batching, routing, and compile-cache keys), request
  kind (solve vs inverse), tenant.
- **synthesized** — the per-request payload operands the signature
  deliberately excludes (solve diffusivities; inverse observation
  values). Spans don't record payloads (they are observability
  metadata, not a data siphon), and operands don't affect queueing —
  they ride as traced operands through one compiled program. They are
  drawn from a seeded RNG so a replay is itself deterministic.

A signature string is ``str(req.signature())`` — a literal Python
tuple — so ``ast.literal_eval`` recovers it exactly; solve and
inverse signatures are distinguished by the leading ``"inverse"``
tag (serve/schema.py, diff/serving.py).
"""

from __future__ import annotations

import ast
import random
from typing import Optional

from heat2d_tpu_torch.load.schedule import Arrival, Schedule

#: root-span names that mark one request admission. ``serve.request``
#: counts only when parentless: a fleet-served request has BOTH (the
#: worker-side serve.request nests under the router's wire span) and
#: must replay once.
ROOT_SPAN_NAMES = ("fleet.request", "serve.request")


def spec_from_signature(sig: tuple, rng: random.Random) -> tuple:
    """(kind, spec dict) for one recorded signature tuple.

    Solve signatures are ``(nx, ny, steps, dtype, method, convergence,
    interval, sensitivity)`` with an optional 9th ``problem`` element
    (the problem-registry axis: campaigns recorded before it exist as
    8-tuples and replay as problem="heat5"; current signatures carry
    the family explicitly); inverse signatures are ``("inverse", nx,
    ny, steps, target, iterations, adjoint, segment, dtype)`` — the
    layouts serve/schema.py and diff/serving.py define. Raises
    ``ValueError`` on anything else (a trace from a future schema
    should fail loudly, not replay garbage)."""
    if not isinstance(sig, tuple) or not sig:
        raise ValueError(f"not a signature tuple: {sig!r}")
    if sig[0] == "inverse":
        if len(sig) != 9:
            raise ValueError(f"malformed inverse signature: {sig!r}")
        _tag, nx, ny, steps, target, iterations, adjoint, seg, dtype = sig
        nx, ny = int(nx), int(ny)
        idx, vals = [], []
        for i in range(1, nx - 1):
            for j in range(1, ny - 1):
                if (i * ny + j) % 3 == 0:
                    idx.append(i * ny + j)
                    vals.append(round(rng.uniform(0.0, 2.0), 6))
        spec = {
            "nx": nx, "ny": ny, "steps": int(steps),
            "target": str(target), "iterations": int(iterations),
            "adjoint": str(adjoint), "dtype": str(dtype),
            "obs_indices": idx, "obs_values": vals,
        }
        if int(seg):
            spec["segment"] = int(seg)
        return "inverse", spec
    if len(sig) not in (8, 9):
        raise ValueError(f"malformed solve signature: {sig!r}")
    nx, ny, steps, dtype, method, convergence, interval, sens = sig[:8]
    # Pre-registry campaigns recorded 8-tuples: those replay as the
    # reference family (heat5, the only problem that existed).
    problem = str(sig[8]) if len(sig) == 9 else "heat5"
    spec = {
        "nx": int(nx), "ny": int(ny), "steps": int(steps),
        "dtype": str(dtype), "method": str(method),
        "convergence": bool(convergence),
        "cx": round(0.05 + 0.15 * rng.random(), 6),
        "cy": round(0.05 + 0.15 * rng.random(), 6),
    }
    if problem != "heat5":
        spec["problem"] = problem
    if convergence:
        spec["interval"] = int(interval)
        spec["sensitivity"] = float(sens)
    return "solve", spec


def _root_requests(traces: dict) -> list:
    """One (t0, signature string, tenant) row per request admission in
    a merged trace map ({trace_id: spans})."""
    rows = []
    for spans in traces.values():
        for s in spans:
            if (s.get("name") in ROOT_SPAN_NAMES
                    and not s.get("parent_id")):
                attrs = s.get("attrs") or {}
                sig = attrs.get("signature")
                if not sig:
                    continue    # e.g. cli.run roots: not serving traffic
                rows.append((float(s.get("t0", 0.0)), sig,
                             attrs.get("tenant") or "default"))
                break           # one admission per trace
    return rows


def schedule_from_trace_dir(trace_dir: str, seed: int = 0,
                            limit: Optional[int] = None) -> Schedule:
    """Parse every span file (+ flight post-mortems) under
    ``trace_dir`` into the arrival schedule the traced campaign
    actually served. ``limit`` keeps only the first N arrivals."""
    from heat2d_tpu_torch.obs import trace_cli
    loaded = trace_cli.load_dir(trace_dir)
    traces = trace_cli.assemble(loaded["spans"])
    rows = sorted(_root_requests(traces))
    if not rows:
        raise ValueError(
            f"no request root spans found under {trace_dir!r} — was "
            "the campaign recorded with --trace-dir?")
    if limit is not None:
        rows = rows[:limit]
    t_origin = rows[0][0]
    rng = random.Random(seed)
    arrivals = []
    for t0, sig_str, tenant in rows:
        try:
            sig = ast.literal_eval(sig_str)
        except (ValueError, SyntaxError):
            raise ValueError(
                f"unparseable signature in trace: {sig_str!r}") from None
        kind, spec = spec_from_signature(sig, rng)
        arrivals.append(Arrival(t=t0 - t_origin, kind=kind, spec=spec,
                                tenant=tenant))
    return Schedule(arrivals, meta={
        "source": "replay", "trace_dir": trace_dir, "seed": int(seed),
        "spans_files": loaded["files"]})
