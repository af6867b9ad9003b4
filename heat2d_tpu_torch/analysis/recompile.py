"""The kernel-build sentinel: bounded "compiles" as a checked invariant.
The port's counterpart of ``heat2d_tpu/analysis/recompile.py``.

In the JAX package a compile is an XLA compilation, and the serving
design pads batches to powers of two so that one signature compiles
O(log max_batch) programs. On the card the port compiles nothing per
shape: a hand kernel is built once per source by ``nvcc`` and loaded
once per process (``ops/_build.py``), and a launch of any shape reuses
it. What can still blow up is (a) a build or a load repeated after the
first (a library key that changes under a run, a cache that forgets),
and (b) the serve engine's ladder of launch capacities, which keeps the
launch shapes of a signature to O(log max_batch) as the JAX package's
does (``serve/engine.py``: the pad ladder).

``CompileWatch`` counts ``_build.EVENTS`` (``nvcc`` builds started,
libraries loaded) inside its block; ``assert_bounded`` turns a watch
into a gate; ``serve_compile_report`` drives every occupancy
1..max_batch of one signature through the engine and reports the
distinct launch capacities per signature beside the builds and loads.
The contracts: at most ``log2_capacity_budget(max_batch)`` capacities a
signature, and zero builds after the first load of each library in a
process (each library loaded at most once). On the CPU the wrappers run
their plain versions and build nothing, so only the capacities count.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional


class RecompileBudgetError(AssertionError):
    """A watched region built or loaded more than its budget."""


class CompileWatch:
    """Context manager counting the kernel builds and library loads
    (``ops._build.EVENTS``) inside its block.

    ``limit``: optional budget of events; exceeding it raises
    ``RecompileBudgetError`` at exit. ``match``: only count events
    whose ``"<kind>:<library>"`` name matches this regex
    (``re.search``), e.g. ``"^build:"`` for builds alone.
    """

    def __init__(self, limit: Optional[int] = None,
                 match: Optional[str] = None):
        self.limit = limit
        self.match = match
        self._start = None
        self._events: List[tuple] = []
        self._loaded_before: set = set()

    # -- results -------------------------------------------------------

    @property
    def names(self) -> List[str]:
        """``"build:<lib>"``/``"load:<lib>"`` per event, filtered by
        ``match``."""
        out = [f"{kind}:{lib}" for kind, lib in self._events]
        if self.match is None:
            return out
        pat = re.compile(self.match)
        return [n for n in out if pat.search(n)]

    @property
    def count(self) -> int:
        return len(self.names)

    @property
    def builds(self) -> int:
        return sum(kind == "build" for kind, _ in self._events)

    @property
    def loads(self) -> int:
        return sum(kind == "load" for kind, _ in self._events)

    def counts_by_name(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.names:
            out[n] = out.get(n, 0) + 1
        return out

    def builds_after_first_load(self) -> List[str]:
        """Libraries built again after this process first loaded them
        (before or inside the watch): the contract says none."""
        loaded = set(self._loaded_before)
        out = []
        for kind, lib in self._events:
            if kind == "load":
                if lib in loaded:
                    out.append(lib)     # a second load is a rebuild too
                loaded.add(lib)
            elif lib in loaded:
                out.append(lib)
        return out

    # -- context -------------------------------------------------------

    def __enter__(self) -> "CompileWatch":
        from heat2d_tpu_torch.ops import _build
        self._start = len(_build.EVENTS)
        self._loaded_before = {lib for kind, lib in _build.EVENTS
                               if kind == "load"}
        self._events = []
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        from heat2d_tpu_torch.ops import _build
        self._events = list(_build.EVENTS[self._start:])
        if exc_type is None and self.limit is not None \
                and self.count > self.limit:
            raise RecompileBudgetError(
                f"build budget exceeded: {self.count} builds and loads "
                f"(limit {self.limit})"
                + (f" matching {self.match!r}" if self.match else "")
                + f": {self.counts_by_name()}")


def assert_bounded(watch: CompileWatch, limit: int,
                   label: str = "workload") -> None:
    """Post-hoc budget check on a finished watch, and the zero-rebuild
    contract."""
    if watch.count > limit:
        raise RecompileBudgetError(
            f"{label}: {watch.count} builds and loads exceed the budget of "
            f"{limit}: {watch.counts_by_name()}")
    again = watch.builds_after_first_load()
    if again:
        raise RecompileBudgetError(
            f"{label}: built or loaded again after the first load: "
            f"{again}")


def log2_capacity_budget(max_batch: int) -> int:
    """The serve contract: power-of-two padding means at most
    ``floor(log2(max_batch)) + 1`` distinct launch capacities per
    signature."""
    return int(math.floor(math.log2(max(1, max_batch)))) + 1


def serve_compile_report(*, nx: int = 16, ny: int = 16, steps: int = 4,
                         method: str = "auto", max_batch: int = 8,
                         convergence: bool = False, device=None,
                         engine_factory: Optional[Callable[[], Any]]
                         = None) -> dict:
    """Drive one signature through the serve engine at EVERY occupancy
    1..max_batch under a ``CompileWatch`` and report the accounting:

    ``{"capacities": [...], "capacities_by_signature": {sig: [...]},
    "budget", "builds", "loads", "rebuilds", "launches", "ok"}``.

    ``ok`` holds when every signature launched at most ``budget``
    distinct capacities and nothing was built or loaded again after its
    first load. ``engine_factory`` builds the engine under report
    (default: ``serve.engine.EnsembleEngine(max_batch, device)``); its
    occupancies sweep 1..its own max_batch."""
    from heat2d_tpu_torch.serve.engine import EnsembleEngine
    from heat2d_tpu_torch.serve.schema import SolveRequest

    engine = (engine_factory() if engine_factory is not None
              else EnsembleEngine(max_batch=max_batch, device=device))
    max_occupancy = min(max_batch, engine.max_batch)
    with CompileWatch() as watch:
        for occupancy in range(1, max_occupancy + 1):
            reqs = [SolveRequest(nx=nx, ny=ny, steps=steps,
                                 cx=0.1 + 0.01 * i, cy=0.1, method=method,
                                 convergence=convergence)
                    for i in range(occupancy)]
            engine.solve_batch(reqs)
    by_sig: Dict[str, list] = {}
    for row in engine.launch_log:
        caps = by_sig.setdefault(str(row["signature"]), [])
        if row["capacity"] not in caps:
            caps.append(row["capacity"])
    budget = log2_capacity_budget(max_occupancy)
    rebuilds = watch.builds_after_first_load()
    return {
        "capacities": sorted({row["capacity"]
                              for row in engine.launch_log}),
        "capacities_by_signature": {k: sorted(v)
                                    for k, v in by_sig.items()},
        "budget": budget,
        "builds": watch.builds,
        "loads": watch.loads,
        "rebuilds": rebuilds,
        "events": watch.counts_by_name(),
        "launches": engine.launches,
        "routes": sorted({row["method"] for row in engine.launch_log}),
        "ok": (all(len(v) <= budget for v in by_sig.values())
               and not rebuilds),
    }
