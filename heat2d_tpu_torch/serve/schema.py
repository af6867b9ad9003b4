"""Solve-serving wire schema: requests, results, structured rejection. The
port's copy of ``heat2d_tpu/serve/schema.py``.

A ``SolveRequest`` is the full spec of one solve. Two derived keys drive
the serving stack, byte-identical to the JAX package's so that a request
hashes the same on both stacks:

- ``content_hash()``: sha256 over the canonical spec. Two requests with
  the same hash are the same computation: they share a cache entry and
  coalesce in flight.
- ``signature()``: the spec minus the per-member (cx, cy). Requests with
  the same signature run through the same ensemble runner, so the
  micro-batcher buckets by it and launches each bucket once.

Admission keeps the JAX package's rules: a problem family other than
heat5 is held to its capability matrix (``problems/base.py``), and a
combination it does not support (``reactdiff`` x ``adi``, ``varcoef`` x
``band``, ...) is answered with ``Rejected("unsupported_combination")``
carrying the family's reason, word for word the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from heat2d_tpu_torch.problems.base import spec_for
from heat2d_tpu_torch.vocab import DEFAULT_PROBLEM, PROBLEMS, SERVE_METHODS

#: dtypes the batched ensemble runners take.
SUPPORTED_DTYPES = ("float32",)

SUPPORTED_METHODS = SERVE_METHODS
SUPPORTED_PROBLEMS = PROBLEMS


class Rejected(Exception):
    """Structured admission/serving rejection (load shedding, queue
    timeout, shutdown, ...). ``code`` is machine-readable;
    ``to_record()`` is the JSONL shape the CLI emits."""

    def __init__(self, code: str, message: str, **fields):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.fields = fields

    def to_record(self) -> dict:
        return {"rejected": self.code, "message": self.message,
                **self.fields}


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One solve. Frozen: the hash and signature of an admitted request
    must not drift while it sits in the queue."""

    nx: int
    ny: int
    steps: int
    cx: float = 0.1
    cy: float = 0.1
    dtype: str = "float32"
    method: str = "auto"
    convergence: bool = False
    interval: int = 20
    sensitivity: float = 0.1
    problem: str = "heat5"
    #: the tracing context (``obs.tracing.TraceContext``) riding beside
    #: the spec: compare=False keeps it out of eq/hash, and spec(),
    #: content_hash() and signature() never read it, so requests that
    #: differ only in trace are the same computation. Not a wire field:
    #: from_dict rejects it.
    trace: "object" = dataclasses.field(
        default=None, compare=False, repr=False)

    def validate(self) -> "SolveRequest":
        if self.nx < 3 or self.ny < 3:
            raise Rejected("invalid", f"grid must be at least 3x3, got "
                           f"{self.nx}x{self.ny}")
        if self.steps < 0:
            raise Rejected("invalid", f"steps must be >= 0, got "
                           f"{self.steps}")
        if self.dtype not in SUPPORTED_DTYPES:
            raise Rejected("invalid", f"dtype {self.dtype!r} not in "
                           f"{SUPPORTED_DTYPES}")
        if self.method not in SUPPORTED_METHODS:
            raise Rejected("invalid", f"method {self.method!r} not in "
                           f"{SUPPORTED_METHODS}")
        if self.problem not in SUPPORTED_PROBLEMS:
            raise Rejected("invalid", f"problem {self.problem!r} not "
                           f"in {SUPPORTED_PROBLEMS}")
        if self.problem != DEFAULT_PROBLEM:
            spec = spec_for(self.problem)
            ok, reason = spec.supports_method(self.method)
            if not ok:
                raise Rejected("unsupported_combination", reason,
                               problem=self.problem, method=self.method)
            if min(self.nx, self.ny) < spec.min_grid:
                raise Rejected(
                    "invalid",
                    f"problem {self.problem!r} (halo width "
                    f"{spec.halo_width}) needs a grid of at least "
                    f"{spec.min_grid}x{spec.min_grid}, got "
                    f"{self.nx}x{self.ny}")
        if self.convergence and self.interval < 1:
            raise Rejected("invalid", f"interval must be >= 1, got "
                           f"{self.interval}")
        return self

    def schedule(self) -> tuple:
        """(interval, sensitivity) as computed: (0, 0.0) on fixed-step
        runs, where they are unused and must not split cache entries,
        buckets or runners."""
        if self.convergence:
            return int(self.interval), float(self.sensitivity)
        return 0, 0.0

    def spec(self) -> dict:
        """The canonical spec (every hashed field, fixed order); ``method``
        hashes unresolved, so 'auto' is its own key."""
        interval, sensitivity = self.schedule()
        d = {
            "nx": int(self.nx), "ny": int(self.ny),
            "steps": int(self.steps),
            "cx": float(self.cx), "cy": float(self.cy),
            "dtype": self.dtype, "method": self.method,
            "convergence": bool(self.convergence),
            "interval": interval,
            "sensitivity": sensitivity,
        }
        if self.problem != "heat5":
            d["problem"] = self.problem
        return d

    def content_hash(self) -> str:
        """sha256 over the canonical JSON spec (repr-exact floats)."""
        blob = json.dumps(self.spec(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def signature(self) -> tuple:
        """The bucket key: every spec field except (cx, cy); the problem
        family rides at index 8 for families other than heat5 only."""
        base = (self.nx, self.ny, self.steps, self.dtype, self.method,
                self.convergence) + self.schedule()
        if self.problem == "heat5":
            return base
        return base + (self.problem,)

    @classmethod
    def from_dict(cls, d: dict) -> "SolveRequest":
        known = {f.name for f in dataclasses.fields(cls)} - {"trace"}
        bad = set(d) - known
        if bad:
            raise Rejected("invalid",
                           f"unknown request fields: {sorted(bad)}")
        try:
            return cls(**d).validate()
        except TypeError as e:
            raise Rejected("invalid", str(e)) from None


def attach_trace(req, ctx) -> None:
    """Attach a tracing context to a (frozen) request in place. Any
    request of the serving protocol takes it (``SolveRequest``, diff's
    ``InverseRequest``): the context is metadata outside the hash, the
    signature and eq, so it never changes what the request means."""
    try:
        object.__setattr__(req, "trace", ctx)
    except (AttributeError, TypeError):
        pass    # a slotted request without the field: the trace is lost,
        #         the request still serves


def request_trace(req):
    """The attached tracing context, or None."""
    return getattr(req, "trace", None)


@dataclasses.dataclass
class SolveResult:
    """One served solve: ``u`` is the final (nx, ny) grid on the host
    (numpy), ``steps_done`` the member's iteration count. ``cache_hit`` /
    ``coalesced`` say how it was served; ``batch_size`` is the occupancy
    of the launch that computed it."""

    u: "object"
    steps_done: int
    content_hash: str
    cache_hit: bool = False
    coalesced: bool = False
    batch_size: int = 1

    def as_cache_hit(self) -> "SolveResult":
        """The stored result relabeled for a cache-hit answer (the grid
        is shared, not copied)."""
        return dataclasses.replace(self, cache_hit=True, coalesced=False)

    def summary(self) -> dict:
        """JSON-safe row for the CLI's results stream."""
        import numpy as np
        u = np.asarray(self.u)
        return {
            "content_hash": self.content_hash,
            "steps_done": int(self.steps_done),
            "cache_hit": bool(self.cache_hit),
            "coalesced": bool(self.coalesced),
            "batch_size": int(self.batch_size),
            "shape": list(u.shape),
            "max_temperature": float(u.max()),
            "total_heat": float(u.sum()),
        }
