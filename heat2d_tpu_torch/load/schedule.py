"""Arrival schedules — the one traffic shape both halves of the load
subsystem speak. The port's copy of ``heat2d_tpu/load/schedule.py``:
the same schema string, JSONL layout and fingerprint, so a schedule
written by either package loads in the other as the same workload.

A ``Schedule`` is an ordered list of ``Arrival``s: *when* a request
arrives (seconds from schedule start), *what* it is (a plain request
spec dict + the request kind that picks the schema class), and *who*
sent it (the tenant). Both producers emit exactly this shape —

- ``load/replay.py`` parses recorded span timelines (a fleet soak's
  ``spans-*.jsonl``) back into the arrival process production actually
  saw, and
- ``load/synth.py`` generates parameterized processes (zipf signature
  skew, MMPP bursts, diurnal modulation, tenant mixes, inverse-solve
  heavy tails) from a seed —

so the open-loop runner (``load/runner.py``) has ONE replay path and
the fidelity/measurement machinery never cares where traffic came
from. Everything here is host-side plain data (no torch): schedules are
hashable-by-fingerprint, JSONL-serializable (atomic commit, the R001
discipline), and cheap to build at admission-path scale.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional

SCHEDULE_SCHEMA = "heat2d-tpu/load-schedule/v1"

#: request kinds a schedule can carry (matches the serving protocol's
#: dispatch routing: plain solves and diff/'s inverse optimizations)
ARRIVAL_KINDS = ("solve", "inverse")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request arrival. ``t`` is seconds from schedule start;
    ``spec`` is the request's canonical spec dict (what
    ``SolveRequest.from_dict`` / ``InverseRequest.from_dict`` eat);
    ``kind`` routes to the right schema class; ``tenant`` rides to
    fleet targets (serve targets ignore it)."""

    t: float
    kind: str
    spec: dict
    tenant: str = "default"

    def build_request(self):
        """Materialize the serving-protocol request object (imports
        the schema lazily so schedule manipulation stays torch-free)."""
        if self.kind == "inverse":
            from heat2d_tpu_torch.diff.serving import InverseRequest
            return InverseRequest.from_dict(dict(self.spec))
        from heat2d_tpu_torch.serve.schema import SolveRequest
        return SolveRequest.from_dict(dict(self.spec))


class Schedule:
    """An arrival process: ``Arrival``s sorted by ``t``. ``meta``
    records provenance (profile name + seed, or the replayed trace
    dir) — labeling that rides into run records and baselines. The
    ``fingerprint`` covers arrivals only: two schedules are the same
    workload iff their arrivals match, whatever produced them."""

    def __init__(self, arrivals: List[Arrival],
                 meta: Optional[dict] = None):
        self.arrivals = sorted(arrivals, key=lambda a: a.t)
        self.meta = dict(meta or {})

    # -- shape ---------------------------------------------------------- #

    def __len__(self) -> int:
        return len(self.arrivals)

    def __iter__(self):
        return iter(self.arrivals)

    def duration(self) -> float:
        """Span from the first to the last arrival (0.0 when < 2)."""
        if len(self.arrivals) < 2:
            return 0.0
        return self.arrivals[-1].t - self.arrivals[0].t

    def offered_rps(self) -> float:
        """The schedule's own offered rate (arrivals per second over
        its span) — the x axis of a latency/throughput surface."""
        d = self.duration()
        return len(self.arrivals) / d if d > 0 else 0.0

    def inter_arrivals(self) -> List[float]:
        ts = [a.t for a in self.arrivals]
        return [b - a for a, b in zip(ts, ts[1:])]

    def signatures(self) -> dict:
        """{signature tuple: count} over the schedule — what the
        runner warms before the measured window."""
        out: dict = {}
        for a in self.arrivals:
            sig = a.build_request().signature()
            out[sig] = out.get(sig, 0) + 1
        return out

    def scaled(self, speedup: float) -> "Schedule":
        """The same arrival process compressed ``speedup``x (2.0 ==
        twice as fast — every inter-arrival gap halves, so offered
        load doubles while the traffic SHAPE — skew, burst phase —
        is preserved)."""
        if speedup <= 0:
            raise ValueError(f"speedup must be > 0, got {speedup}")
        return Schedule(
            [dataclasses.replace(a, t=a.t / speedup)
             for a in self.arrivals],
            meta=dict(self.meta, speedup=float(speedup)))

    # -- identity -------------------------------------------------------- #

    def fingerprint(self) -> str:
        """sha256 over the canonical arrival list — two schedules with
        equal fingerprints are the same workload bit for bit (the
        seeded-generator determinism contract tests pin)."""
        blob = json.dumps(
            [[round(a.t, 9), a.kind, a.tenant, a.spec]
             for a in self.arrivals],
            sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    # -- persistence ----------------------------------------------------- #

    def to_jsonl(self, path: str) -> None:
        """One header line + one line per arrival, committed
        atomically (tmp + fsync + os.replace — lint rule R001)."""
        from heat2d_tpu_torch.io.binary import write_text_atomic
        lines = [json.dumps({"schema": SCHEDULE_SCHEMA,
                             "meta": self.meta,
                             "arrivals": len(self.arrivals)})]
        lines.extend(
            json.dumps({"t": a.t, "kind": a.kind, "tenant": a.tenant,
                        "spec": a.spec})
            for a in self.arrivals)
        write_text_atomic("\n".join(lines) + "\n", path)

    @classmethod
    def from_jsonl(cls, path: str) -> "Schedule":
        arrivals, meta = [], {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("schema") == SCHEDULE_SCHEMA:
                    meta = rec.get("meta", {})
                    continue
                arrivals.append(Arrival(
                    t=float(rec["t"]), kind=rec.get("kind", "solve"),
                    spec=dict(rec["spec"]),
                    tenant=rec.get("tenant", "default")))
        return cls(arrivals, meta=meta)

    def summary(self) -> dict:
        """JSON-safe shape row for run records / baselines."""
        kinds: dict = {}
        tenants: dict = {}
        for a in self.arrivals:
            kinds[a.kind] = kinds.get(a.kind, 0) + 1
            tenants[a.tenant] = tenants.get(a.tenant, 0) + 1
        return {
            "arrivals": len(self.arrivals),
            "duration_s": round(self.duration(), 6),
            "offered_rps": round(self.offered_rps(), 4),
            "kinds": kinds,
            "tenants": tenants,
            "fingerprint": self.fingerprint()[:16],
            "meta": self.meta,
        }
