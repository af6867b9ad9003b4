"""Persistent per-device tuning database: the port of
``heat2d_tpu/tune/db.py``, in the same document format
(``heat2d-tpu/tune-db/v1``), so one file serves both stacks.

A small JSON document, keyed three levels deep:

.. code-block:: text

    devices -> <device_kind> -> entries -> <problem key "NXxNY:dtype">

The device kind is the card's name (``torch.cuda.get_device_name``, e.g.
"NVIDIA H100 80GB HBM3") or "cpu" (``tune.runtime.device_kind``). Each
entry carries the best measured config, its measured rate, a provenance
block (protocol, spans, the card, torch and CUDA versions, timestamp),
the code-version **salt** it was measured under, and every measured
point, so a resumed search skips completed work and a frontier table
can be reprinted without measuring anything.

Rules the lookup and write paths enforce:

- **Atomic writes**: the document is staged to ``path + ".tmp"``,
  fsync'd and promoted with ``os.replace``; a crash mid-save leaves the
  previous db intact. Only ``save`` writes; readers in several processes
  need no lock.
- **Corrupt or torn files are ignored with a warning**, never a crash: a
  damaged db degrades to "no db", behaving as an absent file does.
- **Code-version salt** (``current_salt``): entries whose salt no longer
  matches are invisible to lookup and resume.
- **Three-tier lookup**: exact problem-key hit -> nearest-shape match
  (flagged ``source="nearest"`` with the matched key; callers
  re-validate it against the live planners) -> ``None`` (callers keep
  the planner's plan).
- **Rollout provenance**: a db staged as a rollout candidate carries a
  document-level ``epoch``/``validated`` stamp (``stamp_rollout``) and
  per-entry twins (``mark_entries``); a db without the stamp is the
  validated incumbent.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import logging
import math
import os
from pathlib import Path
from typing import Optional

log = logging.getLogger("heat2d_tpu_torch.tune")

DB_SCHEMA = "heat2d-tpu/tune-db/v1"

#: Nearest-shape matches further than this log-distance are not
#: trusted: a 4x shape gap changes which envelope regime applies.
_NEAREST_MAX_DIST = math.log(4.0)

_salt_cache: Optional[str] = None


def current_salt() -> str:
    """Code-version salt: a short hash of what decides a config's meaning
    on the card, the kernel sources (``csrc/*.cu``, ``*.cuh``) with
    ``ops/_build.NVCC_FLAGS``, and the two planner modules
    (``ops/cuda_stencil.py``, ``ops/resident.py``). Entries measured
    under another revision of any of them are invisible to lookup and
    resume: the tuned numbers describe code that no longer exists."""
    global _salt_cache
    if _salt_cache is None:
        from heat2d_tpu_torch.ops import _build, cuda_stencil, resident
        h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
        sources = sorted([*_build.CSRC.glob("*.cu"),
                          *_build.CSRC.glob("*.cuh")])
        for src in [*sources, Path(cuda_stencil.__file__),
                    Path(resident.__file__)]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        _salt_cache = h.hexdigest()[:12]
    return _salt_cache


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """A db answer: the config to use plus where it came from.
    ``source`` is ``"exact"`` or ``"nearest"`` (``matched_key`` then
    names the entry actually matched). On the card the knobs mean, by
    route (``tune/space.py``): "tile", ``bm`` the tile's centre rows and
    ``tsteps`` the sweep depth T of H2/H3 (H6/H7); "resident", ``bm`` 0
    and ``tsteps`` H4's chunk depth K; "fused", ``tsteps`` H14's overlap
    depth T."""
    route: str
    bm: int
    tsteps: int
    source: str
    matched_key: str
    mcells_per_s: Optional[float] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _point_key(p: dict) -> tuple:
    return (p.get("route"), int(p.get("bm", 0)), int(p.get("tsteps", 0)))


class TuningDB:
    """The persistent store. All mutation goes through ``record_point``
    / ``set_best`` / ``stamp_device`` + an explicit ``save()`` —
    callers control write frequency (the search saves after every
    point, so a killed search resumes)."""

    def __init__(self, path: str):
        self.path = str(path)
        self.data: dict = {"schema": DB_SCHEMA, "devices": {}}
        self.corrupt = False
        self._load()

    # -- persistence --------------------------------------------------- #

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict) or "devices" not in data:
                raise ValueError("not a tuning db document")
            if data.get("schema") != DB_SCHEMA:
                raise ValueError(
                    f"schema {data.get('schema')!r} != {DB_SCHEMA!r}")
            self.data = data
        except (OSError, ValueError, json.JSONDecodeError) as e:
            # A torn/corrupt db must degrade to "no db", not crash the
            # run it was meant to speed up.
            log.warning("ignoring corrupt tuning db %s (%s) — "
                        "behaving as if no db exists", self.path, e)
            self.corrupt = True

    def save(self) -> None:
        """Atomic commit: temp + fsync + os.replace (the resil
        checkpoint idiom) — a crash mid-save never tears the db.
        An unreadable original (corrupt db, or a path that was never a
        tuning db) is moved aside first, not silently destroyed."""
        if self.corrupt and os.path.exists(self.path):
            aside = self.path + ".corrupt"
            os.replace(self.path, aside)
            log.warning("moved unreadable tuning db aside to %s before "
                        "writing a fresh one", aside)
            self.corrupt = False
        tmp = self.path + ".tmp"
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- structure accessors ------------------------------------------- #

    def device(self, device_kind: str) -> dict:
        return self.data["devices"].setdefault(
            device_kind, {"entries": {}})

    def device_kinds(self) -> list:
        return sorted(self.data["devices"])

    def entry(self, device_kind: str, problem_key: str,
              salted: bool = True) -> Optional[dict]:
        """The entry for an exact problem key, or None. ``salted``
        filters to the current code version (lookup semantics); pass
        False to read stale entries (export/inspection)."""
        e = (self.data["devices"].get(device_kind, {})
             .get("entries", {}).get(problem_key))
        if e is None:
            return None
        if salted and e.get("salt") != current_salt():
            return None
        return e

    def stamp_device(self, device_kind: str, **fields) -> None:
        """Attach device-level facts to a device kind's section. The port
        applies none at load time (the JAX package's probed VMEM stamp
        has no counterpart on the card); they travel through ``merge``
        so that one document serves both stacks."""
        self.device(device_kind).update(fields)

    # -- rollout provenance  --------------------------- #

    @property
    def epoch(self) -> int:
        """The document-level rollout epoch (0 for a db that predates
        rollouts)."""
        return int(self.data.get("epoch", 0) or 0)

    @property
    def validated(self) -> bool:
        """Whether this db is a VALIDATED rollout artifact. Defaults
        True: every db that predates the control plane is the incumbent
        — only a staged candidate is explicitly unvalidated."""
        return bool(self.data.get("validated", True))

    def stamp_rollout(self, *, epoch: int, validated: bool) -> None:
        """Stamp the document-level rollout identity — the stamp a
        fleet worker reports on its ready line (``runtime.
        describe_active``), and the fact the chaos gate asserts on:
        a candidate is ``validated=False`` until its canary survived
        parity + observation; promotion restamps True."""
        self.data["epoch"] = int(epoch)
        self.data["validated"] = bool(validated)

    def mark_entries(self, *, validated: bool, epoch: int) -> int:
        """Stamp every entry's validation provenance (the per-entry
        twin of ``stamp_rollout`` — it travels through ``merge``, where
        a validated entry beats an unvalidated one at equal salt).
        Returns the number of entries stamped."""
        n = 0
        for dev in self.data["devices"].values():
            for e in dev.get("entries", {}).values():
                e["validated"] = bool(validated)
                e["epoch"] = int(epoch)
                n += 1
        return n

    # -- search bookkeeping -------------------------------------------- #

    def _entry_for_write(self, device_kind: str, problem_key: str) -> dict:
        entries = self.device(device_kind)["entries"]
        e = entries.get(problem_key)
        if e is None or e.get("salt") != current_salt():
            # A salt change retires the old points wholesale: resuming
            # onto measurements of dead code would be worse than
            # starting over.
            e = entries[problem_key] = {"salt": current_salt(),
                                        "points": []}
        return e

    def record_point(self, device_kind: str, problem_key: str,
                     point: dict) -> None:
        """Insert-or-replace one measured point (keyed by
        (route, bm, tsteps))."""
        e = self._entry_for_write(device_kind, problem_key)
        k = _point_key(point)
        e["points"] = [p for p in e["points"] if _point_key(p) != k]
        e["points"].append(point)

    def measured_keys(self, device_kind: str, problem_key: str,
                      terminal_statuses) -> set:
        """(route, bm, tsteps) triples a resumed search may skip."""
        e = self.entry(device_kind, problem_key)
        if e is None:
            return set()
        return {_point_key(p) for p in e.get("points", [])
                if p.get("status") in terminal_statuses}

    def set_best(self, device_kind: str, problem_key: str, best: dict,
                 mcells_per_s: float, provenance: dict) -> None:
        e = self._entry_for_write(device_kind, problem_key)
        e["best"] = best
        e["mcells_per_s"] = mcells_per_s
        e["provenance"] = provenance

    # -- fleet-wide consolidation -------------------------------------- #

    def merge(self, other) -> dict:
        """Merge another db (``TuningDB`` or raw document dict) into
        this one — the fleet-wide consolidation primitive: N workers
        each tune against their own db; merging keeps the best entry
        per (device kind, problem key, salt).

        - **Same salt**: points union (per ``(route, bm, tsteps)`` the
          better datum wins — an ``ok`` beats any failure, a faster
          ``ok`` beats a slower one) and the best/provenance restamp
          from the merged frontier. A side that is explicitly a
          rollout CANDIDATE (``validated=False``) never wins the
          best/provenance slots against a validated side — and an
          unstamped entry counts as the validated incumbent —
          chaos/parity-proven beats fast-but-unproven
          .
        - **Different salts**: one storage slot per problem key, so the
          CURRENT code version wins; between two stale salts the newer
          provenance timestamp wins (both describe dead code — keep the
          fresher corpse for inspection).
        - Device-level stamps fill in where this db has none; an
          existing stamp is never overwritten.

        Returns a summary dict (devices / entries added, merged, kept /
        points added) the CLI prints."""
        doc = other.data if isinstance(other, TuningDB) else other
        if not isinstance(doc, dict) or "devices" not in doc:
            raise ValueError("merge source is not a tuning db document")
        s = {"devices": 0, "entries_added": 0, "entries_merged": 0,
             "entries_kept": 0, "points_added": 0}
        for kind, dev in doc.get("devices", {}).items():
            s["devices"] += 1
            mine = self.device(kind)
            for k, v in dev.items():
                if k != "entries":
                    mine.setdefault(k, copy.deepcopy(v))
            for key, theirs in dev.get("entries", {}).items():
                ours = mine["entries"].get(key)
                if ours is None:
                    mine["entries"][key] = copy.deepcopy(theirs)
                    s["entries_added"] += 1
                elif ours.get("salt") == theirs.get("salt"):
                    s["points_added"] += _merge_entry(ours, theirs)
                    s["entries_merged"] += 1
                elif theirs.get("salt") == current_salt() or (
                        ours.get("salt") != current_salt()
                        and _entry_ts(theirs) > _entry_ts(ours)):
                    mine["entries"][key] = copy.deepcopy(theirs)
                    s["entries_added"] += 1
                else:
                    s["entries_kept"] += 1
        return s

    # -- the lookup ladder --------------------------------------------- #

    def lookup(self, device_kind: str, nx: int, ny: int,
               dtype: str = "float32") -> Optional[TunedConfig]:
        """Tier 1: exact (shape, dtype) hit. Tier 2: nearest measured
        shape of the same dtype within a 4x log-distance, flagged
        ``source="nearest"`` (row width dominates the distance — the
        compile envelope is a function of ny, so a same-ny neighbor
        beats a same-nx one). Tier 3 is the caller's: ``None`` means
        'use the static heuristic'."""
        entries = (self.data["devices"].get(device_kind, {})
                   .get("entries", {}))
        key = f"{nx}x{ny}:{dtype}"
        e = self.entry(device_kind, key)
        if e is not None and e.get("best"):
            return self._config(e, "exact", key)

        best_k, best_d = None, None
        for k, cand in entries.items():
            if cand.get("salt") != current_salt() or not cand.get("best"):
                continue
            try:
                shape, dt = k.split(":")
                cnx, cny = (int(v) for v in shape.split("x"))
            except ValueError:
                continue
            if dt != dtype:
                continue
            d = (2.0 * abs(math.log(cny / ny))
                 + abs(math.log(cnx / nx)))
            if d <= _NEAREST_MAX_DIST and (best_d is None or d < best_d):
                best_k, best_d = k, d
        if best_k is not None:
            return self._config(entries[best_k], "nearest", best_k)
        return None

    @staticmethod
    def _config(entry: dict, source: str, key: str) -> TunedConfig:
        b = entry["best"]
        return TunedConfig(route=b.get("route", "C"),
                           bm=int(b.get("bm", 0)),
                           tsteps=int(b.get("tsteps", 0)),
                           source=source, matched_key=key,
                           mcells_per_s=entry.get("mcells_per_s"))


def _entry_ts(e: dict) -> str:
    """ISO timestamps sort lexically; entries without provenance sort
    oldest."""
    return (e.get("provenance") or {}).get("timestamp") or ""


def _better_point(p: dict, q: dict) -> bool:
    """True when measured point ``p`` is the better datum than ``q`` for
    the same (route, bm, tsteps): ``ok`` beats any failure class, and
    among oks the higher min-of-reps rate is the truer capability."""
    p_ok, q_ok = p.get("status") == "ok", q.get("status") == "ok"
    if p_ok != q_ok:
        return p_ok
    if not p_ok:
        return False                     # two failures: keep the first
    return (p.get("mcells_per_s") or 0) > (q.get("mcells_per_s") or 0)


def _merge_entry(ours: dict, theirs: dict) -> int:
    """Union ``theirs``'s points into ``ours`` (same salt) and restamp
    the best from the merged frontier — except that a VALIDATED entry's
    best/provenance beat an unvalidated one's outright (a rollout
    proved that config bitwise-compatible and SLO-clean in production;
    a faster unvalidated point is a claim, not a proof). Returns
    points added."""
    added = 0
    pts = ours.setdefault("points", [])
    have = {_point_key(p): i for i, p in enumerate(pts)}
    for p in theirs.get("points", []):
        k = _point_key(p)
        if k not in have:
            have[k] = len(pts)
            pts.append(copy.deepcopy(p))
            added += 1
        elif _better_point(p, pts[have[k]]):
            pts[have[k]] = copy.deepcopy(p)
    # An UNSTAMPED entry defaults to validated — it is the pre-rollout
    # incumbent (same back-compat rule as TuningDB.validated). Only an
    # explicitly staged candidate (validated=False) loses the
    # preference, so a merge can never let a candidate's faster claim
    # displace an incumbent that predates rollout stamps.
    ours_val = bool(ours.get("validated", True))
    theirs_val = bool(theirs.get("validated", True))
    if ours_val != theirs_val and (ours if ours_val
                                   else theirs).get("best"):
        if theirs_val:
            for k in ("best", "mcells_per_s", "provenance"):
                if k in theirs:
                    ours[k] = copy.deepcopy(theirs[k])
            # the winner's VALIDATION identity must travel too: an
            # unstamped winner leaves the merged entry unstamped
            # (implicitly validated) — keeping the loser's
            # validated=False stamp would let a later candidate merge
            # displace the proven best it just adopted
            for k in ("validated", "epoch"):
                if k in theirs:
                    ours[k] = theirs[k]
                else:
                    ours.pop(k, None)
        # ours validated: keep our best/provenance/stamps as they are
        return added
    ok = [p for p in pts if p.get("status") == "ok"]
    if ok:
        b = max(ok, key=lambda p: p.get("mcells_per_s") or 0)
        best_key = _point_key(b)
        ours["best"] = {"route": b["route"], "bm": b["bm"],
                        "tsteps": b["tsteps"]}
        ours["mcells_per_s"] = b.get("mcells_per_s")
        # the winning measurement's provenance (and rollout stamps)
        # travel with it
        if (_point_key(theirs.get("best") or {}) == best_key
                and theirs.get("provenance")):
            ours["provenance"] = copy.deepcopy(theirs["provenance"])
            for k in ("validated", "epoch"):
                if k in theirs:
                    ours[k] = theirs[k]
    return added
