"""How tuned configs reach the kernels: the port of
``heat2d_tpu/tune/runtime.py``.

Opt-in, two ways:

- ``HEAT2D_TUNE_DB=/path/to/db.json`` in the environment, or
- ``set_tuning_db(path_or_db)`` in-process (tests, embedding apps).

With neither, every consult returns None at once and touches nothing, so
plans, launches and results are those of a build without this package.
With a db, each consult answers a planner's question through the db's
lookup ladder for this device's kind (``device_kind``: the card's name,
or "cpu", so that a card's db never steers a CPU run and a test's db
never steers the card), re-validated against the live planners before
it may steer anything: an answer the planner cannot take degrades to
None, and the planner's own plan runs. Every applied config is recorded
so that run records can carry ``tuned_config``.

The consults, one per planner question:

- ``band_config``: H2/H3's (and H6/H7's) tile height and sweep depth;
- ``resident_config``: H4's (and H5's) chunk depth K, where the JAX
  package's resident route has no knob;
- ``fused_config``: H14's overlap depth, exact key only;
- ``adjoint_config``: the differentiable band primal's tile (H6);
- ``measured_rate``: the mesh scheduler's per-slot rate.

The JAX package's ``_apply_device_stamps`` (a probed VMEM budget stamped
on the device section) has no counterpart: the card's planners read its
limits from the card.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
from typing import Optional

import torch

from heat2d_tpu_torch.tune.db import TunedConfig, TuningDB
from heat2d_tpu_torch.utils.device import resolve_device

log = logging.getLogger("heat2d_tpu_torch.tune")

ENV_VAR = "HEAT2D_TUNE_DB"

_lock = threading.Lock()
_explicit: Optional[TuningDB] = None
_explicit_set = False
#: (env value, loaded db): re-resolved whenever the env var changes, so
#: tests and long-lived processes can switch it without a reload.
_env_cache: tuple = (None, None)
_applied: dict = {}


def set_tuning_db(db) -> None:
    """Install a db explicitly (a ``TuningDB``, a path, or ``None`` to go
    back to the env var). Resets the applied-config provenance."""
    global _explicit, _explicit_set, _env_cache
    with _lock:
        if db is None:
            _explicit, _explicit_set = None, False
        else:
            _explicit = db if isinstance(db, TuningDB) else TuningDB(db)
            _explicit_set = True
        _env_cache = (None, None)
        _applied.clear()


def active_db() -> Optional[TuningDB]:
    """The db in force, or None (the default: no cost, no change)."""
    global _env_cache
    if _explicit_set:
        return _explicit
    env = os.environ.get(ENV_VAR)
    if not env:
        return None
    with _lock:
        cached_env, cached_db = _env_cache
        if cached_env != env:
            db = TuningDB(env)
            if db.corrupt and not db.data["devices"]:
                log.warning("%s=%s is unreadable; tuning disabled for "
                            "this process", ENV_VAR, env)
            _env_cache = (env, db)
            return db
        return cached_db


def describe_active() -> Optional[dict]:
    """The active db's rollout identity (path, epoch, validated, entry
    count), or None without a db."""
    db = active_db()
    if db is None:
        return None
    entries = sum(len(d.get("entries", {}))
                  for d in db.data["devices"].values())
    return {"path": db.path, "epoch": db.epoch,
            "validated": db.validated, "entries": entries}


@functools.lru_cache(maxsize=16)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_kind(device=None) -> str:
    """The db's device key for ``device``: the card's name on CUDA (e.g.
    "NVIDIA H100 80GB HBM3"), "cpu" on the CPU. ``device`` defaults to
    the card, and raises ``DeviceUnavailableError`` without one."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return _card_name(dev.index if dev.index is not None
                      else torch.cuda.current_device())


def band_config(nrows: int, ny: int, dtype="float32",
                tsteps_hint: Optional[int] = None,
                allow_window: bool = True, *,
                device=None) -> Optional[TunedConfig]:
    """The tile route's tuned (ty, T) for an nrows x ny grid on
    ``device``, as a ``TunedConfig`` of route "tile" (``bm`` = ty,
    ``tsteps`` = T), or None: no db, no entry, a best of another route
    (the resident route's K is ``resident_config``'s), or an answer the
    live planner does not take as given (``tile_plan`` cannot fit T, or
    shrinks the tile). ``tsteps_hint``: the depth an entry without one
    runs at (default ``DEFAULT_TSTEPS``). ``allow_window`` is the JAX
    package's switch between its window (C2) and legacy (C) band
    kernels; H2 and H6/H7 replace both, so the answer is the same either
    way. H2, H3, H6 and H7 all take T and ty at run time."""
    db = active_db()
    if db is None:
        return None
    from heat2d_tpu_torch.ops.cuda_stencil import DEFAULT_TSTEPS
    from heat2d_tpu_torch.tune.space import tile_fits

    cfg = db.lookup(device_kind(device), nrows, ny, str(dtype))
    if cfg is None or cfg.route != "tile":
        return None
    t = cfg.tsteps or tsteps_hint or DEFAULT_TSTEPS
    if cfg.bm < 1 or tile_fits(nrows, ny, cfg.bm, t,
                               resolve_device(device)):
        return None
    out = TunedConfig(route="tile", bm=cfg.bm, tsteps=t, source=cfg.source,
                      matched_key=cfg.matched_key,
                      mcells_per_s=cfg.mcells_per_s)
    _record_applied("band", nrows, ny, str(dtype), out)
    return out


def resident_config(nx: int, ny: int, dtype="float32", *,
                    device=None) -> Optional[TunedConfig]:
    """H4's tuned chunk depth K for an nx x ny grid on ``device``, as a
    ``TunedConfig`` of route "resident" (``tsteps`` = K), or None: no db,
    no entry, a best of another route, or a K for which
    ``resident.plan_for_limits`` has no plan on this device. One member's
    plan decides: a batch of them (H5) takes the same tiles in waves."""
    db = active_db()
    if db is None:
        return None
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops.resident import MAX_CHUNK

    cfg = db.lookup(device_kind(device), nx, ny, str(dtype))
    if cfg is None or cfg.route != "resident":
        return None
    if not 1 <= cfg.tsteps <= MAX_CHUNK or cs.resident_plan(
            nx, ny, resolve_device(device), cfg.tsteps) is None:
        return None
    out = TunedConfig(route="resident", bm=0, tsteps=cfg.tsteps,
                      source=cfg.source, matched_key=cfg.matched_key,
                      mcells_per_s=cfg.mcells_per_s)
    _record_applied("band", nx, ny, str(dtype), out)
    return out


def fused_config(bm: int, bn: int, dtype="float32", *,
                 device=None) -> Optional[TunedConfig]:
    """H14's tuned overlap depth for shards of bm x bn, from the
    ``fused:BMxBN:dtype`` entry (exact key only: a neighbouring shard
    shape's optimum is not trusted), or None. Consulted only by the
    fused route's depth (``parallel.sharded.effective_halo_depth``). The
    depth must pass the overlap geometry (bm >= 2T, bn >= 2T) and
    ``cs.tile_plan`` must fit a tile at it; otherwise the default depth
    runs."""
    db = active_db()
    if db is None:
        return None
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.parallel.halo import fused_halo_viable

    key = f"fused:{bm}x{bn}:{dtype}"
    e = db.entry(device_kind(device), key)
    b = (e or {}).get("best") or {}
    if b.get("route") != "fused":
        return None
    t = int(b.get("tsteps", 0))
    if not fused_halo_viable(bm, bn, t):
        return None
    try:
        cs.tile_plan(bm, bn, t, resolve_device(device))
    except ValueError:
        return None
    out = TunedConfig(route="fused", bm=int(b.get("bm", 0)), tsteps=t,
                      source="exact", matched_key=key,
                      mcells_per_s=e.get("mcells_per_s"))
    _record_applied("fused", bm, bn, str(dtype), out)
    return out


def adjoint_config(nrows: int, ny: int, dtype="float32", *,
                   device=None) -> Optional[TunedConfig]:
    """The db's answer for a differentiable solve's fused band primal
    (``diff/adjoint.py``: H6 on a one-member batch), the same lookup as
    ``band_config``; the adjoint's band route takes it at each segment,
    and its inverse records carry ``tuned_config`` like every other
    record kind. None without a db or when the live planner refuses
    it."""
    return band_config(nrows, ny, dtype, allow_window=False, device=device)


def measured_rate(nx: int, ny: int, dtype: str = "float32", *,
                  device=None) -> Optional[float]:
    """The db's measured Mcells/s for this shape on this device's kind
    (exact or nearest entry, the same ladder as every config consult), or
    None without a db or a stored rate. A rate, not a config: the mesh
    scheduler prices work with it and no plan changes, so it needs no
    re-validation."""
    db = active_db()
    if db is None:
        return None
    cfg = db.lookup(device_kind(device), nx, ny, dtype)
    if cfg is None or not cfg.mcells_per_s:
        return None
    return float(cfg.mcells_per_s)


def _record_applied(space: str, nrows: int, ny: int, dtype: str,
                    cfg: TunedConfig) -> None:
    key = (space, nrows, ny, dtype)
    with _lock:
        if key not in _applied:
            _applied[key] = {"shape": f"{nrows}x{ny}", "dtype": dtype,
                             **cfg.to_dict()}
            log.info("tuned config applied for %dx%d: route=%s bm=%d "
                     "T=%d (%s via %s)", nrows, ny, cfg.route, cfg.bm,
                     cfg.tsteps, cfg.source, cfg.matched_key)


def applied_configs() -> list:
    """Every tuned config this process applied so far (one per shape and
    key space: the plain and ``fused:`` keys): the run records'
    ``tuned_config``."""
    with _lock:
        return [dict(v) for v in _applied.values()]


def reset_applied() -> None:
    with _lock:
        _applied.clear()
