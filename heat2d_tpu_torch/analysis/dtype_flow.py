"""Dtype-flow and collective censuses: the port's counterpart of
``heat2d_tpu/analysis/dtype_flow.py``.

**Casts.** ``census_casts`` walks an aten graph (``footprint.trace``) and
lists every ``_to_copy`` / ``to`` node that changes a dtype, with its
provenance: the chain of Python functions from the traced root inward
(``path``) and the ``module:line`` that made it (``site``), both stamped
at trace time. ``PrecisionCard.findings(allowlist)`` returns the
precision-relevant casts (a floating dtype on either side) not on the
program's declared allowlist (``FamilySpec.cast_allowlist``); integer and
bool index casts are on the card but never findings. An allowlist entry
that matches nothing is not an error.

**Collectives.** The port's exchange is host code that no graph sees:
``parallel/halo.exchange_halo_strips`` moves strips between shard
tensors (a copy within a process, gloo sends and receives between
ranks), and the residual is summed by ``parallel/sharded._total``.
``record_collectives`` runs a program under a recording shim around
those two and around ``torch.distributed``'s collectives, and returns a
``CollectiveCensus``: calls of the exchange, each strip shift of its
phases with the (source shard, destination shard) pairs it moved, the
residual sums, and the distributed calls, each with the path of shimmed
calls it was made inside. H14's wrapper (``ops/cuda_shard.shard_fused``)
is shimmed as a scope too: on the card it reads its neighbours' blocks
by pointer, and its plain version's exchange on the CPU is the kernel's
own read, which the census files under that scope.

Host-side only; the shim restores every patched name on exit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
from typing import Dict, Iterable, List, Tuple

import torch

from heat2d_tpu_torch.analysis.footprint import op_name

#: aten ops the census records as casts
CAST_OPS = ("_to_copy", "to")


@dataclasses.dataclass(frozen=True)
class CastSite:
    """One (src -> dst, provenance) cast class in a traced program;
    ``count`` aggregates identical sites (a cast in a loop traces once
    per iteration)."""

    src: str
    dst: str
    #: the functions from the traced root inward, outermost first; ()
    #: for a cast in the traced function itself
    path: Tuple[str, ...]
    #: ``module:line`` of the innermost frame
    site: str = "?"
    count: int = 1

    @property
    def precision_relevant(self) -> bool:
        """Involves a floating dtype and changes the dtype."""
        if self.src == self.dst:
            return False
        return _floating(self.src) or _floating(self.dst)

    @property
    def narrowing(self) -> bool:
        """Loses width (the dangerous direction)."""
        return _itemsize(self.src) > _itemsize(self.dst)

    def describe(self) -> str:
        where = "/".join(self.path) if self.path else "<top>"
        arrow = "⤓" if self.narrowing else "→"
        n = f" ×{self.count}" if self.count > 1 else ""
        return f"{self.src} {arrow} {self.dst} at {where} ({self.site}){n}"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _floating(name: str) -> bool:
    d = _dtype(name)
    return d.is_floating_point or d.is_complex


def _itemsize(name: str) -> int:
    return _dtype(name).itemsize


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cast_dtypes(node):
    """(src, dst) dtype names of a cast node, or None when it changes no
    dtype (a device move, a layout copy)."""
    src_val = node.args[0].meta.get("val") if node.args else None
    out_val = node.meta.get("val")
    if not isinstance(src_val, torch.Tensor) or not isinstance(
            out_val, torch.Tensor):
        return None
    src, dst = _name(src_val.dtype), _name(out_val.dtype)
    return None if src == dst else (src, dst)


def census_casts(gm) -> List[CastSite]:
    """Every dtype-changing cast node of ``gm``, aggregated by (src, dst,
    path, site)."""
    agg: Dict[tuple, int] = {}
    for node in gm.graph.nodes:
        if node.op != "call_function" or op_name(node) not in CAST_OPS:
            continue
        pair = _cast_dtypes(node)
        if pair is None:
            continue
        path, site = node.meta.get("provenance", ((), "?"))
        key = pair + (tuple(path), site)
        agg[key] = agg.get(key, 0) + 1
    return [CastSite(src=s, dst=d, path=p, site=w, count=c)
            for (s, d, p, w), c in sorted(agg.items())]


@dataclasses.dataclass
class PrecisionCard:
    """Per-program cast report: every cast on the card, findings only for
    precision-relevant casts outside the declared allowlist."""

    program: str
    casts: List[CastSite]

    def findings(self, allowlist: Iterable[Tuple[str, str]] = ()
                 ) -> List[CastSite]:
        allowed = {tuple(a) for a in allowlist}
        return [c for c in self.casts
                if c.precision_relevant and (c.src, c.dst) not in allowed]

    def lines(self) -> List[str]:
        if not self.casts:
            return [f"{self.program}: no casts"]
        out = [f"{self.program}: {len(self.casts)} cast site(s)"]
        out.extend(f"  {c.describe()}" for c in self.casts)
        return out


def precision_card(program: str, fn, *args) -> PrecisionCard:
    """Trace ``fn(*args)`` and build its precision card."""
    from heat2d_tpu_torch.analysis.footprint import trace
    return PrecisionCard(program=program, casts=census_casts(trace(fn,
                                                                   *args)))


# --------------------------------------------------------------------- #
# Collective census
# --------------------------------------------------------------------- #

#: ``torch.distributed`` calls the shim records
DIST_OPS = ("all_reduce", "all_gather", "all_gather_object",
            "all_gather_into_tensor", "gather", "gather_object", "scatter",
            "broadcast", "broadcast_object_list", "reduce",
            "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
            "all_to_all_single", "barrier", "batch_isend_irecv", "isend",
            "irecv", "send", "recv")

#: the port's own calls the shim records, by the census name of each:
#: (module, attribute) -> site name
PORT_CALLS = {
    ("heat2d_tpu_torch.parallel.halo", "exchange_halo_strips"): "exchange",
    ("heat2d_tpu_torch.parallel.sharded", "_total"): "allreduce",
    ("heat2d_tpu_torch.ops.cuda_shard", "shard_fused"): "shard_fused",
}


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One recorded call class: ``prim`` under ``path`` (the shimmed
    calls it was made inside, outermost first), ``count`` calls; a strip
    shift carries its (source, destination) shard pairs."""

    prim: str
    path: Tuple[str, ...]
    count: int = 1
    perms: Tuple[Tuple[Tuple[int, int], Tuple[int, int]], ...] = ()

    def describe(self) -> str:
        where = "/".join(self.path) if self.path else "<top>"
        n = f" ×{self.count}" if self.count > 1 else ""
        return f"{self.prim} at {where}{n}"


@dataclasses.dataclass
class CollectiveCensus:
    """What ``record_collectives`` saw, aggregated by (prim, path)."""

    sites: List[CollectiveSite]

    def count(self, prim: str, path: Tuple[str, ...] = ()) -> int:
        return sum(s.count for s in self.sites
                   if s.prim == prim and s.path == path)


class _Recorder:
    def __init__(self):
        self.stack: List[str] = []
        self.agg: Dict[tuple, list] = {}

    def note(self, prim: str, perms=()):
        entry = self.agg.setdefault((prim, tuple(self.stack)), [0, set()])
        entry[0] += 1
        entry[1].update(perms)

    def census(self) -> CollectiveCensus:
        return CollectiveCensus([
            CollectiveSite(prim=p, path=pa, count=c, perms=tuple(sorted(pr)))
            for (p, pa), (c, pr) in sorted(self.agg.items())])


def _scoped(rec: _Recorder, name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        rec.note(name)
        rec.stack.append(name)
        try:
            return fn(*args, **kwargs)
        finally:
            rec.stack.pop()
    return wrapper


def _phase_shim(rec: _Recorder, fn):
    """``halo._phase`` recorded shift by shift: each ``(items, di, dj)``
    moves slot (i - di, j - dj)'s item to slot (i, j) inside the mesh."""
    @functools.wraps(fn)
    def wrapper(mesh, shifts):
        gx, gy = mesh.shape
        for _items, di, dj in shifts:
            pairs = {((i - di, j - dj), (i, j))
                     for i in range(gx) for j in range(gy)
                     if 0 <= i - di < gx and 0 <= j - dj < gy
                     and (mesh.is_local(i, j)
                          or mesh.is_local(i - di, j - dj))}
            rec.note("strip_shift", pairs)
        return fn(mesh, shifts)
    return wrapper


@contextlib.contextmanager
def recording():
    """Arm the shim; yields a recorder whose ``census()`` is the calls
    made inside the block. Every module of the port that bound one of
    ``PORT_CALLS`` by name is patched too."""
    import torch.distributed as dist
    from heat2d_tpu_torch.parallel import halo
    rec = _Recorder()
    patched = []

    def patch(owner, attr, new):
        patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    originals = {}
    for (mod_name, attr), name in PORT_CALLS.items():
        __import__(mod_name)
        originals[getattr(sys.modules[mod_name], attr)] = name
    try:
        for mod in list(sys.modules.values()):
            if not getattr(mod, "__name__", "").startswith(
                    "heat2d_tpu_torch"):
                continue
            for attr, value in list(vars(mod).items()):
                name = originals.get(value) if callable(value) else None
                if name is not None:
                    patch(mod, attr, _scoped(rec, name, value))
        patch(halo, "_phase", _phase_shim(rec, halo._phase))
        for op in DIST_OPS:
            if hasattr(dist, op):
                patch(dist, op, _scoped(rec, op, getattr(dist, op)))
        yield rec
    finally:
        for owner, attr, old in reversed(patched):
            setattr(owner, attr, old)


def record_collectives(fn, *args, **kwargs):
    """``(result, census)`` of ``fn(*args, **kwargs)`` run under the
    shim."""
    with recording() as rec:
        out = fn(*args, **kwargs)
    return out, rec.census()
