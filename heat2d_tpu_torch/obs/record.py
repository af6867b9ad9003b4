"""Run records: the JAX package's schema (``heat2d_tpu/obs/record.py``)
with the same payload keys, and an envelope that names the card.

The envelope carries the schema tag, the record kind, a timestamp, the
torch version, and the device: the card's name, count and power limit
(from ``nvidia-smi``), since a number on a card set below its 700 W
maximum is not comparable with one at full power.
"""

from __future__ import annotations

import datetime

import torch

RECORD_SCHEMA = "heat2d-tpu/run-record/v1"

#: The record kinds the port emits (a subset of the JAX package's
#: ``RECORD_KINDS``): "run" (the solver CLI), "ensemble" (its batched
#: sweep), "bench" (``bench_torch.py``), "serve" (the serve CLI: launch
#: log and serving metrics), "inverse" (the inverse CLI: iterations,
#: final loss, convergence, beside the ``inverse_*`` metric series),
#: "multichip" (strong scaling and mesh serving, ``parallel/scaling.py``
#: and ``mesh/bench.py``), "mesh_chaos" (the mesh fault gate,
#: ``mesh/chaos_gate.py``), "dist" (the multi-process runtime's legs,
#: ``dist/cli.py``), "tune" (the kernel search, ``tune/cli.py``).
RECORD_KINDS = ("run", "ensemble", "bench", "serve", "inverse",
                "multichip", "mesh_chaos", "dist", "tune")


def run_context(device=None) -> dict:
    from heat2d_tpu_torch.parallel.multihost import (process_count,
                                                     process_index)
    from heat2d_tpu_torch.utils.device import device_summary
    return {
        "schema": RECORD_SCHEMA,
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "torch_version": torch.__version__,
        "device": device_summary(device),
        "world": {"process_index": process_index(),
                  "process_count": process_count()},
    }


def halo_record(halo: dict, mesh) -> dict:
    """The sharded run's block of the record: the JAX package's
    ``resolve_halo_route`` keys (requested, depth, shard, mesh, route,
    tier) as JSON lists, and the device of every shard slot."""
    return {**{k: list(v) if isinstance(v, tuple) else v
               for k, v in halo.items()},
            "devices": [str(d) for d in mesh.flat()]}


def attach_context(rec: dict, kind: str, device=None) -> dict:
    """Add the shared envelope to an existing record in place (returns
    it); keys the record already carries are kept."""
    rec.setdefault("kind", kind)
    for k, v in run_context(device).items():
        rec.setdefault(k, v)
    return rec


def build_record(kind: str, config=None, steps_done=None, elapsed_s=None,
                 mcells_per_s=None, warmup_s=None, extra=None,
                 device=None) -> dict:
    """Unified run record; ``extra`` merges payload keys, and keys the
    record already has win over the envelope."""
    if kind not in RECORD_KINDS:
        raise ValueError(f"record kind must be one of {RECORD_KINDS}, got "
                         f"{kind!r}")
    rec: dict = {}
    if config is not None:
        rec["config"] = (config if isinstance(config, dict)
                         else config.to_dict())
    if steps_done is not None:
        rec["steps_done"] = int(steps_done)
    if elapsed_s is not None:
        rec["elapsed_s"] = float(elapsed_s)
    if mcells_per_s is not None:
        rec["mcells_per_s"] = float(mcells_per_s)
    if warmup_s is not None:
        rec["warmup_s"] = float(warmup_s)
    if extra:
        rec.update(extra)
    return attach_context(rec, kind, device)


def write_run_jsonl(registry, path, kind: str, extra: dict,
                    device=None) -> None:
    """The CLIs' telemetry export: the registry's snapshot line and a
    ``kind`` run record carrying ``extra`` as its payload, as JSONL. No-op
    without a registry or a path."""
    if registry is None or not path:
        return
    rec = build_record(kind, extra=dict(extra), device=device)
    registry.write_jsonl(path, extra_records=[{"event": "run_record",
                                               **rec}])
