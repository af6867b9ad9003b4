"""CheckpointManager: a directory of crash-consistent restart points. The
port's copy of ``heat2d_tpu/resil/manager.py``, with the same layout, so
that a directory written by either stack loads in the other:

```
ckpts/
  MANIFEST.json               # step -> file, newest last (atomic replace)
  ckpt_00000040.bin           # raw f32 grid (the MPI-IO byte format)
  ckpt_00000040.bin.meta.json # step/shape/config + sha256 of the binary
  ckpt_00000080.bin
  ...
```

Every snapshot goes through ``io.binary.save_checkpoint``'s staged commit
(temp + ``os.replace``, digest in the sidecar); then the manifest is
rewritten atomically and snapshots beyond the retention window are
removed. ``latest_valid()`` walks the manifest newest first, skipping any
entry that does not load verified (a torn pair, a truncated binary,
missing files): a crash mid-write resumes from the previous snapshot.

In a world of processes ``save`` of a grid that spans them is
COLLECTIVE (every process writes its own blocks); the manifest and the
removal of old snapshots are process 0's, and a closing barrier of
``parallel.multihost`` keeps any process from resuming against a
manifest still being written. ``latest_valid`` reads the shared
filesystem on each process.

Metrics (an ``obs.MetricsRegistry`` when given): ``resil_ckpt_save_s``,
``resil_ckpt_saves_total``, ``resil_ckpt_gc_total``,
``resil_ckpt_retained``, ``resil_ckpt_latest_step``,
``resil_ckpt_skipped_torn_total``, ``resil_restore_total`` and
``resil_restore_step``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
from typing import Optional

from heat2d_tpu_torch.io.binary import (CheckpointCorruptError, _fsync_path,
                                        load_checkpoint, save_checkpoint)
from heat2d_tpu_torch.parallel import multihost

log = logging.getLogger("heat2d_tpu_torch.resil")

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_FORMAT = "heat2d-tpu-checkpoint-manifest-v1"
_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.bin$")


def is_manager_dir(path) -> bool:
    """True when ``path`` names a checkpoint DIRECTORY (an existing
    directory, or one holding a manifest) rather than a single
    checkpoint file: how the CLI tells the two apart."""
    p = str(path)
    return os.path.isdir(p) or os.path.exists(os.path.join(p, MANIFEST_NAME))


class CheckpointManager:
    """Retention, manifest and torn-entry fallback over atomic snapshots.

    ``keep``: the number of newest snapshots retained (None or 0 = all).
    """

    def __init__(self, directory, keep: Optional[int] = 3, registry=None):
        if keep is not None and keep < 0:
            raise ValueError(f"keep must be >= 0 or None, got {keep}")
        self.directory = str(directory)
        self.keep = keep or None
        self.registry = registry
        os.makedirs(self.directory, exist_ok=True)

    # -- paths --------------------------------------------------------- #

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.bin")

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    # -- manifest ------------------------------------------------------ #

    def manifest(self) -> list:
        """Entries as recorded, oldest first: ``[{"step", "file"}, ...]``.
        A missing or corrupt manifest degrades to a directory scan (the
        manifest is an index; the verified sidecars are the truth)."""
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
            entries = sorted(m["entries"], key=lambda e: int(e["step"]))
            return [{"step": int(e["step"]), "file": str(e["file"])}
                    for e in entries]
        except (OSError, ValueError, KeyError, TypeError):
            return self._scan()

    def _scan(self) -> list:
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = _CKPT_RE.match(name)
            if m:
                out.append({"step": int(m.group(1)), "file": name})
        return sorted(out, key=lambda e: e["step"])

    def steps(self) -> list:
        return [e["step"] for e in self.manifest()]

    def _write_manifest(self, entries) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"format": MANIFEST_FORMAT, "entries": entries}, f,
                      indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)
        # the rename must survive power loss, like the pair it indexes
        _fsync_path(self.directory)

    # -- save ---------------------------------------------------------- #

    def save(self, u, step: int, config, shape=None) -> str:
        """Snapshot ``u`` (a host array, a tensor, or a ``ShardedGrid``)
        at ``step`` (atomic commit), index it, remove the retention
        overflow. Returns the checkpoint path. COLLECTIVE when ``u``
        spans processes: every process calls it."""
        path = self.path_for(step)
        timer = (self.registry.timer("resil_ckpt_save_s")
                 if self.registry is not None else contextlib.nullcontext())
        with timer:
            save_checkpoint(u, step, config, path, shape=shape)
            self.index(step)
        if getattr(u, "spans_processes", False):
            multihost.barrier()
        return path

    def index(self, step: int) -> None:
        """Record a committed snapshot in the manifest and apply the
        retention policy (process 0 only; a no-op elsewhere)."""
        if multihost.process_index() != 0:
            return
        entries = [e for e in self.manifest() if e["step"] != int(step)]
        entries.append({"step": int(step),
                        "file": os.path.basename(self.path_for(step))})
        entries.sort(key=lambda e: e["step"])
        pruned = []
        if self.keep is not None and len(entries) > self.keep:
            pruned, entries = entries[:-self.keep], entries[-self.keep:]
        self._write_manifest(entries)
        for e in pruned:
            self._unlink(os.path.join(self.directory, e["file"]))
        if self.registry is not None:
            self.registry.counter("resil_ckpt_saves_total")
            if pruned:
                self.registry.counter("resil_ckpt_gc_total", len(pruned))
            self.registry.gauge("resil_ckpt_retained", len(entries))
            self.registry.gauge("resil_ckpt_latest_step",
                                entries[-1]["step"])

    @staticmethod
    def _unlink(path) -> None:
        for p in (path, str(path) + ".meta.json", str(path) + ".tmp"):
            try:
                os.remove(p)
            except OSError:
                pass

    # -- restore ------------------------------------------------------- #

    def latest_valid(self, shape=None, mmap: bool = False):
        """The newest checkpoint that LOADS VERIFIED, as ``(grid, step,
        config_dict)``, or None when no entry survives. Torn, corrupt or
        missing entries are skipped (``resil_ckpt_skipped_torn_total``)
        and the walk falls back to the previous snapshot. ``mmap``: the
        grid as a read-only memory map (``io.binary.load_checkpoint``),
        for a process that places only its own shards."""
        for entry in reversed(self.manifest()):
            path = os.path.join(self.directory, entry["file"])
            try:
                grid, step, cfg = load_checkpoint(path, shape=shape,
                                                  mmap=mmap)
            except (CheckpointCorruptError, OSError, ValueError) as e:
                log.warning("skipping torn checkpoint %s: %s", path, e)
                if self.registry is not None:
                    self.registry.counter("resil_ckpt_skipped_torn_total")
                continue
            if self.registry is not None:
                self.registry.counter("resil_restore_total")
                self.registry.gauge("resil_restore_step", step)
            return grid, step, cfg
        return None

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None
