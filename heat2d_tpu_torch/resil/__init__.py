"""Resilience, the port of ``heat2d_tpu/resil``:

- ``manager``: ``CheckpointManager``, crash-consistent snapshots (temp +
  ``os.replace`` commit, sha256-verified sidecars, ``io/binary.py``)
  under a step -> file manifest with retention, and ``latest_valid()``
  that skips torn entries;
- ``writer``: ``AsyncCheckpointer``, double-buffered checkpoint writes
  off the hot loop, collectives kept on the main thread;
- ``chaos``: fault injection (kill a checkpoint mid-write, fail N
  launches, latency, device loss, a hung launch, a bit flip) from
  ``HEAT2D_CHAOS_*`` or ``install()``;
- ``retry``: retry with backoff, the launch watchdog and the
  degraded-mode breaker;
- ``snapshot``: host snapshots of a state.

Metric families (the README's port section has the table):
``resil_ckpt_*``, ``resil_restore_*`` and
``resil_chaos_injected_total{point}``.
"""

from heat2d_tpu_torch.io.binary import CheckpointCorruptError
from heat2d_tpu_torch.resil.chaos import ChaosConfig, ChaosError
from heat2d_tpu_torch.resil.manager import CheckpointManager, is_manager_dir
from heat2d_tpu_torch.resil.retry import (DegradedMode, RetryPolicy,
                                          TransientError, Watchdog,
                                          call_with_retries,
                                          default_transient)
from heat2d_tpu_torch.resil.snapshot import snapshot_shards, snapshot_state
from heat2d_tpu_torch.resil.writer import AsyncCheckpointer

__all__ = [
    "AsyncCheckpointer",
    "ChaosConfig",
    "ChaosError",
    "CheckpointCorruptError",
    "CheckpointManager",
    "DegradedMode",
    "RetryPolicy",
    "TransientError",
    "Watchdog",
    "call_with_retries",
    "default_transient",
    "is_manager_dir",
    "snapshot_shards",
    "snapshot_state",
]
