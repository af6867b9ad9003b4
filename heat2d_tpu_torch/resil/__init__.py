"""Resilience: injected launch faults (``chaos``), retry with backoff,
the launch watchdog and the degraded-mode breaker (``retry``), and the
host snapshots of a state (``snapshot``)."""

from heat2d_tpu_torch.resil.snapshot import snapshot_shards, snapshot_state

__all__ = ["snapshot_shards", "snapshot_state"]
