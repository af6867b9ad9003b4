"""Run records and the metrics registry."""

from heat2d_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = ["MetricsRegistry", "get_registry"]
