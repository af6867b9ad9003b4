"""State that crosses between the JAX package and this port.

The system has no weights; what crosses is the config and the grid:

- ``config_from_dict`` takes ``heat2d_tpu.config.HeatConfig.to_dict()``
  output (or a checkpoint sidecar's ``config``) and returns this port's
  ``HeatConfig``;
- ``state_from_numpy`` turns a host grid (``np.asarray`` of a JAX array,
  or a loaded checkpoint) into the port's tensor on ``device``;
- checkpoints cross as files: ``io.binary`` writes and reads the JAX
  package's format byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from heat2d_tpu_torch.config import HeatConfig
from heat2d_tpu_torch.utils.device import resolve_device


def config_from_dict(d: dict) -> HeatConfig:
    return HeatConfig.from_dict(d)


def state_from_numpy(u, device=None):
    """A contiguous float32 tensor on ``device`` (``cuda`` by default)."""
    a = np.ascontiguousarray(np.asarray(u, dtype=np.float32))
    if a.ndim != 2:
        raise ValueError(f"expected a 2D grid, got shape {a.shape}")
    return torch.from_numpy(a.copy()).to(resolve_device(device))
