"""State that crosses between the JAX package and this port.

The system has no weights; what crosses is the config and the grid:

- ``config_from_dict`` takes ``heat2d_tpu.config.HeatConfig.to_dict()``
  output (or a checkpoint sidecar's ``config``) and returns this port's
  ``HeatConfig``;
- ``state_from_numpy`` turns a host grid (``np.asarray`` of a JAX array,
  or a loaded checkpoint) into the port's tensor on ``device``;
- ``sharded_from_numpy`` places a host grid as the ``ShardedGrid`` of a
  mesh, padded to equal shards as ``Heat2DSolver.place`` pads it in the
  JAX package (``heat2d_tpu/models/solver.py:112-126``);
- ``batch_from_numpy`` does the same for an ensemble: a (B, nx, ny) batch
  of states and its float32 (cx, cy) vectors;
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


def sharded_from_numpy(u, config, mesh):
    """A host grid as the ``ShardedGrid`` of ``mesh``: padded with zeros
    up to equal shards, block (i, j) on mesh device (i, j) (this
    process's blocks only, on a mesh that spans processes)."""
    from heat2d_tpu_torch.parallel.sharded import (ShardedGrid,
                                                   padded_global_shape)
    a = np.asarray(u, dtype=np.float32)
    if a.ndim != 2:
        raise ValueError(f"expected a 2D grid, got shape {a.shape}")
    pnx, pny = padded_global_shape(config, mesh)
    if a.shape != (pnx, pny):
        a = np.pad(a, ((0, pnx - a.shape[0]), (0, pny - a.shape[1])))
    gx, gy = mesh.shape
    bm, bn = pnx // gx, pny // gy
    blocks = [[state_from_numpy(a[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn],
                                mesh.devices[i][j])
               if mesh.is_local(i, j) else None for j in range(gy)]
              for i in range(gx)]
    return ShardedGrid(blocks, config.nxprob, config.nyprob, mesh)


def batch_from_numpy(u, cxs, cys, device=None):
    """(u, cxs, cys) as the ensemble kernels take them on ``device``
    (``cuda`` by default): a contiguous (B, nx, ny) float32 batch and two
    float32 vectors of length B. Accepts numpy arrays, sequences and
    tensors."""
    dev = resolve_device(device)
    cxs = torch.as_tensor(cxs, dtype=torch.float32, device=dev).contiguous()
    cys = torch.as_tensor(cys, dtype=torch.float32, device=dev).contiguous()
    if cxs.shape != cys.shape or cxs.dim() != 1:
        raise ValueError("cxs and cys must be equal-length 1D arrays")
    u = torch.as_tensor(u, dtype=torch.float32, device=dev).contiguous()
    if u.dim() != 3 or u.shape[0] != cxs.shape[0]:
        raise ValueError(f"the batch must be ({cxs.shape[0]}, nx, ny), "
                         f"got {tuple(u.shape)}")
    return u, cxs, cys
