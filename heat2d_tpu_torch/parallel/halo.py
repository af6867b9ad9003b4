"""Ghost-cell (halo) exchange between the shards of a mesh: the port of
``heat2d_tpu/parallel/halo.py``.

The JAX package exchanges with ``lax.ppermute`` inside ``shard_map``;
here every shard is a tensor of one process, so a shift is a copy between
the shards' tensors (a ``.to(device)`` copy when the neighbour lives on
another device). A shard with no neighbour on a side receives zeros:
MPI_PROC_NULL on a non-periodic grid, the partial ppermute's semantics.

``blocks`` below is always a (gx, gy) nested list of (bm, bn) tensors,
``blocks[i][j]`` the shard at mesh position (i, j); a block may carry
leading (member) axes, (B, bm, bn), as the spatial ensembles' do, and
every strip then carries them too.
"""

from __future__ import annotations

import torch


def shift_from_lower(xs: list) -> list:
    """Along one mesh axis (``xs`` in axis order): each shard receives its
    lower neighbour's value; the first receives zeros."""
    return [torch.zeros_like(xs[0])] + [
        xs[i - 1].to(xs[i].device) for i in range(1, len(xs))]


def shift_from_upper(xs: list) -> list:
    """Each shard receives its upper neighbour's value; the last receives
    zeros."""
    return [xs[i + 1].to(xs[i].device) for i in range(len(xs) - 1)] + [
        torch.zeros_like(xs[-1])]


def _along_x(grid, fn):
    """``fn`` applied to each mesh column (axis x), result as a grid."""
    gx, gy = len(grid), len(grid[0])
    cols = [fn([grid[i][j] for i in range(gx)]) for j in range(gy)]
    return [[cols[j][i] for j in range(gy)] for i in range(gx)]


def exchange_halo_strips(blocks, t: int):
    """T-deep halo exchange as four strips per shard: a grid of
    ``(north, south, west, east)``. north/south are (t, bn) ghost rows;
    west/east are (bm+2t, t) ghost columns of the vertically-extended
    rows, so they carry the corners. Two phases, as in the JAX package:
    N/S first, then E/W from the neighbours' extended edge columns."""
    north = _along_x([[b[..., -t:, :] for b in row] for row in blocks],
                     shift_from_lower)
    south = _along_x([[b[..., :t, :] for b in row] for row in blocks],
                     shift_from_upper)
    out = []
    for i, row in enumerate(blocks):
        right = [torch.cat([north[i][j][..., -t:], b[..., -t:],
                            south[i][j][..., -t:]], dim=-2)
                 for j, b in enumerate(row)]
        left = [torch.cat([north[i][j][..., :t], b[..., :t],
                           south[i][j][..., :t]], dim=-2)
                for j, b in enumerate(row)]
        west, east = shift_from_lower(right), shift_from_upper(left)
        out.append([(north[i][j], south[i][j], west[j], east[j])
                    for j in range(len(row))])
    return out


def extend(u, strips):
    """The (bm+2t, bn+2t) extended block of one shard from its strips."""
    north, south, west, east = strips
    return torch.cat([west, torch.cat([north, u, south], dim=-2), east],
                     dim=-1)


def exchange_halo_2d_wide(blocks, t: int):
    """T-deep exchange assembled: a grid of (bm+2t, bn+2t) extended
    blocks, for the golden loop."""
    strips = exchange_halo_strips(blocks, t)
    return [[extend(b, s) for b, s in zip(row, srow)]
            for row, srow in zip(blocks, strips)]


def fused_halo_viable(bm: int, bn: int, t: int) -> bool:
    """Geometry gate of the overlap (fused) route at depth ``t``: each
    t-wide boundary frame fits without overlapping its opposite."""
    return t >= 1 and bm >= 2 * t and bn >= 2 * t
