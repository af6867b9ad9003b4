"""Ghost-cell (halo) exchange between the shards of a mesh: the port of
``heat2d_tpu/parallel/halo.py``.

The JAX package exchanges with ``lax.ppermute`` inside ``shard_map``;
here a shard of this process is a tensor of it, so a shift between two
of them is a copy between their tensors (a ``.to(device)`` copy when the
neighbour lives on another device). A shard with no neighbour on a side receives zeros:
MPI_PROC_NULL on a non-periodic grid, the partial ppermute's semantics.

``blocks`` below is always a (gx, gy) nested list of (bm, bn) tensors,
``blocks[i][j]`` the shard at mesh position (i, j); a block may carry
leading (member) axes, (B, bm, bn), as the spatial ensembles' do, and
every strip then carries them too.

Across processes (a mesh that ``spans_processes``), ``blocks`` holds None
at the slots of other processes. A strip whose neighbour is local is
still a copy; one whose neighbour is on another rank goes by
``torch.distributed.batch_isend_irecv``, every send and receive of a
phase posted before any wait (so no pair of blocking calls can
deadlock). gloo moves CPU tensors: a card's strips are staged into
pinned host buffers and copied back to the card before a kernel reads
them. ``cross_process_counts()`` holds the exchanges, bytes and seconds
of that route.
"""

from __future__ import annotations

import time

import torch

from heat2d_tpu_torch.parallel.mesh import Mesh

#: The cross-process route's totals in this process: exchanges (calls of
#: ``exchange_halo_strips`` that moved a strip between ranks, one a
#: chunk), the phases among them that did, bytes sent and received, and
#: host seconds spent in them (staging, transfer and waits; the card's
#: queued kernels are waited for before the clock starts, so their time
#: is not in it). ``utils.timing.timed_call`` reads their change over its
#: timed run.
CROSS_PROCESS = {"exchanges": 0, "phases": 0, "bytes": 0, "seconds": 0.0}


def cross_process_counts() -> dict:
    return dict(CROSS_PROCESS)


def exchange_halo_strips(blocks, t: int, mesh=None):
    """T-deep halo exchange as four strips per shard: a grid of
    ``(north, south, west, east)``. north/south are (t, bn) ghost rows;
    west/east are (bm+2t, t) ghost columns of the vertically-extended
    rows, so they carry the corners. Two phases, as in the JAX package:
    N/S first, then E/W from the neighbours' extended edge columns.
    Without a ``mesh`` every shard is this process's; with one that
    spans processes, only this process's shards get strips (None
    elsewhere) and the strips cross ranks (module docstring)."""
    if mesh is None:
        mesh = Mesh(tuple(tuple(b.device for b in row) for row in blocks))
    gx, gy = mesh.shape
    local = [(i, j) for i in range(gx) for j in range(gy)
             if mesh.is_local(i, j)]

    def grid(fn):
        out = [[None] * gy for _ in range(gx)]
        for i, j in local:
            out[i][j] = fn(i, j)
        return out

    phases = CROSS_PROCESS["phases"]
    bottom = grid(lambda i, j: blocks[i][j][..., -t:, :])
    top = grid(lambda i, j: blocks[i][j][..., :t, :])
    north, south = _phase(mesh, [(bottom, 1, 0), (top, -1, 0)])
    right = grid(lambda i, j: torch.cat(
        [north[i][j][..., -t:], blocks[i][j][..., -t:],
         south[i][j][..., -t:]], dim=-2))
    left = grid(lambda i, j: torch.cat(
        [north[i][j][..., :t], blocks[i][j][..., :t],
         south[i][j][..., :t]], dim=-2))
    west, east = _phase(mesh, [(right, 0, 1), (left, 0, -1)])
    if CROSS_PROCESS["phases"] > phases:
        CROSS_PROCESS["exchanges"] += 1
    return grid(lambda i, j: (north[i][j], south[i][j], west[i][j],
                              east[i][j]))


def _sync(tensors) -> None:
    """Wait for every card that holds one of ``tensors``."""
    for dev in {x.device for x in tensors if x.is_cuda}:
        torch.cuda.synchronize(dev)


def _phase(mesh, shifts):
    """One exchange phase. Each shift ``(items, di, dj)`` gives every
    local slot (i, j) the item of slot (i - di, j - dj), moved to its
    device, or zeros shaped as its own item off the mesh's edge
    (MPI_PROC_NULL). Cross-rank items go as one batch of non-blocking
    sends and receives, tagged by the receiving slot and the shift."""
    gx, gy = mesh.shape
    outs = [[[None] * gy for _ in range(gx)] for _ in shifts]
    sends, recvs = [], []
    for k, (items, di, dj) in enumerate(shifts):
        for i in range(gx):
            for j in range(gy):
                si, sj = i - di, j - dj
                inside = 0 <= si < gx and 0 <= sj < gy
                tag = (k * gx + i) * gy + j
                if mesh.is_local(i, j):
                    like = items[i][j]
                    if not inside:
                        outs[k][i][j] = torch.zeros_like(like)
                    elif mesh.is_local(si, sj):
                        outs[k][i][j] = items[si][sj].to(like.device)
                    else:
                        recvs.append((k, i, j, like, mesh.owner(si, sj),
                                      tag))
                elif inside and mesh.is_local(si, sj):
                    sends.append((items[si][sj], mesh.owner(i, j), tag))
    if not sends and not recvs:
        return outs
    import torch.distributed as dist

    _sync([s for s, _, _ in sends] + [r[3] for r in recvs])
    t0 = time.perf_counter()
    staged = [(s.contiguous().to("cpu", non_blocking=True), dst, tag)
              for s, dst, tag in sends]
    _sync([s for s, _, _ in sends])
    bufs = [torch.empty(like.shape, dtype=like.dtype,
                        pin_memory=like.is_cuda)
            for _, _, _, like, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, h, dst, tag=tag) for h, dst, tag in staged]
    ops += [dist.P2POp(dist.irecv, b, src, tag=tag)
            for b, (_, _, _, _, src, tag) in zip(bufs, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for b, (k, i, j, like, _, _) in zip(bufs, recvs):
        outs[k][i][j] = b.to(like.device, non_blocking=True)
    CROSS_PROCESS["phases"] += 1
    CROSS_PROCESS["bytes"] += sum(h.numel() * h.element_size()
                                  for h, _, _ in staged) + sum(
        b.numel() * b.element_size() for b in bufs)
    CROSS_PROCESS["seconds"] += time.perf_counter() - t0
    return outs


def extend(u, strips):
    """The (bm+2t, bn+2t) extended block of one shard from its strips."""
    north, south, west, east = strips
    return torch.cat([west, torch.cat([north, u, south], dim=-2), east],
                     dim=-1)


def exchange_halo_2d_wide(blocks, t: int, mesh=None):
    """T-deep exchange assembled: a grid of (bm+2t, bn+2t) extended
    blocks, for the golden loop (None at other processes' slots)."""
    strips = exchange_halo_strips(blocks, t, mesh)
    return [[None if b is None else extend(b, s)
             for b, s in zip(row, srow)]
            for row, srow in zip(blocks, strips)]


def fused_halo_viable(bm: int, bn: int, t: int) -> bool:
    """Geometry gate of the overlap (fused) route at depth ``t``: each
    t-wide boundary frame fits without overlapping its opposite."""
    return t >= 1 and bm >= 2 * t and bn >= 2 * t
