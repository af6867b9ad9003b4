"""The host-mediated halo route: row slabs and T-deep halos over the store,
bitwise equal to the one-process program. The port of
``heat2d_tpu/dist/exchange.py``.

Each process owns a contiguous row slab, extends it with a T-deep halo of
its neighbours' OWNED rows, runs ``t <= T`` golden ``stencil_step``
steps on the extended array on its device, and re-exchanges. Held rows
at a slab's fake edge contaminate one row per step, so after ``t`` steps
every owned row (at distance >= T from any fake edge) is BITWISE what
the one-process program computes: the same elementwise float32
arithmetic on a sliced array, no reduction, no reassociation. It is the
overlap-halo argument of the fused sharded route, carried over the
store with the host as the DMA engine; it needs the store only, no
collective.

Strips travel as raw float32 bytes under write-once per-step keys (as
blobs, ``KVStore.set_blob``); the consumer deletes what it read, so the
store stays bounded. A neighbour
that never publishes is a ``HostLostError`` naming that host: detection,
not diagnosis; recovery is ``dist/topology.py``'s job.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from heat2d_tpu_torch.dist.runtime import KV_NS, DistWorld, _kv


def slab_split(nx: int, processes: int) -> List[Tuple[int, int]]:
    """Row ranges [lo, hi) per process: near-even, order-preserving,
    exactly partitioning (mpi_heat2Dn.c distributes rows the same
    way)."""
    if processes < 1:
        raise ValueError(f"processes must be >= 1, got {processes}")
    if nx < processes:
        raise ValueError(
            f"cannot split {nx} rows over {processes} processes")
    return [(i * nx // processes, (i + 1) * nx // processes)
            for i in range(processes)]


def segment_steps(u, t: int, cx, cy):
    """``t`` golden stencil steps (``ops/stencil.py``) on an extended slab:
    the one function both the distributed slabs and the one-process
    reference run, so parity is a statement about slicing."""
    from heat2d_tpu_torch.ops.stencil import stencil_step
    for _ in range(t):
        u = stencil_step(u, cx, cy)
    return u


class DcnHaloExchanger:
    """Publishes this process's boundary strips and fetches its
    neighbours', one exchange per segment, keyed by step so keys are
    write-once. Counts ``dist_halo_bytes_total`` (bytes moved, both
    directions) per exchange."""

    def __init__(self, world: DistWorld, depth: int, client=None, *,
                 timeout_s: float = 60.0, registry=None):
        if depth < 1:
            raise ValueError(f"halo depth must be >= 1, got {depth}")
        self.world = world
        self.depth = depth
        self._client = client
        self.timeout_s = timeout_s
        self.registry = registry

    def _key(self, tag: str, src: int, dst: int) -> str:
        return f"{KV_NS}halo/{tag}/{src}-{dst}"

    def exchange(self, tag: str, top: np.ndarray,
                 bottom: np.ndarray) -> Tuple[Optional[np.ndarray],
                                              Optional[np.ndarray]]:
        """Send my top/bottom OWNED strips to my row neighbours; return
        (rows_above, rows_below), None at a true global boundary.
        ``top``/``bottom`` are (depth, ny) float32 arrays."""
        kv = self._client = _kv(self._client)
        me = self.world.process_index
        count = self.world.process_count
        up = me - 1 if me > 0 else None
        down = me + 1 if me < count - 1 else None
        moved = 0
        # publish before fetching: both neighbours then progress whatever
        # the order they arrive in
        for dst, strip in ((up, top), (down, bottom)):
            if dst is not None:
                kv.set_blob(self._key(tag, me, dst), np.ascontiguousarray(
                    strip, np.float32).tobytes())
                moved += strip.nbytes

        def fetch(src: int, like: np.ndarray) -> np.ndarray:
            key = self._key(tag, src, me)
            buf = kv.get_blob(key, self.timeout_s, lost_host=src,
                              phase=f"halo:{tag}")
            kv.delete_blob(key)            # consumed: bound the store
            return np.frombuffer(buf, dtype=np.float32).reshape(like.shape)

        above = fetch(up, top) if up is not None else None
        below = fetch(down, bottom) if down is not None else None
        moved += sum(a.nbytes for a in (above, below) if a is not None)
        if self.registry is not None:
            self.registry.counter("dist_halo_bytes_total", float(moved))
        return above, below


def run_process_slab(nx: int, ny: int, steps: int, *,
                     cx: float = 0.1, cy: float = 0.1,
                     depth: int = 4,
                     process_index: int = 0, process_count: int = 1,
                     exchanger: Optional[DcnHaloExchanger] = None,
                     u0: Optional[np.ndarray] = None,
                     start_step: int = 0,
                     on_segment: Optional[Callable] = None,
                     device=None) -> Tuple[np.ndarray, int]:
    """Run this process's slab from ``start_step`` to ``steps`` on
    ``device`` (``cuda`` unless asked for ``cpu``); returns (owned rows as
    float32 numpy, final step).

    ``u0`` is the FULL grid at ``start_step`` (default: the golden initial
    condition): every process slices its own extension from it, so a
    resume at any step resharding to any process count is "load the
    checkpoint, call this" (the N-save -> M-restore contract).
    ``on_segment(step, owned)`` fires after every segment with the owned
    rows as a tensor on the device: the checkpoint hook."""
    from heat2d_tpu_torch.ops.init import inidat
    from heat2d_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if process_count > 1 and exchanger is None:
        raise ValueError("multi-process slabs need an exchanger")
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} outside world of "
            f"{process_count}")
    slabs = slab_split(nx, process_count)
    lo, hi = slabs[process_index]
    if process_count > 1 and min(h - l for l, h in slabs) < depth:
        raise ValueError(
            f"slab of {nx} rows over {process_count} processes is "
            f"shallower than the depth-{depth} halo: a neighbour's halo "
            "would have to span TWO hosts")
    full = (inidat(nx, ny, device=dev) if u0 is None else
            torch.as_tensor(np.asarray(u0, np.float32), device=dev))
    if tuple(full.shape) != (nx, ny):
        raise ValueError(
            f"u0 shape {tuple(full.shape)} does not match grid ({nx}, "
            f"{ny})")
    elo, ehi = max(0, lo - depth), min(nx, hi + depth)
    u_ext = full[elo:ehi].contiguous()
    del full
    step = start_step
    while step < steps:
        t = min(depth, steps - step)
        if process_count > 1:
            owned = u_ext[lo - elo:hi - elo]
            above, below = exchanger.exchange(
                f"s{step}", owned[:depth].cpu().numpy(),
                owned[-depth:].cpu().numpy())
            parts = [owned]
            if above is not None:
                parts.insert(0, torch.from_numpy(above.copy()).to(dev))
            if below is not None:
                parts.append(torch.from_numpy(below.copy()).to(dev))
            u_ext = torch.cat(parts, dim=0)
        u_ext = segment_steps(u_ext, t, cx, cy)
        step += t
        if on_segment is not None:
            on_segment(step, u_ext[lo - elo:hi - elo])
    return u_ext[lo - elo:hi - elo].cpu().numpy(), step
