"""The global arrangement of mesh slots over processes. The port of
``heat2d_tpu/dist/mesh.py``.

The single-process mesh engines take a flat slot order and build their
own meshes, so the world layer's job is to hand them the RIGHT order:
host-major, so the spatial (halo) axis stays inside one process
wherever the shape allows and only the batch axis crosses processes.

``seam_profile`` prices what the arrangement could not avoid: for a
(batch, xy) grid it walks every xy-adjacent pair (ring closure included,
the fused route's halo is a ring) and classifies each seam with
``DistWorld.link_kind``; the scheduler folds the seam counts and
per-step bytes into its decision rows (``mesh/scheduler.py``) and prices
them with ``tune/measure.route_bytes_per_s``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from heat2d_tpu_torch.dist.runtime import DistWorld


def pod_device_order(world: DistWorld) -> List[int]:
    """Global slot ordinals, host-major (process-major), stable within a
    process: the flat order every runner consumes."""
    return [g for p in range(world.process_count)
            for g in world.devices_of(p)]


def arrange_pod(world: DistWorld, batch: int, xy: int) -> List[List[int]]:
    """Host-major order reshaped (batch, xy): with uniform per-process
    slot counts and ``xy`` dividing them (or them dividing ``xy``), every
    xy-row touches as few processes as possible, so halo traffic stays
    inside one and only batch dispatch crosses."""
    order = pod_device_order(world)
    if batch * xy != len(order):
        raise ValueError(
            f"({batch}, {xy}) mesh wants {batch * xy} devices, the "
            f"pod has {len(order)}")
    return [order[r * xy:(r + 1) * xy] for r in range(batch)]


def seams(arrangement: Sequence[Sequence[int]]):
    """Every xy-adjacent slot pair ``(a, b)`` of the arrangement, the
    ring wrap included, a slot never paired with itself (so each is an
    'ici' or a 'dcn' seam)."""
    for row in arrangement:
        k = len(row)
        if k < 2:
            continue
        for j in range(k):
            a, b = row[j], row[(j + 1) % k]
            if a != b:
                yield a, b


def seam_profile(world: DistWorld, arrangement: Sequence[Sequence[int]],
                 ny: int, itemsize: int = 4) -> dict:
    """Classify every xy-adjacent slot pair (the ring wrap included) and
    price the per-step halo edge traffic:

    - ``ici_seams`` / ``dcn_seams``: seam counts by link class;
    - ``seam_bytes_per_step``: 2 ny itemsize per seam (one strip each
      way);
    - ``dcn_bytes_per_step``: the share crossing hosts, the number the
      scheduler prices against the slower link.
    """
    counts = {"ici": 0, "dcn": 0}
    per_seam = 2 * ny * itemsize
    dcn_bytes = 0
    for a, b in seams(arrangement):
        kind = world.link_kind(a, b)
        counts[kind] += 1
        if kind == "dcn":
            dcn_bytes += per_seam
    total = counts["ici"] + counts["dcn"]
    return {"ici_seams": counts["ici"], "dcn_seams": counts["dcn"],
            "seam_bytes_per_step": per_seam * total,
            "dcn_bytes_per_step": dcn_bytes}


def pod_mesh(world: Optional[DistWorld] = None,
             batch: Optional[int] = None, xy: Optional[int] = None,
             device=None):
    """The port's ``parallel.mesh.Mesh`` of shape (batch, xy) over the
    host-major slot order of ``world`` (default: the live world; the
    whole world on the batch axis, ``xy`` = 1), each slot naming its
    owner process and the device that process runs on
    (``multihost.process_device``)."""
    from heat2d_tpu_torch.parallel.mesh import Mesh
    from heat2d_tpu_torch.parallel.multihost import process_device
    if world is None:
        world = DistWorld.from_env(device=device)
    if batch is None or xy is None:
        batch, xy = world.n_devices, 1
    rows = arrange_pod(world, batch, xy)
    owners = tuple(tuple(world.device_process[g] for g in row)
                   for row in rows)
    return Mesh(tuple(tuple(process_device(p, device) for p in row)
                      for row in owners), owners, world.process_index)
