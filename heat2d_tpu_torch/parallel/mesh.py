"""The device mesh: the port of ``heat2d_tpu/parallel/mesh.py``.

The reference builds a GRIDX x GRIDY non-periodic Cartesian communicator
(grad1612_mpi_heat.c:73-81). Here a mesh is a (gridx, gridy) grid of
shard slots, each naming the ``torch.device`` that holds that shard; axis
'x' shards grid rows, 'y' columns. Neighbours are implicit in the slot
positions (``parallel/halo.py``).

With fewer cards than shards, shards share a card: ``host_devices(n)``
lists n slots over the visible cards in turn (or n CPU slots), the
counterpart of the JAX package's virtual host devices
(``--host-device-count``). A 2x2 mesh on one H100 holds four real shards;
the exchange and the shard kernels do the same work as on four cards.

In a multi-process world (``parallel/multihost.py``) a mesh spans the
processes: ``owners[i][j]`` names the process that holds shard (i, j),
and this process (``rank``) holds tensors for its own slots only.
"""

from __future__ import annotations

import dataclasses

import torch

from heat2d_tpu_torch.utils.device import resolve_device


#: The mesh axes: 'x' shards grid rows, 'y' columns.
AXIS_NAMES = ("x", "y")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` holds shard (i, j); ``owners[i][j]`` is the
    process that holds it (None: this one holds every shard)."""
    devices: tuple
    owners: tuple | None = None
    rank: int = 0

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    def owner(self, i: int, j: int) -> int:
        return self.rank if self.owners is None else self.owners[i][j]

    def is_local(self, i: int, j: int) -> bool:
        return self.owner(i, j) == self.rank

    @property
    def spans_processes(self) -> bool:
        """Some shard lies on another process."""
        return self.owners is not None and any(
            o != self.rank for row in self.owners for o in row)

    def local_devices(self) -> list:
        """The devices of this process's shards, in slot order."""
        gx, gy = self.shape
        return [self.devices[i][j] for i in range(gx) for j in range(gy)
                if self.is_local(i, j)]

    def flat(self) -> list:
        """The slots in row-major (x, y) order, the shard ids'."""
        return [d for row in self.devices for d in row]

    def distinct(self) -> list:
        """Each device the mesh spans, once, in slot order."""
        return list(dict.fromkeys(self.flat()))


def visible_devices(device=None) -> list:
    """Every device of the chosen type: the visible cards for ``cuda``
    (the default), one CPU slot for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def host_devices(n: int, device=None) -> list:
    """``n`` shard slots on the chosen device: the visible cards in turn
    on ``cuda``, the CPU n times on ``cpu``."""
    if n < 1:
        raise ValueError(f"the device count must be >= 1, got {n}")
    devs = visible_devices(device)
    return [devs[i % len(devs)] for i in range(n)]


def make_mesh(gridx: int, gridy: int = 1, devices=None,
              owners=None) -> Mesh:
    """A (gridx, gridy) mesh over the first gridx * gridy ``devices``
    (default: ``visible_devices()``), validating the count the way
    grad1612_mpi_heat.c:54-59 validates comm_sz == GRIDX*GRIDY.
    ``owners``: the process of each of ``devices`` (``multihost.
    world_slots``), for a mesh that spans processes."""
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    need = gridx * gridy
    if len(devices) < need:
        raise ValueError(
            f"ERROR: the number of devices must be at least {need} "
            f"(gridx={gridx} * gridy={gridy}); have {len(devices)}.")
    rows = tuple(tuple(devices[i * gridy:(i + 1) * gridy])
                 for i in range(gridx))
    if owners is None:
        return Mesh(rows)
    from heat2d_tpu_torch.parallel.multihost import process_index
    owned = tuple(tuple(owners[i * gridy:(i + 1) * gridy])
                  for i in range(gridx))
    return Mesh(rows, owned, process_index())


def neighbor_table(gridx: int, gridy: int = 1) -> list[dict]:
    """Per-shard N/S/E/W neighbour map, the reference's DEBUG topology dump
    (grad1612_mpi_heat.c:170-175): -1 (MPI_PROC_NULL) at the non-periodic
    edges; shard id is the row-major (x, y) mesh position."""
    table = []
    for i in range(gridx):
        for j in range(gridy):
            rank = i * gridy + j
            table.append({
                "shard": rank, "x": i, "y": j,
                "north": rank - gridy if i > 0 else -1,
                "south": rank + gridy if i < gridx - 1 else -1,
                "west": rank - 1 if j > 0 else -1,
                "east": rank + 1 if j < gridy - 1 else -1,
            })
    return table


def mesh_devices_summary(mesh: Mesh) -> dict:
    """Mesh shape and the devices it names (the detailsGPU analogue,
    grad1612_cuda_heat.cu:24-37)."""
    devs = mesh.flat()
    d0 = devs[0]
    cuda = d0.type == "cuda"
    info = {
        "mesh_shape": dict(zip(AXIS_NAMES, mesh.shape)),
        "n_devices": len(mesh.distinct()),
        "n_shards": len(devs),
        "devices": [str(d) for d in devs],
        "processes": sorted({mesh.owner(i, j) for i in range(mesh.shape[0])
                             for j in range(mesh.shape[1])}),
        "device_kind": torch.cuda.get_device_name(d0) if cuda else "cpu",
        "platform": "gpu" if cuda else "cpu",
    }
    if cuda:
        free, total = torch.cuda.mem_get_info(d0)
        info["bytes_limit"] = total
        info["bytes_in_use"] = total - free
    return info
