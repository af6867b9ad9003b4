"""Multi-process bring-up, the MPI_Init/Comm_size/Comm_rank analogue, and
the gather of a run's result to the host: the port of
``heat2d_tpu/parallel/multihost.py``.

The reference brings its world up with MPI_Init under mpiexec
(grad1612_mpi_heat.c:42-44) and tears it down with MPI_Finalize (:314).
Here N processes form one ``torch.distributed`` world: process 0 hosts a
``TCPStore`` at the coordinator address (the rendezvous and the KV store
of ``dist/``), and every process joins a gloo process group over it.
``initialize_distributed()`` with no arguments and ``force=True`` reads
torchrun's ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), the counterpart of the JAX CLI's
``--multihost`` discovery from the environment.

The backend is gloo on the CPU and on the card. A rank whose shards lie
on a card stages the halo strips it exchanges with other ranks through
pinned host buffers (``parallel/halo.py``): that is the exchange path,
not a fallback. The shards and the kernels stay on the card; only the
T-deep strips cross. (NCCL cannot put two ranks on one card, and a
rank per card is a later item of ``ROADMAP.md``.)

Process p owns a contiguous run of mesh slots in row-major order
(host-major, as ``dist/mesh.pod_device_order`` orders them); rank r's
slots live on ``cuda:(r % device_count)``, or on the CPU
(``world_slots``).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

#: torchrun's ``env://`` variables, read by a forced bring-up without
#: arguments.
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

#: Seconds the rendezvous (and every collective) may wait for a peer.
DEFAULT_TIMEOUT_S = 300.0

#: The live world of this process: its store and coordinator address
#: (torch.distributed's default group is per process too).
_world: dict = {}


def _from_env(coordinator, num_processes, process_id):
    """Fill the arguments a launch line left out from torchrun's
    variables; raise naming what neither gave."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [name for name, v in (("coordinator", coordinator),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(
            f"multi-process bring-up needs {', '.join(missing)}: pass "
            f"--coordinator/--num-processes/--process-id, or launch under "
            f"torchrun, which sets {', '.join(ENV_VARS)}")
    return coordinator, int(num_processes), int(process_id)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           force: bool = False) -> dict:
    """Bring up the multi-process world; returns ``world_summary()``.

    Safe when single-process: with no argument and ``force=False`` nothing
    is initialized and the world is one process. ``force=True`` takes what
    the arguments leave out from torchrun's environment. Idempotent within
    a process (MPI_Init's call-once rule, kept by a flag)."""
    want = force or any(v is not None for v in
                        (coordinator, num_processes, process_id))
    if want and not _world:
        coordinator, n, pid = _from_env(coordinator, num_processes,
                                        process_id)
        host, _, port = coordinator.rpartition(":")
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        # Under torchrun the agent already serves the store at
        # MASTER_PORT: every worker joins it as a client.
        agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
        store = dist.TCPStore(host or "127.0.0.1", int(port), n,
                              pid == 0 and not agent, timeout=timeout)
        dist.init_process_group("gloo", store=store, rank=pid, world_size=n,
                                timeout=timeout)
        _world.update(store=store, coordinator=coordinator)
    return world_summary()


def is_multiprocess() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def coordinator() -> str | None:
    return _world.get("coordinator")


def store():
    """The world's ``TCPStore`` (the KV store ``dist/`` runs over). Raises
    when this process never joined a world."""
    if "store" not in _world:
        raise RuntimeError(
            "no coordination store: this process never joined a "
            "multi-process world (single-process, or "
            "initialize_distributed() not called)")
    return _world["store"]


def world_summary() -> dict:
    """Comm_size/Comm_rank as structured data."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": process_index(),
            "process_count": process_count(),
            "local_device_count": local,
            "global_device_count": local * process_count(),
            "coordinator": coordinator()}


def barrier() -> None:
    """Every process arrives before any leaves (a no-op alone)."""
    if is_multiprocess():
        dist.barrier()


def shutdown_distributed() -> None:
    """MPI_Finalize analogue; no-op when never initialized."""
    if _world:
        dist.destroy_process_group()
        _world.clear()


def process_device(process: int, device=None) -> torch.device:
    """The device process ``process`` runs its slots on:
    ``cuda:(process % device_count)``, or the CPU with ``device='cpu'``."""
    from heat2d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", process % torch.cuda.device_count())


def world_slots(n_local: int, device=None) -> tuple[list, list]:
    """``(devices, owners)``: the mesh slots of the world, ``n_local`` per
    process in process order, and the process owning each, on
    ``process_device``. A remote process's entry names the device that
    process uses; only its owner holds a tensor there."""
    if n_local < 1:
        raise ValueError(f"the device count must be >= 1, got {n_local}")
    owners = [p for p in range(process_count()) for _ in range(n_local)]
    return [process_device(p, device) for p in owners], owners


def all_gather_rows(rows: torch.Tensor, counts: list) -> list:
    """Every process's ``rows`` (a (k_p, ...) tensor, k_p = ``counts[p]``,
    the same trailing shape everywhere), gathered to every process as a
    list of CPU tensors in process order: the tiled all-gather. gloo
    moves CPU tensors, so a card's rows are staged on the host."""
    kmax = max(counts)
    pad = torch.zeros((kmax,) + tuple(rows.shape[1:]), dtype=rows.dtype)
    pad[:rows.shape[0]] = rows.detach().cpu()
    out = [torch.empty_like(pad) for _ in counts]
    dist.all_gather(out, pad)
    return [o[:k] for o, k in zip(out, counts)]


def gather_to_host(u) -> np.ndarray:
    """The full array on the host as numpy, the MPI result-gather: a
    ``ShardedGrid``'s blocks concatenated back into the (padded) global
    grid, a tensor copied from its device, a host array as it is. A grid
    whose blocks lie on other processes all-gathers them first (tiled,
    ``process_allgather(tiled=True)``'s counterpart): a collective, every
    process calls it. The caller crops the equal-shard padding.

    HEAT2D_FORBID_GATHER=1 (a test tripwire): raise instead of gathering a
    grid that spans processes, so a flow expected to stay per shard
    proves it never gathers."""
    if hasattr(u, "blocks"):
        blocks = u.blocks
        if u.spans_processes:
            if os.environ.get("HEAT2D_FORBID_GATHER"):
                raise RuntimeError(
                    "cross-process allgather reached under "
                    "HEAT2D_FORBID_GATHER (test tripwire): this flow was "
                    "expected to stay per-shard/device-resident")
            gx, gy = u.mesh.shape
            flat = gather_slots(u.mesh, u.tensors(),
                                torch.zeros(u.block_shape))
            blocks = [flat[i * gy:(i + 1) * gy] for i in range(gx)]
        return np.block([[b.detach().cpu().numpy() for b in row]
                         for row in blocks])
    if hasattr(u, "detach"):
        return u.detach().cpu().numpy()
    return np.asarray(u)


def gather_slots(mesh, mine: list, like: torch.Tensor) -> list:
    """One tensor per slot of ``mesh`` (row-major), gathered to every
    process on the host: ``mine`` are this process's, in slot order, all
    shaped and typed as ``like``. A collective."""
    gx, gy = mesh.shape
    owners = [mesh.owner(i, j) for i in range(gx) for j in range(gy)]
    counts = [owners.count(p) for p in range(process_count())]
    rows = (torch.stack([t.detach().cpu() for t in mine]) if mine
            else like.cpu()[None][:0])
    got = [list(r) for r in all_gather_rows(rows, counts)]
    return [got[p].pop(0) for p in owners]
