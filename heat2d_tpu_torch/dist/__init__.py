"""The multi-process runtime of the port: N processes, one logical mesh.
The counterpart of ``heat2d_tpu/dist/``.

Layers (each a module, each usable on its own):

- ``runtime``: bring-up over ``torch.distributed`` (the ``TCPStore`` at
  the coordinator and a gloo group), the ``DistWorld`` topology object,
  store-backed bounded barriers and heartbeats that turn a dead peer
  into a named ``HostLostError`` instead of a hang;
- ``exchange``: the host-mediated halo route, per-process row slabs with
  T-deep halos over the store, bitwise equal to the one-process program;
- ``mesh``: the host-major slot order of a world and the seam profile
  the scheduler prices;
- ``topology``: the failure-domain bridge: a host loss is that process's
  death AND its slots quarantined, in one seq-fenced transaction over
  ``mesh/health.py``;
- ``harness``: the spawn/rendezvous/collect harness of the tests and the
  launcher legs;
- ``cli``: ``heat2d-tpu-torch-dist``, the worker and the ``--selftest``
  and ``--soak --kill-host`` legs.

The sharded solver modes across processes (the mesh, the strip
exchange between ranks, the residual in shard order) live in
``parallel/``; see ``parallel/multihost.py``.
"""

from heat2d_tpu_torch.dist.runtime import (     # noqa: F401
    DistWorld, Heartbeat, HostLostError, KVBarrier, bring_up,
    elect_recovery_owner, kv_client)
from heat2d_tpu_torch.dist.exchange import (    # noqa: F401
    DcnHaloExchanger, run_process_slab, slab_split)
from heat2d_tpu_torch.dist.topology import (    # noqa: F401
    FailureDomainBridge, PodTopology, pod_monitor)
