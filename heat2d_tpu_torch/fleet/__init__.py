"""Fleet subsystem: supervised multi-worker serving with chaos-proven
failover. The port's copy of ``heat2d_tpu/fleet``.

- ``worker``     one ``SolveServer`` on the card (``--device cuda``, the
                 default) or the CPU behind a JSONL stdio wire,
                 heartbeating, chaos-injectable, drain-on-shutdown.
- ``supervisor`` spawn/watch/fence/restart N workers: death on process
                 exit OR heartbeat age, fence before failover,
                 full-jittered restart backoff.
- ``router``     ``FleetServer``: rendezvous routing by signature,
                 in-flight replay to survivors under fresh wire ids, a
                 shared cross-worker result cache and single-flight,
                 per-tenant quotas with the priority watermark, and the
                 degraded-mode breaker fed by worker deaths.
- ``wire``       the JSONL protocol, line for line the JAX package's.
- ``cli``        ``heat2d-tpu-torch-fleet``: the chaos soak (kill k of N
                 mid-load; every answer bitwise the one-process
                 ``SolveServer``'s, nothing lost, throughput recovered,
                 clean exit).

Workers run the serving stack a standalone ``SolveServer`` runs (on the
card: H5 and H6 through ``serve/engine.py``), so fleet answers are
bitwise the one-process answers. N workers on one card are N CUDA
contexts sharing it.
"""

from heat2d_tpu_torch.fleet.router import (FleetServer, TenantPolicy,
                                           route_signature)
from heat2d_tpu_torch.fleet.supervisor import Supervisor, WorkerGone

__all__ = ["FleetServer", "Supervisor", "TenantPolicy", "WorkerGone",
           "route_signature"]
