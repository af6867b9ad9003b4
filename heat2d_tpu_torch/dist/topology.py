"""Failure-domain unification: one host loss, one coordinated move. The
port of ``heat2d_tpu/dist/topology.py``.

The fleet answers PROCESS death (restart the worker), the mesh health
monitor answers DEVICE failure (quarantine, shrink, requeue). A lost
HOST is both at once: its process dies AND every slot it owned vanishes
from the global mesh. Handling the halves apart races: a mesh launch
could pick the dead host's slots after the process was declared gone.

``FailureDomainBridge.on_host_lost`` makes it ONE transaction under the
seq-fence discipline of ``mesh/health.py`` and ``mesh/degrade.py``:

1. capture the monitor's event ordinal,
2. quarantine every slot of the lost host (reason ``host_lost``),
3. run the failover action (resume from the last committed checkpoint
   on the shrunken world) while the fence already covers the
   quarantines,
4. append the transaction row.

Any launch fenced AFTER the transaction sees only survivor slots, so
``serving_invariant`` proves the combined move as it proves a one-host
quarantine: the check the host-kill soak (``dist/cli.py --soak
--kill-host``) runs end to end.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from heat2d_tpu_torch.dist.runtime import DistWorld


class PodTopology:
    """host -> global slot ordinals. Built from a live ``DistWorld``
    (hosts are processes) or from an injected map for simulation; the
    bridge never cares which."""

    def __init__(self, device_host: Dict[int, int]):
        self.device_host = dict(device_host)
        if not self.device_host:
            raise ValueError("topology needs at least one device")

    @classmethod
    def from_world(cls, world: DistWorld) -> "PodTopology":
        return cls({g: p for g, p in enumerate(world.device_process)})

    @property
    def n_devices(self) -> int:
        return len(self.device_host)

    @property
    def hosts(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.device_host.values())))

    def devices_of(self, host: int) -> Tuple[int, ...]:
        return tuple(sorted(g for g, h in self.device_host.items()
                            if h == host))

    def host_of(self, device: int) -> int:
        return self.device_host[device]


def pod_monitor(n_devices: int, *, registry=None,
                clock: Callable[[], float] = time.monotonic):
    """A ``HealthMonitor`` whose slot space is the WORLD's ordinals, not
    this process's. The monitor is index-based (quarantine, survivors and
    seq never touch a tensor); its slots carry CPU labels because only
    ``probe()`` would use a device, and the bridge never probes a dead
    host."""
    import torch

    from heat2d_tpu_torch.mesh.health import HealthMonitor
    return HealthMonitor(registry=registry, clock=clock,
                         devices=[torch.device("cpu")] * int(n_devices))


class FailureDomainBridge:
    """The one place a host loss turns into mesh state (module
    docstring). ``monitor`` is a ``mesh.health.HealthMonitor`` that spans
    the WORLD's slots, or the bridge would convict slots it cannot
    name."""

    def __init__(self, topology: PodTopology, monitor, *,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if monitor.n_devices < topology.n_devices:
            raise ValueError(
                f"monitor spans {monitor.n_devices} devices but the "
                f"pod has {topology.n_devices}: quarantines would "
                "fall outside the book")
        self.topology = topology
        self.monitor = monitor
        self.registry = registry
        self.clock = clock
        #: every coordinated shrink+failover, in order: the run record's
        #: ``transactions`` block
        self.transactions: list = []

    def on_host_lost(self, host: int, *,
                     failover: Optional[Callable[[], dict]] = None
                     ) -> dict:
        """The coordinated move: quarantine the host's slots, run the
        failover action, return the transaction row. Idempotent per slot
        (re-reporting a lost host re-quarantines nothing); the failover
        still runs, since a second report may carry a fresher
        checkpoint."""
        t0 = self.clock()
        seq_before = self.monitor.seq()
        devices = self.topology.devices_of(host)
        convicted = [d for d in devices
                     if self.monitor.quarantine(d, "host_lost")]
        # the fence every post-loss launch carries: it covers the
        # quarantines above, so serving_invariant proves no launch fenced
        # here or later touched the dead host's slots
        fence = self.monitor.seq()
        result = failover() if failover is not None else None
        row = {
            "host": int(host),
            "devices": list(devices),
            "quarantined": convicted,
            "seq_before": seq_before,
            "health_seq": fence,
            "survivors": list(self.monitor.survivors()),
            "failover": result,
            "recovery_s": self.clock() - t0,
        }
        self.transactions.append(row)
        if self.registry is not None:
            self.registry.counter("dist_host_lost_total")
            self.registry.observe("dist_host_recovery_s",
                                  row["recovery_s"])
        return row

    def snapshot(self) -> dict:
        """Run-record block: topology, monitor and transactions."""
        return {
            "hosts": list(self.topology.hosts),
            "n_devices": self.topology.n_devices,
            "monitor": self.monitor.snapshot(),
            "transactions": [dict(t) for t in self.transactions],
        }
