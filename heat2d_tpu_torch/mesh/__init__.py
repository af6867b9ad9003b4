"""Mesh serving: the port of ``heat2d_tpu/mesh``. A mesh is a list of
device slots (``parallel.mesh``): the visible cards, or n slots that
share fewer cards (``host_devices(n)``).

- ``runner``     the mesh batch runner: the padded member axis split
                 over the slots, each running the single-device route;
- ``scheduler``  the batch-vs-spatial split per signature, and
                 ``MeshAdmission`` (shedding on modeled saturation);
- ``engine``     ``MeshEnsembleEngine``: the batch route, the spatial
                 route (the halo plan stamped ``compiled: True``), the
                 single-device fallback with ``mesh_fallback_total``;
- ``bench``      serve-side strong scaling with bitwise parity
                 (``heat2d-tpu-torch-mesh``);
- ``health``     probes, the quarantine book, the stall watchdog;
- ``degrade``    shrink-and-requeue, the ABFT verify tier's policy and
                 the no-quarantined-serving invariant;
- ``chaos_gate`` device loss, bit flip and hung launch, each recovered
                 bitwise through a live server.
"""

from heat2d_tpu_torch.mesh.degrade import FaultPolicy, MeshDegrader
from heat2d_tpu_torch.mesh.engine import MeshEnsembleEngine
from heat2d_tpu_torch.mesh.health import HealthMonitor, MeshStallError
from heat2d_tpu_torch.mesh.runner import mesh_batch_runner, mesh_capacity
from heat2d_tpu_torch.mesh.scheduler import MeshAdmission, MeshScheduler

__all__ = ["FaultPolicy", "HealthMonitor", "MeshAdmission",
           "MeshDegrader", "MeshEnsembleEngine", "MeshScheduler",
           "MeshStallError", "mesh_batch_runner", "mesh_capacity"]
