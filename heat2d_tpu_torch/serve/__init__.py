"""Solve serving on the port: the counterpart of ``heat2d_tpu/serve/``.

- ``schema``  - ``SolveRequest``/``SolveResult``, the content hash (cache
                and single-flight key) and signature (batching key),
                byte-identical to the JAX package's, and ``Rejected``;
- ``cache``   - bounded content-addressed LRU + single-flight;
- ``batcher`` - admission queue, signature-bucketed micro-batching,
                queue-depth shedding, per-request timeouts;
- ``engine``  - bucket -> one ensemble launch on the card through the
                per-signature runner (``models.ensemble.batch_runner``),
                the member axis padded to power-of-two capacities;
- ``server``  - ``SolveServer`` composing the above with retry, watchdog
                and breaker, and the synchronous ``Client``;
- ``cli``     - ``heat2d-tpu-torch-serve`` (``--selftest``,
                ``--requests``).
"""

from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest, SolveResult
from heat2d_tpu_torch.serve.server import Client, SolveServer

__all__ = ["Rejected", "SolveRequest", "SolveResult", "Client",
           "SolveServer"]
