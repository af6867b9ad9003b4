"""Run telemetry: the port's counterpart of ``heat2d_tpu/obs``.

- ``metrics``      process-local registry (counters, gauges, timing
                   histograms, labeled series) with JSONL and
                   Prometheus-text export and the aggregate over
                   processes;
- ``record``       the run-record schema every emitter shares;
- ``stream``       the residual trajectory and chunk progress of the
                   convergence loops (their own host reads, reported);
- ``roofline``     the card's peaks, the byte model of every route, the
                   bound, the launch-row stamp;
- ``trace_report`` ``heat2d-tpu-torch-prof``: a ``torch.profiler``
                   capture digested per hand kernel, category and idle
                   gap;
- ``tracing``      per-request spans across the serving stack and the
                   CLI (``HEAT2D_TRACE_DIR``), merged by
- ``trace_cli``    ``heat2d-tpu-torch-trace``;
- ``flight``       the crash flight recorder (``HEAT2D_FLIGHT_DIR``);
- ``slo``          per-signature latency and error-budget objectives;
- ``perf``, ``perf_cli``  cost cards, duty cycle, anomaly sentinel;
                   ``heat2d-tpu-torch-perf``.

Schemas, file names, metric names and environment variables are the JAX
package's, so either package's tools read the other's files.
"""

from heat2d_tpu_torch.obs import flight, slo, tracing
from heat2d_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from heat2d_tpu_torch.obs.record import (RECORD_KINDS, RECORD_SCHEMA,
                                         attach_context, build_record)
from heat2d_tpu_torch.obs.stream import TelemetryStream, flush_taps

__all__ = ["MetricsRegistry", "get_registry", "TelemetryStream",
           "flush_taps", "RECORD_KINDS", "RECORD_SCHEMA",
           "attach_context", "build_record", "tracing", "flight", "slo"]
