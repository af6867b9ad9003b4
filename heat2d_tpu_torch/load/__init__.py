"""Load-generation + capacity-modeling subsystem. The port's copy of
``heat2d_tpu/load`` (docs/LOADGEN.md describes both):

- ``schedule`` — the ``Arrival``/``Schedule`` traffic shape both
                 producers emit and the runner consumes; fingerprints
                 equal to the JAX package's for the same arrivals.
- ``replay``   — recorded span timelines (``spans-*.jsonl`` of either
                 package's tracer) parsed back into the arrival process
                 production saw.
- ``synth``    — seeded deterministic workload generators: zipf
                 signature skew, MMPP bursts, diurnal envelopes,
                 tenant mixes, inverse heavy tails; named profiles.
- ``runner``   — open-loop execution against a live ``SolveServer``
                 or ``FleetServer`` on ``device`` (the card unless the
                 caller asks for the CPU) with fidelity + latency +
                 throughput measurement (``load_*`` families).
- ``capacity`` — the fitted capacity model: max sustainable req/s
                 per serving unit -> units needed for N req/s.
- ``gate``     — the committed-baseline serving-regression gate; the
                 card's baseline is ``baseline_h100.json``.
- ``cli``      — ``heat2d-tpu-torch-load``.
"""

from heat2d_tpu_torch.load.capacity import fit_capacity, units_for
from heat2d_tpu_torch.load.replay import schedule_from_trace_dir
from heat2d_tpu_torch.load.schedule import Arrival, Schedule
from heat2d_tpu_torch.load.synth import PROFILES, MixProfile, synthesize

__all__ = ["Arrival", "Schedule", "MixProfile", "PROFILES",
           "synthesize", "schedule_from_trace_dir", "fit_capacity",
           "units_for"]
