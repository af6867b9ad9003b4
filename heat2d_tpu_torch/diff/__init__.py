"""Differentiable solves and inverse problems on PyTorch/CUDA: the port
of ``heat2d_tpu/diff/``.

- ``adjoint`` - the differentiable solve, a ``torch.autograd.Function``
                over the fused multi-step primal (the band route through
                H6 ``ens_tile_multi``) with a checkpointed-segment
                adjoint (O(T/K + K) memory) or a full-storage one (O(T));
                constant (cx, cy) and per-cell (kx, ky) coefficients;
- ``inverse`` - recovery of an initial condition or a per-cell
                diffusivity field from sparse observations: Adam on the
                differentiable solve, the stability-box projection, the
                per-iteration ``inverse_*`` metric series;
- ``serving`` - ``InverseRequest``/``InverseResult``/``InverseEngine``:
                optimization loops served by ``serve.SolveServer`` on its
                inverse lane (content-hashed like ``SolveRequest``, with
                the JAX package's hash);
- ``cli``     - ``heat2d-tpu-torch-inverse`` (``--selftest`` recovers a
                known synthetic field through a running server).

Importing this package changes nothing that the forward solver or the
serve engine runs or counts (``tests/test_torch_diff.py``).
"""

from heat2d_tpu_torch.diff.adjoint import (DiffSpec, make_diff_solve,
                                           segment_schedule)
from heat2d_tpu_torch.diff.inverse import (InverseProblem, InverseSolution,
                                           adam_minimize, observation_mask,
                                           synthetic_diffusivity,
                                           unit_reference_init)
from heat2d_tpu_torch.diff.serving import (InverseEngine, InverseRequest,
                                           InverseResult)
from heat2d_tpu_torch.diff.vocab import ADJOINTS, COEFFS, METHODS, TARGETS

__all__ = [
    "ADJOINTS",
    "COEFFS",
    "METHODS",
    "TARGETS",
    "DiffSpec",
    "InverseEngine",
    "InverseProblem",
    "InverseRequest",
    "InverseResult",
    "InverseSolution",
    "adam_minimize",
    "make_diff_solve",
    "observation_mask",
    "segment_schedule",
    "synthetic_diffusivity",
    "unit_reference_init",
]
