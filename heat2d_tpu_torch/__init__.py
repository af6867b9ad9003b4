"""heat2d-tpu on PyTorch and CUDA: the port of the JAX package
``heat2d_tpu`` to an NVIDIA H100.

This package imports ``torch`` and ``numpy``, never ``jax`` or anything
of ``heat2d_tpu``. Its entry points (``models.solver.Heat2DSolver``,
``cli.main``, ``ops.cuda_stencil.make_single_chip_runner``, the ensemble
runs of ``models.ensemble`` for every problem family and the implicit
methods, ``models.solution.time_to_solution``, ``serve.SolveServer`` and
``serve.cli.main``) run on the card unless the caller asks for the CPU
with ``device="cpu"``.
"""
