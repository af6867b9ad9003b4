"""Numerics: initial condition, golden stencil, stability bounds, the
tridiagonal (ADI) and multigrid solves, the analytic oracle, and the
hand-written CUDA kernels with their plain PyTorch versions."""
