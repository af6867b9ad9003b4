"""Numerics: initial condition, golden stencil, stability box, and the
hand-written CUDA kernels with their plain PyTorch versions."""
