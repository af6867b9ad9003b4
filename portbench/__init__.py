"""The benchmark of ``heat2d_tpu_torch`` on NVIDIA H100 cards: one cell
run once by ``run.py``; see ``README.md``."""
