"""Measurement (and, later, autotuning) of the port: ``measure`` holds the
two-point marginal step-time protocol that ``bench_torch.py`` and the
headline of ``chip_smoke.py`` time with."""
