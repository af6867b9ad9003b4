"""Resilience of the serving path: injected launch faults (``chaos``),
retry with backoff, the launch watchdog and the degraded-mode breaker
(``retry``)."""
