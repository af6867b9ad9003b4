"""Fault injection at the serve engine's launch point: the port's copy of
the launch part of ``heat2d_tpu/resil/chaos.py``.

- **fail N launches**: ``HEAT2D_CHAOS_FAIL_LAUNCHES=N`` makes the first N
  launches raise ``ChaosError`` (a transient the retry policy must
  absorb);
- **inject latency**: ``HEAT2D_CHAOS_LAUNCH_LATENCY_S`` sleeps inside
  each launch (drives the watchdog deadline).

A campaign comes from the environment, or from ``install()`` in a test.
Parsing is strict: a value that does not parse raises ``ValueError``
naming the variable, since a campaign that silently does nothing lets the
test it drives pass for nothing. Unset, empty and ``0`` mean off. When
nothing is armed, ``launch_point`` is a flag test and a return.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock

_ENV_PREFIX = "HEAT2D_CHAOS_"


class ChaosError(RuntimeError):
    """An injected transient failure (``resil.retry`` retries it, like
    the real launch failures it stands in for)."""


@dataclasses.dataclass
class ChaosConfig:
    fail_launches: int = 0          # the first N launches raise
    launch_latency_s: float = 0.0   # sleep inside every launch

    @classmethod
    def from_env(cls, env=os.environ) -> Optional["ChaosConfig"]:
        """A config if any launch variable is armed, else None."""
        def get(name, cast, default):
            v = env.get(_ENV_PREFIX + name)
            if v in (None, ""):
                return default
            try:
                return cast(v)
            except ValueError:
                raise ValueError(
                    f"{_ENV_PREFIX}{name}={v!r} is not a valid "
                    f"{cast.__name__}: refusing to run a chaos campaign "
                    f"that silently does nothing") from None

        cfg = cls(fail_launches=get("FAIL_LAUNCHES", int, 0),
                  launch_latency_s=get("LAUNCH_LATENCY_S", float, 0.0))
        return cfg if cfg.any_active() else None

    def any_active(self) -> bool:
        return bool(self.fail_launches or self.launch_latency_s)


class _Controller:
    """The active campaign and its counters (thread-safe: launches run on
    the scheduler thread, tests read from theirs)."""

    def __init__(self, config: ChaosConfig, registry=None):
        self.config = config
        self.registry = registry
        self._lock = AuditedLock("resil.chaos.controller")
        self.launch_count = 0
        self.launches_failed = 0

    def _count(self, point: str) -> None:
        if self.registry is not None:
            self.registry.counter("resil_chaos_injected_total",
                                  point=point)

    def launch_point(self) -> None:
        cfg = self.config
        with self._lock:
            self.launch_count += 1
            fail = self.launches_failed < cfg.fail_launches
            if fail:
                self.launches_failed += 1
                n = self.launches_failed
        if cfg.launch_latency_s:
            self._count("launch_latency")
            time.sleep(cfg.launch_latency_s)
        if fail:
            self._count("launch_failure")
            raise ChaosError(
                f"injected launch failure {n}/{cfg.fail_launches}")


_lock = AuditedLock("resil.chaos")
_controller: Optional[_Controller] = None
_enabled = False        # False == launch_point is a no-op
_env_checked = False


def install(config: Optional[ChaosConfig], registry=None) -> None:
    """Activate a campaign (tests); ``None`` disarms."""
    global _controller, _enabled, _env_checked
    with _lock:
        _env_checked = True
        if config is None or not config.any_active():
            _controller, _enabled = None, False
        else:
            _controller = _Controller(config, registry=registry)
            _enabled = True


def uninstall() -> None:
    """Disarm; the environment is read again at the next hook."""
    global _controller, _enabled, _env_checked
    with _lock:
        _controller, _enabled, _env_checked = None, False, False


def controller() -> Optional[_Controller]:
    """The active controller, loading HEAT2D_CHAOS_* on first use."""
    global _controller, _enabled, _env_checked
    if not _env_checked:
        with _lock:
            if not _env_checked:
                cfg = ChaosConfig.from_env()
                if cfg is not None:
                    _controller = _Controller(cfg)
                    _enabled = True
                _env_checked = True
    return _controller


def launch_point() -> None:
    """Called by the serve engine before each ensemble launch."""
    if not _enabled and _env_checked:
        return
    c = controller()
    if c is not None:
        c.launch_point()
