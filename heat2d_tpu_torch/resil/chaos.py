"""Fault injection at the serve engines' launch points: the port's copy of
the launch and mesh parts of ``heat2d_tpu/resil/chaos.py``.

- **fail N launches**: ``HEAT2D_CHAOS_FAIL_LAUNCHES=N`` makes the first N
  launches raise ``ChaosError`` (a transient the retry policy must
  absorb);
- **inject latency**: ``HEAT2D_CHAOS_LAUNCH_LATENCY_S`` sleeps inside
  each launch (drives the watchdog deadline);
- **kill a device in a live mesh**: ``HEAT2D_CHAOS_DEVICE_FAIL_AT=N``
  raises ``DeviceLostError`` at the Nth mesh launch attempt (1-based,
  requeues counted) and leaves slot ``HEAT2D_CHAOS_DEVICE_FAIL_INDEX``
  (default 0) dead for every later health probe;
- **hang a collective**: ``HEAT2D_CHAOS_HANG_COLLECTIVE=N`` stalls the
  Nth mesh launch attempt on the host for
  ``HEAT2D_CHAOS_HANG_COLLECTIVE_S`` seconds (default 2.0, so the
  abandoned launch thread frees itself) and marks the
  ``DEVICE_FAIL_INDEX`` slot dead for probes: the gray failure only the
  stall watchdog (``mesh/health.py``) can bound;
- **flip a bit**: ``HEAT2D_CHAOS_FLIP_BIT=N`` tells the mesh engine to
  XOR a high exponent bit into the Nth launch attempt's host result
  buffer (member 0, grid centre) before it is verified or served; the
  ABFT tier (``ops/abft.py``) must catch it. The engine applies the flip;
  this module only answers "which launch".

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


class DeviceLostError(ChaosError):
    """An injected device failure inside a mesh launch, the stand-in for
    the accelerator error a dead card raises. Carries the slot index that
    died, so the mesh engine can quarantine it without a probe sweep."""

    def __init__(self, device_index: int, message: str):
        super().__init__(message)
        self.device_index = device_index


@dataclasses.dataclass
class ChaosConfig:
    fail_launches: int = 0          # the first N launches raise
    launch_latency_s: float = 0.0   # sleep inside every launch
    device_fail_at: Optional[int] = None    # 1-based mesh launch
    device_fail_index: int = 0              # which slot dies or hangs
    hang_collective: Optional[int] = None   # 1-based mesh launch
    hang_collective_s: float = 2.0          # bounded hang duration
    flip_bit: Optional[int] = None          # 1-based mesh launch

    def __post_init__(self):
        # Ordinals are 1-based: 0 can never fire, so it means off.
        for f in ("device_fail_at", "hang_collective", "flip_bit"):
            if getattr(self, f) == 0:
                setattr(self, f, None)

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
                  launch_latency_s=get("LAUNCH_LATENCY_S", float, 0.0),
                  device_fail_at=get("DEVICE_FAIL_AT", int, None),
                  device_fail_index=get("DEVICE_FAIL_INDEX", int, 0),
                  hang_collective=get("HANG_COLLECTIVE", int, None),
                  hang_collective_s=get("HANG_COLLECTIVE_S", float, 2.0),
                  flip_bit=get("FLIP_BIT", int, None))
        return cfg if cfg.any_active() else None

    def any_active(self) -> bool:
        return bool(self.fail_launches or self.launch_latency_s
                    or self.device_fail_at is not None
                    or self.hang_collective is not None
                    or self.flip_bit is not None)


class _Controller:
    """The active campaign and its counters (thread-safe: launches run on
    the scheduler thread, tests read from theirs)."""

    def __init__(self, config: ChaosConfig, registry=None):
        self.config = config
        self.registry = registry
        self._lock = AuditedLock("resil.chaos.controller")
        self.launch_count = 0
        self.launches_failed = 0
        self.mesh_launches = 0          # mesh launch attempts
        self.dead_devices: set = set()  # failed or hung slot indices

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

    def mesh_launch_point(self) -> None:
        """At each mesh launch attempt: a hang blocks here for
        ``hang_collective_s``; a device failure raises
        ``DeviceLostError``. Either leaves the slot dead for probes."""
        cfg = self.config
        with self._lock:
            self.mesh_launches += 1
            n = self.mesh_launches
        if cfg.hang_collective is not None and n == cfg.hang_collective:
            with self._lock:
                self.dead_devices.add(cfg.device_fail_index)
            self._count("hang_collective")
            time.sleep(cfg.hang_collective_s)
        if cfg.device_fail_at is not None and n == cfg.device_fail_at:
            with self._lock:
                self.dead_devices.add(cfg.device_fail_index)
            self._count("device_fail")
            raise DeviceLostError(
                cfg.device_fail_index,
                f"injected device {cfg.device_fail_index} failure at "
                f"mesh launch {n}")

    def device_probe_point(self, index: int) -> bool:
        """False once the slot died (``device_fail_at`` or
        ``hang_collective``); it stays dead."""
        with self._lock:
            return index not in self.dead_devices

    def flip_bit_point(self) -> Optional[int]:
        """The exponent bit to XOR into this mesh launch attempt's host
        result (None = healthy); called after ``mesh_launch_point``."""
        cfg = self.config
        if cfg.flip_bit is None:
            return None
        with self._lock:
            armed = self.mesh_launches == cfg.flip_bit
        if not armed:
            return None
        self._count("flip_bit")
        return 30    # a high exponent bit: O(|u|)-or-worse corruption


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


def mesh_launch_point() -> None:
    """Called by the mesh engine at each launch attempt."""
    if not _enabled and _env_checked:
        return
    c = controller()
    if c is not None:
        c.mesh_launch_point()


def device_probe_point(index: int) -> bool:
    """Called by the mesh health probes; False = the slot is dead."""
    if not _enabled and _env_checked:
        return True
    c = controller()
    if c is None:
        return True
    return c.device_probe_point(index)


def flip_bit_point() -> Optional[int]:
    """The bit to flip in the current mesh launch's host result, or
    None."""
    if not _enabled and _env_checked:
        return None
    c = controller()
    if c is None:
        return None
    return c.flip_bit_point()
