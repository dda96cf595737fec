"""Injectable time sources: the ONE clock surface for the repo.

Every timing-sensitive component (the :class:`~repro_torch.obs.trace.Tracer`,
the coordinator's phase timers, :class:`repro_torch.core.result_cache.
ResultCache` TTL expiry) reads time through a :class:`Clock` rather than
calling ``time.monotonic()`` / ``time.perf_counter()`` directly, so
tests can substitute a :class:`ManualClock` and make wall-clock
observables deterministic (zero, or exactly the scripted increments).

``MONOTONIC`` is the shared production default — a
:class:`MonotonicClock` over ``time.perf_counter`` (monotonic, highest
available resolution). :func:`as_clock` adapts bare ``() -> float``
callables (the seed-era ``ResultCache(clock=...)`` shape) onto the
protocol, so existing callers keep working unchanged.
"""
from __future__ import annotations

import time
from typing import Callable, Protocol, Union, runtime_checkable

__all__ = ["Clock", "MonotonicClock", "ManualClock", "MONOTONIC",
           "as_clock"]


@runtime_checkable
class Clock(Protocol):
    """A monotonic time source: ``now()`` returns seconds as a float.

    Only differences of ``now()`` values are meaningful (the epoch is
    arbitrary), exactly like ``time.monotonic``."""

    def now(self) -> float:
        """Current monotonic time in (fractional) seconds."""
        ...


class MonotonicClock:
    """The production clock: ``time.perf_counter`` behind the protocol."""

    def now(self) -> float:
        """Current ``time.perf_counter()`` reading."""
        return time.perf_counter()


class ManualClock:
    """A scripted clock for deterministic tests: time advances only via
    :meth:`advance` (or the per-read ``auto_step``), never on its own."""

    def __init__(self, start: float = 0.0, auto_step: float = 0.0):
        self._t = float(start)
        self.auto_step = float(auto_step)

    def now(self) -> float:
        """Current scripted time; advances by ``auto_step`` per read."""
        t = self._t
        self._t += self.auto_step
        return t

    def advance(self, dt: float) -> None:
        """Move the clock forward by ``dt`` seconds (must be >= 0)."""
        if dt < 0:
            raise ValueError(f"clocks are monotonic; cannot advance by {dt}")
        self._t += dt


class _CallableClock:
    """Adapter wrapping a bare ``() -> float`` callable (seed-era
    ``ResultCache(clock=...)`` signatures) onto the :class:`Clock`
    protocol."""

    def __init__(self, fn: Callable[[], float]):
        self._fn = fn

    def now(self) -> float:
        """The wrapped callable's current reading."""
        return float(self._fn())


#: Shared production clock instance (stateless — safe to share).
MONOTONIC = MonotonicClock()


def as_clock(clock: Union[Clock, Callable[[], float], None]) -> Clock:
    """Normalize a clock argument: ``None`` -> :data:`MONOTONIC`,
    :class:`Clock` implementations pass through, bare callables are
    wrapped. Anything else raises ``TypeError``."""
    if clock is None:
        return MONOTONIC
    if isinstance(clock, Clock):
        return clock
    if callable(clock):
        return _CallableClock(clock)
    raise TypeError(f"not a clock or callable: {clock!r}")
