"""The telemetry facade threaded through coordinator, planner, backends,
the token pipeline and the train step.

:class:`Telemetry` bundles the three observability primitives — an
injectable :class:`~repro_torch.obs.clock.Clock`, a
:class:`~repro_torch.obs.trace.Tracer`, and a
:class:`~repro_torch.obs.metrics.MetricsRegistry` — behind one object that
is built once and handed to every layer that records into it; each
holder reads ``telemetry.tracer`` and ``telemetry.registry`` when it
records, so one made off can be switched on (:meth:`Telemetry.start`)
for a few steps and off again (:meth:`Telemetry.stop`).
``telemetry="off"`` (the seed-parity default) yields
:data:`NULL_TELEMETRY`: the no-op tracer and registry, so instrumented
call sites cost a method call and nothing else.

Counters of device values (:meth:`Telemetry.count` with a tensor) stay on
the device while recording and are read into the registry once, by
:meth:`Telemetry.stop`.

:class:`EventChannel` is the typed replacement for the coordinator's
ad-hoc ``_pending_exec`` dict (the replication/failover drain
channel): policy rounds *post* counter deltas keyed by summary-counter
name, and the next executed query *drains* them into its
``ExecutedQuery`` fields; ``workload_summary`` surfaces anything still
pending after the last query, so no posted event is lost.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, List, NamedTuple, Union

from repro_torch.obs.clock import Clock, MONOTONIC, as_clock
from repro_torch.obs.metrics import MetricsRegistry, NULL_REGISTRY
from repro_torch.obs.trace import NullTracer, Tracer, NULL_TRACER

__all__ = ["Telemetry", "Recording", "EventChannel", "NULL_TELEMETRY",
           "make_telemetry"]


class Recording(NamedTuple):
    """What a :class:`Telemetry` recorded between ``start()`` and
    ``stop()``: its tracer's spans and its registry's instruments."""
    tracer: Tracer
    registry: MetricsRegistry


class Telemetry:
    """One shared bundle of clock + tracer + registry.

    ``mode`` is ``"on"`` or ``"off"``; off mode swaps in the shared
    no-op tracer/registry while keeping the (real or injected) clock, so
    phase timings in reports stay seed-identical either way."""

    def __init__(self, mode: str = "on",
                 clock: Union[Clock, Callable[[], float], None] = None,
                 pid: int = 0):
        if mode not in ("on", "off"):
            raise ValueError(f"telemetry mode must be 'on' or 'off', "
                             f"got {mode!r}")
        self.clock = as_clock(clock)
        self.pid = pid
        self._device: Dict[str, List[object]] = {}
        self._local = threading.local()
        self.mode = "off"
        self.tracer: Union[Tracer, NullTracer] = NULL_TRACER
        self.registry: MetricsRegistry = NULL_REGISTRY
        if mode == "on":
            self.start()

    @property
    def enabled(self) -> bool:
        """Whether spans/metrics are actually recorded (``mode == "on"``)."""
        return self.mode == "on"

    def start(self) -> None:
        """Record from now on, into a fresh tracer and registry."""
        if self.enabled:
            raise RuntimeError("telemetry is already recording")
        self.tracer = Tracer(clock=self.clock, pid=self.pid)
        self.registry = MetricsRegistry()
        self.mode = "on"

    def stop(self) -> Recording:
        """Stop recording: the device counters are read into the
        registry (one host read each), the no-op tracer and registry
        swapped back in, and what was recorded returned."""
        if not self.enabled:
            raise RuntimeError("telemetry is not recording")
        if self._device:
            import torch
            for name, values in self._device.items():
                self.registry.counter(name).inc(
                    torch.stack(values).sum().item())
            self._device = {}
        out = Recording(self.tracer, self.registry)
        self.mode = "off"
        self.tracer, self.registry = NULL_TRACER, NULL_REGISTRY
        return out

    @property
    def counting(self) -> bool:
        """Whether a counter counts here and now: recording, and the
        calling thread not inside :meth:`recompute`."""
        return self.enabled and not getattr(self._local, "recompute", False)

    @contextlib.contextmanager
    def recompute(self) -> Iterator[None]:
        """Marks the calling thread as re-running work already counted
        (activation checkpointing's recompute in the backward pass)."""
        self._local.recompute = True
        try:
            yield
        finally:
            self._local.recompute = False

    def count(self, name: str, value) -> None:
        """Add ``value`` to the registry counter ``name`` while
        :attr:`counting`: a number at once, a tensor (on any device) at
        :meth:`stop`, with no host read before."""
        if not self.counting:
            return
        if isinstance(value, (int, float)):
            self.registry.counter(name).inc(value)
        else:
            self._device.setdefault(name, []).append(value.detach())

    def export_trace(self, path: str) -> str:
        """Write the tracer's Chrome trace JSON to ``path`` (see
        :meth:`repro_torch.obs.trace.Tracer.export`); returns ``path``."""
        return self.tracer.export(path)


class _OffTelemetry(Telemetry):
    """The shared telemetry-off singleton behind ``telemetry="off"``: it
    never records."""

    def __init__(self) -> None:
        super().__init__(mode="off", clock=MONOTONIC)

    def start(self) -> None:
        """Refused: every holder of the shared bundle would record."""
        raise RuntimeError("NULL_TELEMETRY is shared and cannot start; "
                           "hand in a Telemetry(mode=\"off\") instead")


#: Shared telemetry-off bundle (no-op tracer + registry, real clock).
NULL_TELEMETRY = _OffTelemetry()


def make_telemetry(
        spec: Union[str, Telemetry, None]) -> Telemetry:
    """Normalize a user-facing ``telemetry=`` knob: ``"off"``/``None`` ->
    :data:`NULL_TELEMETRY`, ``"on"`` -> a fresh live :class:`Telemetry`,
    an existing :class:`Telemetry` passes through unchanged."""
    if spec is None or spec == "off":
        return NULL_TELEMETRY
    if isinstance(spec, Telemetry):
        return spec
    if spec == "on":
        return Telemetry(mode="on")
    raise ValueError(f"telemetry must be 'on', 'off', or a Telemetry "
                     f"instance, got {spec!r}")


class EventChannel:
    """Pending counter deltas between policy rounds and executed queries.

    Policy rounds (replication, failover recovery) happen between
    queries, but their counters belong on ``ExecutedQuery`` records.
    The channel buffers them: :meth:`post` accumulates a delta under a
    summary-counter name, :meth:`drain` hands the buffered dict to the
    next executed query and empties the channel."""

    def __init__(self) -> None:
        self._pending: Dict[str, float] = {}

    def post(self, key: str, value: float = 1) -> None:
        """Buffer ``value`` under ``key`` (accumulating with any pending
        delta for the same key)."""
        self._pending[key] = self._pending.get(key, 0) + value

    def drain(self) -> Dict[str, float]:
        """All pending deltas, emptying the channel."""
        out = self._pending
        self._pending = {}
        return out

    def peek(self) -> Dict[str, float]:
        """A copy of the pending deltas without draining them."""
        return dict(self._pending)

    def empty(self) -> bool:
        """Whether nothing is pending."""
        return not self._pending
