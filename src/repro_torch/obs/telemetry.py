"""The telemetry facade threaded through coordinator, planner, backends.

:class:`Telemetry` bundles the three observability primitives — an
injectable :class:`~repro_torch.obs.clock.Clock`, a
:class:`~repro_torch.obs.trace.Tracer`, and a
:class:`~repro_torch.obs.metrics.MetricsRegistry` — behind one object that
the cluster constructs once and every layer shares.  ``telemetry="off"``
(the seed-parity default) yields :data:`NULL_TELEMETRY`: the no-op
tracer and registry, so instrumented call sites cost a method call and
nothing else.

:class:`EventChannel` is the typed replacement for the coordinator's
ad-hoc ``_pending_exec`` dict (the replication/failover drain
channel): policy rounds *post* counter deltas keyed by summary-counter
name, and the next executed query *drains* them into its
``ExecutedQuery`` fields.  The channel also mirrors every post into
``events.*`` registry counters (an unmarked emission group, so the
mirror never leaks into ``as_summary``), and ``workload_summary``
surfaces anything still pending after the last query, so no posted
event is lost.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

from repro_torch.obs.clock import Clock, MONOTONIC, as_clock
from repro_torch.obs.metrics import MetricsRegistry, NULL_REGISTRY
from repro_torch.obs.trace import NullTracer, Tracer, NULL_TRACER

__all__ = ["Telemetry", "EventChannel", "NULL_TELEMETRY", "make_telemetry"]


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
        self.mode = mode
        self.clock = as_clock(clock)
        if mode == "on":
            self.tracer: Union[Tracer, NullTracer] = Tracer(
                clock=self.clock, pid=pid)
            self.registry: MetricsRegistry = MetricsRegistry()
        else:
            self.tracer = NULL_TRACER
            self.registry = NULL_REGISTRY

    @property
    def enabled(self) -> bool:
        """Whether spans/metrics are actually recorded (``mode == "on"``)."""
        return self.mode == "on"

    def export_trace(self, path: str) -> str:
        """Write the tracer's Chrome trace JSON to ``path`` (see
        :meth:`repro_torch.obs.trace.Tracer.export`); returns ``path``."""
        import json
        with open(path, "w") as fh:
            json.dump(self.tracer.to_chrome_trace(), fh)
        return path


class _OffTelemetry(Telemetry):
    """The shared telemetry-off singleton behind ``telemetry="off"``."""

    def __init__(self) -> None:
        super().__init__(mode="off", clock=MONOTONIC)


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
    next executed query and empties the channel.  Every post is also
    mirrored into the registry as an ``events.<key>`` counter (group
    ``"events"`` — intentionally never marked, so mirrors stay out of
    ``as_summary`` and exist purely for live inspection)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._pending: Dict[str, float] = {}
        self._registry = registry if registry is not None else NULL_REGISTRY

    def post(self, key: str, value: float = 1) -> None:
        """Buffer ``value`` under ``key`` (accumulating with any pending
        delta for the same key) and mirror it to ``events.<key>``."""
        self._pending[key] = self._pending.get(key, 0) + value
        self._registry.counter(f"events.{key}", group="events").inc(value)

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
