"""Typed metrics registry: counters, gauges, and fixed-bucket histograms.

The :class:`MetricsRegistry` is the single home for the repo's workload
counters: the per-query quantities that used to live strewn
across ``ExecutedQuery`` fields, ``coordinator.stats``, and mesh
``device_stats`` all accumulate here when telemetry is on, and
``repro_torch.backend.base.workload_summary`` is *implemented* on top of a
fresh registry — so registry totals and summary values agree bit for
bit by construction.

Instrument types:

  * :class:`Counter` — monotonically accumulating numbers (``inc``).
    Counters named exactly as ``workload_summary`` keys carry the
    summary's values; an optional *emission group* reproduces the
    summary's conditional keys (``measured_*`` only when a backend
    measured, ``mqo_*`` only when MQO engaged, ...): a grouped counter
    appears in :meth:`MetricsRegistry.as_summary` only once its group
    was marked via :meth:`MetricsRegistry.mark_group`.
  * :class:`Gauge` — last-written point-in-time values (``set``), with
    optional labels (e.g. ``gauge("cache.budget_utilization", node=3)``)
    for per-node series.
  * :class:`Histogram` — fixed bucket bounds chosen at creation;
    ``observe`` increments exactly one bucket (the first bound >= the
    observation, else the overflow bucket), so bucket counts always sum
    to the observation count (a hypothesis-checked invariant).

``NULL_REGISTRY`` is the telemetry-off no-op: every accessor returns a
shared do-nothing instrument, so instrumented call sites stay branch-free
and allocate nothing on the hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_REGISTRY", "DEFAULT_BUCKETS"]

#: Default histogram bucket upper bounds (powers of two — a generic
#: count-shaped distribution; pass explicit bounds for anything else).
DEFAULT_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass
class Counter:
    """A monotonically accumulating value. ``group`` ties the counter to
    an emission group for :meth:`MetricsRegistry.as_summary` (``None``
    = always emitted)."""

    name: str
    group: Optional[str] = None
    value: float = 0

    def inc(self, v: float = 1) -> None:
        """Accumulate ``v`` (negative increments are rejected — use a
        :class:`Gauge` for values that can go down)."""
        if v < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc by {v})")
        self.value += v


@dataclasses.dataclass
class Gauge:
    """A last-written point-in-time value, optionally labeled."""

    name: str
    labels: Tuple[Tuple[str, object], ...] = ()
    value: float = 0.0

    def set(self, v: float) -> None:
        """Overwrite the gauge with the current reading."""
        self.value = float(v)


class Histogram:
    """Fixed-bound bucket histogram: ``bounds[i]`` is bucket ``i``'s
    inclusive upper edge; one extra overflow bucket catches everything
    above the last bound. ``sum(bucket_counts) == count`` always."""

    def __init__(self, name: str,
                 bounds: Tuple[float, ...] = DEFAULT_BUCKETS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name!r} needs ascending, "
                             f"non-empty bucket bounds, got {bounds!r}")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self.bucket_counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        """Record one observation into exactly one bucket."""
        v = float(v)
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1


class MetricsRegistry:
    """Get-or-create home for named instruments.

    A name maps to exactly one instrument kind — re-requesting it with a
    different kind (or a histogram with different bounds) raises, which
    is what keeps the naming convention honest across subsystems."""

    def __init__(self) -> None:
        self._counters: "Dict[str, Counter]" = {}
        self._gauges: Dict[Tuple[str, Tuple], Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._marked: set = set()

    # ------------------------------------------------------- instruments

    def counter(self, name: str, group: Optional[str] = None) -> Counter:
        """The counter named ``name`` (created on first use). A counter's
        emission group is fixed at creation; passing a different one
        later raises."""
        c = self._counters.get(name)
        if c is None:
            self._check_free(name, self._counters)
            c = self._counters[name] = Counter(name, group)
        elif group is not None and c.group != group:
            raise ValueError(f"counter {name!r} already registered in "
                             f"group {c.group!r}, not {group!r}")
        return c

    def gauge(self, name: str, **labels: object) -> Gauge:
        """The gauge named ``name`` with the given labels (created on
        first use); each distinct label set is its own series."""
        key = (name, tuple(sorted(labels.items())))
        g = self._gauges.get(key)
        if g is None:
            if not labels:
                self._check_free(name, {k[0]: 1 for k in self._gauges})
            g = self._gauges[key] = Gauge(name, key[1])
        return g

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        """The histogram named ``name`` (created on first use with
        ``bounds``; later calls must agree on the bounds)."""
        h = self._histograms.get(name)
        if h is None:
            self._check_free(name, self._histograms)
            h = self._histograms[name] = Histogram(name, bounds)
        elif h.bounds != tuple(float(b) for b in bounds):
            raise ValueError(f"histogram {name!r} already registered with "
                             f"bounds {h.bounds}, not {bounds}")
        return h

    def _check_free(self, name: str, own: Dict) -> None:
        """Reject a name already claimed by a different instrument kind."""
        kinds = {"counter": self._counters,
                 "gauge": {k[0]: 1 for k in self._gauges},
                 "histogram": self._histograms}
        for kind, table in kinds.items():
            if table is own:
                continue
            if name in table:
                raise ValueError(f"name {name!r} already registered as a "
                                 f"{kind}")

    # ---------------------------------------------------------- emission

    def mark_group(self, group: str) -> None:
        """Mark an emission group present: its counters appear in
        :meth:`as_summary` from now on (the registry equivalent of
        ``workload_summary``'s ``any(field is not None)`` guards)."""
        self._marked.add(group)

    def group_marked(self, group: str) -> bool:
        """Whether an emission group has been marked present."""
        return group in self._marked

    def as_summary(self) -> Dict[str, float]:
        """The counter view ``workload_summary`` is built from: every
        ungrouped counter plus the counters of marked groups, as
        ``name -> float(value)`` in registration order."""
        return {c.name: float(c.value) for c in self._counters.values()
                if c.group is None or c.group in self._marked}

    def as_dict(self) -> Dict[str, object]:
        """Full snapshot for reports/debugging: every counter (grouped or
        not), gauge series, and histogram state."""
        return {
            "counters": {c.name: {"value": c.value, "group": c.group}
                         for c in self._counters.values()},
            "gauges": [{"name": g.name, "labels": dict(g.labels),
                        "value": g.value} for g in self._gauges.values()],
            "histograms": {h.name: {"bounds": list(h.bounds),
                                    "bucket_counts": list(h.bucket_counts),
                                    "count": h.count, "sum": h.sum}
                           for h in self._histograms.values()},
        }


class _NullInstrument:
    """Shared do-nothing counter/gauge/histogram for telemetry-off mode."""

    name = ""
    group = None
    value = 0.0
    labels = ()

    def inc(self, v: float = 1) -> None:
        """No-op."""

    def set(self, v: float) -> None:
        """No-op."""

    def observe(self, v: float) -> None:
        """No-op."""


class _NullRegistry(MetricsRegistry):
    """Telemetry-off registry: every accessor returns one shared no-op
    instrument and nothing is ever recorded or allocated."""

    _NULL = _NullInstrument()

    def counter(self, name: str, group: Optional[str] = None):
        """The shared no-op instrument."""
        return self._NULL

    def gauge(self, name: str, **labels: object):
        """The shared no-op instrument."""
        return self._NULL

    def histogram(self, name: str, bounds: Tuple[float, ...] = ()):
        """The shared no-op instrument."""
        return self._NULL

    def mark_group(self, group: str) -> None:
        """No-op."""


#: Shared telemetry-off registry (stateless — safe to share globally).
NULL_REGISTRY = _NullRegistry()
