"""Span tracing with Chrome trace-event JSON export (Perfetto-loadable).

A :class:`Tracer` produces nested, *explicitly parented* :class:`Span`
records over an injectable monotonic :class:`~repro_torch.obs.clock.Clock`.
The span taxonomy instrumented across the repo (ARCHITECTURE.md
"Telemetry"):

  the join: ``workload`` > ``batch`` / ``query`` > ``query.rewrite``,
  ``plan.scan``, ``policy.evict``, ``policy.place``,
  ``policy.replicate``, ``ship``, ``prep``, ``dispatch`` > ``simjoin``
  (``node=``) — plus ``recover`` around a simulated node-failure round;

  training: ``pipeline.next_batch`` > ``query`` (the join's spans
  above), ``pipeline.assemble``; ``launch.place_batch``;
  ``train.step`` > ``train.forward`` (model forward and loss, once per
  microbatch), ``train.backward`` (the backward pass, remat recompute
  included), ``train.optimizer`` > ``optimizer.norm``,
  ``optimizer.adamw``; under the forward (and, recomputed, under the
  backward) ``model.layer`` (``layer=``) > ``moe.route``,
  ``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared``,
  then ``model.head``; ``launch.readback``.

Parenting is explicit: every span records its parent's id, so nesting
invariants are testable on the span records themselves rather than
inferred from timestamps. Each thread has its own stack of open spans:
a span's implicit parent is the innermost span open on its own thread,
or, on a thread with none open, the innermost span open on the thread
that created the tracer (so the layers the autograd engine recomputes
on its own thread sit under ``train.backward``); ``parent=`` overrides
both. A span records its thread's native id in ``tid``, and
:meth:`Tracer.end` closes spans of the calling span's thread only.

While a span is open it is also a ``torch.profiler.record_function``
range of the same name, so a recording profiler holds the program's
spans as user annotations on the clock of the device's kernels.

:meth:`Tracer.to_chrome_trace` renders the spans as Chrome trace-event
JSON ("X" complete events, microsecond timestamps) wrapped in the
``{"traceEvents": [...]}`` object format — drag the written file into
https://ui.perfetto.dev or ``chrome://tracing`` to see the timeline.

``NULL_TRACER`` is the telemetry-off tracer: :meth:`~NullTracer.span`
returns one shared no-op context manager, so instrumented call sites
cost a method call and nothing else when tracing is off.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.clock import Clock, MONOTONIC

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]


@dataclasses.dataclass
class Span:
    """One traced operation: a named interval with explicit parentage.

    ``start``/``end`` are raw clock readings (seconds; ``end`` is
    ``None`` while the span is open); ``parent_id`` is ``None`` only for
    root spans; ``tid`` is the native id of the thread that opened it.
    ``args`` carries small key-value annotations (node ids, batch sizes)
    rendered into the trace event's ``args``."""

    span_id: int
    name: str
    start: float
    cat: str = "phase"
    tid: int = 0
    parent_id: Optional[int] = None
    end: Optional[float] = None
    args: Optional[Dict[str, object]] = None

    @property
    def duration_s(self) -> float:
        """The span's duration in seconds (0.0 while still open)."""
        return 0.0 if self.end is None else self.end - self.start


class _SpanContext:
    """Context manager closing one span on exit (re-entrant per span)."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc) -> None:
        self._tracer.end(self.span)


class Tracer:
    """Collects spans over an injectable clock; exports Chrome trace JSON.

    One open-span stack per thread provides the implicit parent (see
    the module docstring); ``parent=`` overrides it. Every open span is
    a ``torch.profiler.record_function`` range as well."""

    enabled = True

    def __init__(self, clock: Optional[Clock] = None, pid: int = 0):
        from torch.profiler import record_function
        self.clock = clock if clock is not None else MONOTONIC
        self.pid = pid
        self.spans: List[Span] = []       # every begun span, begin order
        # thread id -> its open (span, profiler range), innermost last
        self._stacks: Dict[int, List[Tuple[Span, object]]] = {}
        self._owner = threading.get_native_id()
        self._ids = itertools.count(1)
        self._range = record_function
        # each thread's native id, asked for once (a system call)
        self._thread = threading.local()

    # ------------------------------------------------------------ spans

    def _owner_parent_id(self) -> Optional[int]:
        """The innermost span open on the tracer's creating thread."""
        try:
            return self._stacks[self._owner][-1][0].span_id
        except (KeyError, IndexError):    # none open (or closed just now)
            return None

    def begin(self, name: str, cat: str = "phase",
              parent: Optional[Span] = None, **args: object) -> Span:
        """Open a span on the calling thread: parented to ``parent`` if
        given, else as the module docstring says (``None`` at top
        level)."""
        try:
            tid = self._thread.tid
        except AttributeError:            # the thread's first span
            tid = self._thread.tid = threading.get_native_id()
        stack = self._stacks.setdefault(tid, [])
        if parent is not None:
            pid = parent.span_id
        elif stack:
            pid = stack[-1][0].span_id
        else:
            pid = self._owner_parent_id()
        annot = self._range(name)
        annot.__enter__()
        span = Span(span_id=next(self._ids), name=name,
                    start=self.clock.now(), cat=cat, tid=tid,
                    parent_id=pid, args=dict(args) if args else None)
        self.spans.append(span)
        stack.append((span, annot))
        return span

    def end(self, span: Span) -> None:
        """Close a span (and any still-open descendants of it on its
        thread — spans close innermost-first, so a leaked child cannot
        outlive its parent in the record). Other threads' spans stay
        open."""
        stack = self._stacks.get(span.tid, [])
        if not any(s is span for s, _ in stack):
            if span.end is None:          # closed out of stack order
                span.end = self.clock.now()
            return
        while stack:
            top, annot = stack.pop()
            annot.__exit__(None, None, None)
            top.end = self.clock.now()
            if top is span:
                return

    def span(self, name: str, cat: str = "phase",
             parent: Optional[Span] = None, **args: object) -> _SpanContext:
        """``with tracer.span("plan.scan"): ...`` — begin/end around a
        block; returns a context manager yielding the open :class:`Span`."""
        return _SpanContext(self, self.begin(name, cat=cat, parent=parent,
                                             **args))

    # ------------------------------------------------------------ export

    def to_chrome_trace(self) -> Dict[str, object]:
        """The collected spans as a Chrome trace-event JSON object
        (``{"traceEvents": [...]}``, "X" complete events, microsecond
        timestamps normalized to the earliest span). Loadable in
        Perfetto and ``chrome://tracing``; open spans are exported with
        zero duration."""
        t0 = min((s.start for s in self.spans), default=0.0)
        events: List[Dict[str, object]] = [{
            "ph": "M", "pid": self.pid, "tid": 0, "name": "process_name",
            "args": {"name": "repro-raw-array-cache"},
        }]
        for s in self.spans:
            args: Dict[str, object] = {"span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            if s.args:
                args.update(s.args)
            events.append({
                "ph": "X", "name": s.name, "cat": s.cat,
                "pid": self.pid, "tid": s.tid,
                "ts": (s.start - t0) * 1e6,
                "dur": max(s.duration_s, 0.0) * 1e6,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write :meth:`to_chrome_trace` to ``path`` as JSON; returns
        ``path`` (convention: name it ``*.trace.json``)."""
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)
        return path


class _NullSpanContext:
    """The shared no-op span context manager (telemetry off)."""

    __slots__ = ()
    span = None

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL_CONTEXT = _NullSpanContext()


class NullTracer:
    """Telemetry-off tracer: every call is a no-op returning shared
    singletons — no span objects, no clock reads, no list growth."""

    enabled = False
    spans: List[Span] = []

    def begin(self, name: str, cat: str = "phase",
              parent: Optional[Span] = None, **args: object) -> None:
        """No-op; returns ``None``."""
        return None

    def end(self, span) -> None:
        """No-op."""

    def span(self, name: str, cat: str = "phase",
             parent: Optional[Span] = None, **args: object):
        """The shared no-op context manager."""
        return _NULL_CONTEXT

    def to_chrome_trace(self) -> Dict[str, object]:
        """An empty (but well-formed) trace object."""
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    export = Tracer.export


#: Shared telemetry-off tracer (stateless — safe to share globally).
NULL_TRACER = NullTracer()
