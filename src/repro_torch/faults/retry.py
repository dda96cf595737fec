"""Retry/backoff/timeout wrapper and typed degraded-mode results.

:class:`RetryPolicy` is the knob surface (max attempts, exponential
backoff, per-operation timeout budget); :class:`Retrier` executes an
operation under that policy with an **injectable clock** — a
``ManualClock`` advances virtually during backoff so tests and the
simulated backend never really sleep, while wall clocks sleep for real.

When the budget is exhausted the :class:`Retrier` raises
:class:`~repro_torch.faults.errors.RetryExhaustedError`; callers catch it and
*degrade* instead of crashing: the affected sub-boxes are subtracted
from the query box and the query returns a :class:`DegradedResult`
naming exactly which regions were served and which operations failed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Tuple, Union

from repro_torch.core.geometry import Box, residual_boxes
from repro_torch.faults.errors import RetryExhaustedError, TransientFaultError
from repro_torch.obs.clock import Clock, MONOTONIC, as_clock
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry


@dataclass(frozen=True)
class RetryPolicy:
    """Retry knobs for one class of transient operations.

    ``max_attempts`` bounds total tries (first try included);
    ``backoff_base_s * backoff_multiplier**attempt`` spaces retries; and
    ``timeout_s`` (optional) caps the whole operation — elapsed time
    plus the next backoff must fit the budget or the retry loop gives
    up early (``timed_out=True`` on the raised error).
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.001
    backoff_multiplier: float = 2.0
    timeout_s: Optional[float] = None

    def __post_init__(self) -> None:
        """Validate ranges (at least one attempt, non-negative times)."""
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base_s < 0 or self.backoff_multiplier < 1.0:
            raise ValueError("backoff_base_s must be >= 0 and "
                             "backoff_multiplier >= 1.0")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError("timeout_s must be positive when set")

    def backoff_s(self, attempt: int) -> float:
        """Backoff to sleep after failed attempt ``attempt`` (0-based)."""
        return self.backoff_base_s * (self.backoff_multiplier ** attempt)


def make_retry(spec: Union[str, None, RetryPolicy, Mapping[str, Any]]
               ) -> RetryPolicy:
    """Normalize a ``retry=`` knob: ``None``/``"default"`` → the default
    :class:`RetryPolicy`; an instance passes through; a mapping becomes
    ``RetryPolicy(**mapping)``."""
    if spec is None or spec == "default":
        return RetryPolicy()
    if isinstance(spec, RetryPolicy):
        return spec
    if isinstance(spec, Mapping):
        return RetryPolicy(**spec)
    raise ValueError(f"retry must be None, 'default', a RetryPolicy, or a "
                     f"kwargs mapping, got {spec!r}")


class Retrier:
    """Runs operations under a :class:`RetryPolicy` with cumulative stats.

    ``call(op, fn)`` invokes ``fn(attempt)`` until it returns, a
    non-transient error escapes, or the budget (attempts or timeout) is
    exhausted — then raises :class:`RetryExhaustedError`. Passing the
    0-based ``attempt`` lets callers re-route each retry (e.g. pick a
    different surviving replica as the transfer source).

    Stats (``retries``, ``giveups``, ``timeouts``, ``backoff_s``) are
    cumulative; backends snapshot/delta them per query.
    """

    def __init__(self, policy: RetryPolicy,
                 clock: Optional[Clock] = None,
                 telemetry: Telemetry = NULL_TELEMETRY) -> None:
        """``clock`` drives the timeout budget and (when it supports
        ``advance``) virtual backoff sleeps; ``telemetry``'s tracer wraps
        each re-attempt in a ``retry`` span."""
        self.policy = policy
        self.clock = as_clock(clock) if clock is not None else MONOTONIC
        self.telemetry = telemetry
        self.retries = 0
        self.giveups = 0
        self.timeouts = 0
        self.backoff_s = 0.0

    def call(self, op: str, fn: Callable[[int], Any]) -> Any:
        """Execute ``fn`` under the policy; see class docstring."""
        policy = self.policy
        started = self.clock.now()
        last: Optional[BaseException] = None
        for attempt in range(policy.max_attempts):
            try:
                if attempt == 0:
                    return fn(attempt)
                with self.telemetry.tracer.span("retry", cat="faults",
                                                op=op, attempt=attempt):
                    return fn(attempt)
            except TransientFaultError as e:
                last = e
                if attempt + 1 >= policy.max_attempts:
                    break
                backoff = policy.backoff_s(attempt)
                if (policy.timeout_s is not None and
                        self.clock.now() - started + backoff
                        > policy.timeout_s):
                    self.timeouts += 1
                    self.giveups += 1
                    raise RetryExhaustedError(op, attempt + 1, last,
                                              timed_out=True) from e
                self._sleep(backoff)
                self.retries += 1
        self.giveups += 1
        raise RetryExhaustedError(op, policy.max_attempts, last) from last

    def _sleep(self, backoff: float) -> None:
        """Back off — virtually when the clock supports ``advance``."""
        self.backoff_s += backoff
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(backoff)
        elif backoff > 0:
            time.sleep(backoff)


@dataclass(frozen=True)
class DegradedResult:
    """What a query actually served after exhausted retry budgets.

    ``failed_boxes`` are the sub-boxes whose operations retried out
    (chunk/file extents clipped to the query box); ``served_boxes`` is
    the exact residual partition of the query box minus the failures;
    ``failed_ops`` names the operations that gave up; and
    ``matches_lower_bound`` is the match count over the served region
    only (a lower bound on the true answer).
    """

    query_box: Box
    served_boxes: Tuple[Box, ...]
    failed_boxes: Tuple[Box, ...]
    failed_ops: Tuple[str, ...]
    matches_lower_bound: int = 0

    @property
    def fully_failed(self) -> bool:
        """True when nothing of the query box could be served."""
        return not self.served_boxes


def make_degraded(query_box: Box, failed_boxes: Tuple[Box, ...],
                  failed_ops: Tuple[str, ...],
                  matches: int = 0) -> DegradedResult:
    """Build a :class:`DegradedResult`, computing ``served_boxes`` as
    the exact residual of ``query_box`` minus ``failed_boxes``."""
    served = tuple(residual_boxes(query_box, list(failed_boxes)))
    return DegradedResult(query_box=query_box, served_boxes=served,
                          failed_boxes=tuple(failed_boxes),
                          failed_ops=tuple(failed_ops),
                          matches_lower_bound=int(matches))
