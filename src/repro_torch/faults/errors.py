"""Typed errors for the transient-fault pipeline.

The hierarchy draws one load-bearing line: everything under
:class:`TransientFaultError` is *retryable* — the :class:`~repro_torch.faults.retry.Retrier`
catches it, backs off, and re-attempts the operation — while
:class:`RetryExhaustedError` and :class:`BatchInFlightError` are terminal
control-flow signals that callers handle explicitly (degrade the query,
reject the call).
"""
from __future__ import annotations

from typing import Any, Optional


class TransientFaultError(RuntimeError):
    """Base class for failures that are worth retrying.

    Raising a subclass inside an operation wrapped by
    :meth:`repro_torch.faults.retry.Retrier.call` triggers backoff + retry
    rather than propagating to the caller.
    """


class InjectedFaultError(TransientFaultError):
    """A seeded fault fired at a named fault point (``kind="error"``)."""

    def __init__(self, point: str, **context: Any) -> None:
        """``point`` is the fault-point name (e.g. ``"ship.transfer"``);
        ``context`` carries site-specific detail (chunk id, node, ...)."""
        self.point = point
        self.context = dict(context)
        detail = ", ".join(f"{k}={v}" for k, v in sorted(context.items()))
        super().__init__(f"injected fault at {point}"
                         + (f" ({detail})" if detail else ""))


class ChecksumError(TransientFaultError):
    """A shipped chunk payload failed its per-chunk checksum.

    Raised by :meth:`repro_torch.faults.injector.ChecksumRegistry.verify` when
    the CRC of a received payload differs from the recorded one — the
    transfer is treated as transient (corruption on the wire) and
    retried from a clean source.
    """

    def __init__(self, chunk_id: int, expected: int, got: int) -> None:
        """Record the mismatching CRCs for ``chunk_id``."""
        self.chunk_id = chunk_id
        self.expected = expected
        self.got = got
        super().__init__(f"checksum mismatch on chunk {chunk_id}: "
                         f"expected {expected:#010x}, got {got:#010x}")


class ScanError(TransientFaultError):
    """A raw-file scan failed (missing/truncated file, decode error).

    Names the file (id + path) and — once the planner annotates it — the
    queried box, so a failure deep in the scan path surfaces as a typed,
    attributable error instead of a bare ``OSError``/numpy exception.
    """

    def __init__(self, file_id: int, path: str,
                 box: Optional[Any] = None,
                 cause: Optional[BaseException] = None) -> None:
        """``box`` is the queried :class:`~repro_torch.core.geometry.Box` when
        known (the planner fills it in); ``cause`` the original error."""
        self.file_id = file_id
        self.path = path
        self.box = box
        self.cause = cause
        msg = f"scan of file {file_id} ({path}) failed"
        if box is not None:
            msg += f" while serving query box {box}"
        if cause is not None:
            msg += f": {cause!r}"
        super().__init__(msg)


class RetryExhaustedError(RuntimeError):
    """An operation kept failing after every attempt the policy allows.

    Terminal (NOT a :class:`TransientFaultError`): callers catch it to
    degrade gracefully — drop the affected sub-boxes into a
    :class:`~repro_torch.faults.retry.DegradedResult` instead of crashing the
    batch.
    """

    def __init__(self, op: str, attempts: int,
                 last_error: Optional[BaseException] = None,
                 timed_out: bool = False) -> None:
        """``op`` is the operation label (fault-point name), ``attempts``
        how many times it ran, ``last_error`` the final failure, and
        ``timed_out`` whether the per-operation budget (rather than the
        attempt cap) ended the retry loop."""
        self.op = op
        self.attempts = attempts
        self.last_error = last_error
        self.timed_out = timed_out
        why = "timeout budget exhausted" if timed_out else "attempts exhausted"
        super().__init__(f"retry budget for {op} exhausted after "
                         f"{attempts} attempt(s) ({why}); "
                         f"last error: {last_error!r}")


class BatchInFlightError(RuntimeError):
    """``fail_node`` was called while a planning batch is in flight.

    Mid-batch crash-restarts would mutate residency under the planner's
    feet and corrupt accounting; the coordinator rejects them with this
    typed error so callers can retry between batches.
    """
