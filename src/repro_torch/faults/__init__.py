"""Transient-fault pipeline: seeded injection, retry/degrade, auditing.

Public surface of the fault subsystem:

* :class:`FaultInjector` / :class:`FaultSpec` / :func:`make_faults` —
  deterministic, seeded fault schedules armed at named fault points
  (``scan.read``, ``ship.transfer``, ``prep.build``, ``dispatch.kernel``,
  ``recover.readmit``) via the single ``fault_point(name, ...)`` seam.
* :class:`ChecksumRegistry` / :func:`payload_checksum` — per-chunk CRCs
  that catch bit-flip corruption faults on shipped payloads.
* :class:`RetryPolicy` / :class:`Retrier` / :func:`make_retry` —
  bounded retries with exponential backoff under an injectable clock
  and a per-operation timeout budget.
* :class:`DegradedResult` / :func:`make_degraded` — typed partial
  results naming exactly which sub-boxes were served after an exhausted
  retry budget.
* :class:`InvariantAuditor` / :class:`AuditViolation` — cross-layer
  consistency checks over the listener-coupled cache tiers.
* The typed error hierarchy in :mod:`repro_torch.faults.errors`.

Everything defaults off (``faults="off"``): the seam is never consulted
and the pipeline is bit-for-bit the fault-free seed.
"""
from repro_torch.faults.audit import AuditViolation, InvariantAuditor
from repro_torch.faults.errors import (BatchInFlightError, ChecksumError,
                                 InjectedFaultError, RetryExhaustedError,
                                 ScanError, TransientFaultError)
from repro_torch.faults.injector import (FAULT_KINDS, FAULT_POINTS, ChecksumRegistry,
                                   FaultInjector, FaultSpec, make_faults,
                                   payload_checksum)
from repro_torch.faults.retry import (DegradedResult, Retrier, RetryPolicy,
                                make_degraded, make_retry)

__all__ = [
    "AuditViolation", "BatchInFlightError", "ChecksumError",
    "ChecksumRegistry", "DegradedResult", "FAULT_KINDS", "FAULT_POINTS",
    "FaultInjector", "FaultSpec", "InjectedFaultError", "InvariantAuditor",
    "Retrier", "RetryExhaustedError", "RetryPolicy", "ScanError",
    "TransientFaultError", "make_degraded", "make_faults", "make_retry",
    "payload_checksum",
]
