"""Cross-layer invariant auditor over the listener-coupled cache tiers.

Residency (``CacheState``) drives four derived tiers through listener
hooks: device buffers (``JaxMeshBackend``), join artifacts
(``JoinArtifactCache``), the coverage index, and result-cache version
stamps. Under fault storms a missed hook or a partially-applied
recovery would silently diverge them; the :class:`InvariantAuditor`
cross-checks after every policy round and recovery:

* **containment** — device buffers ⊆ resident chunks (and each buffer's
  holder set ⊆ the chunk's replica set + home), pinned batches ⊆
  resident, artifacts ⊆ resident;
* **coverage** — coverage-index entries ⊆ resident, and (when the reuse
  layer keeps it synced) extents match chunk metadata exactly;
* **replica accounting** — every location tuple well-formed (non-empty,
  duplicate-free, nodes in range, chunk resident) and per-node byte
  totals summing to the global ``cached_bytes``;
* **result-cache monotonicity** — the residency version stamp never
  decreases.

The auditor registers as a ``CacheState`` listener only to observe
lifecycle events; the checks themselves run via :meth:`audit`, which the
coordinator calls explicitly after ``sync_devices`` (so listener
ordering can never make the auditor see a half-reconciled tier), and
standalone via ``tools/audit_state.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, List, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.cache_state import CacheState
    from repro_torch.core.coordinator import CacheCoordinator


@dataclass(frozen=True)
class AuditViolation:
    """One failed invariant: which check, and a human-readable detail."""

    invariant: str
    detail: str

    def __str__(self) -> str:
        """``invariant: detail`` — the line tools print per violation."""
        return f"{self.invariant}: {self.detail}"


class InvariantAuditor:
    """Audits the coordinator's coupled cache tiers; see module docstring.

    Violations accumulate in ``violations`` (``violations_total`` is the
    cumulative count backends snapshot/delta per query); ``audits_run``
    counts full passes. A bound backend (set via :meth:`attach`) enables
    the device-buffer checks; without one those checks are skipped.
    """

    def __init__(self, coordinator: "CacheCoordinator") -> None:
        """Bind to ``coordinator``; the backend attaches itself later."""
        self.coordinator = coordinator
        self.backend: Any = None
        self.violations: List[AuditViolation] = []
        self.violations_total = 0
        self.audits_run = 0
        self.reconciles = 0
        self._last_result_version: Optional[int] = None

    def attach(self, backend: Any) -> None:
        """Give the auditor a backend to cross-check device state against."""
        self.backend = backend

    # ---------------------------------------------- CacheState listener

    def on_drop(self, chunk_id: int) -> None:
        """Listener hook: observation only (checks run in :meth:`audit`)."""

    def on_split(self, parent_id: int, leaves) -> None:
        """Listener hook: observation only (checks run in :meth:`audit`)."""

    def reconcile(self, state: "CacheState") -> None:
        """Listener hook: count the sync; heavy checks stay in
        :meth:`audit` so ordering against other listeners is moot."""
        self.reconciles += 1

    # ------------------------------------------------------ audit passes

    def audit(self) -> List[AuditViolation]:
        """Run every invariant check once; returns (and accumulates) the
        violations found in this pass."""
        coord = self.coordinator
        found: List[AuditViolation] = []
        found.extend(self._check_buffers(coord))
        found.extend(self._check_artifacts(coord))
        found.extend(self._check_coverage(coord))
        found.extend(self._check_replicas(coord))
        found.extend(self._check_result_versions(coord))
        self.audits_run += 1
        self.violations.extend(found)
        self.violations_total += len(found)
        return found

    # -------------------------------------------------------- invariants

    def _check_buffers(self, coord: "CacheCoordinator"
                       ) -> List[AuditViolation]:
        """Device buffers (and pinned batches) must track residency."""
        out: List[AuditViolation] = []
        backend = self.backend
        buffers = getattr(backend, "_buffers", None)
        if buffers is None:
            return out
        cached = coord.cache.cached
        for cid, holders in buffers.items():
            if cid not in cached:
                out.append(AuditViolation(
                    "buffers⊆residency",
                    f"device buffer for non-resident chunk {cid} "
                    f"on nodes {sorted(holders)}"))
                continue
            reps = coord.cache.replicas_of(cid)
            expected = set(reps) if reps else {coord.chunks.home_node(cid)}
            extra = set(holders) - expected
            if extra:
                out.append(AuditViolation(
                    "buffers⊆replicas",
                    f"chunk {cid} buffered on {sorted(extra)} outside "
                    f"replica set {sorted(expected)}"))
        pinned = getattr(backend, "_pinned_by_chunk", None) or {}
        for cid in pinned:
            if cid not in cached:
                out.append(AuditViolation(
                    "pinned⊆residency",
                    f"pinned dispatch batch references evicted chunk {cid}"))
        return out

    def _check_artifacts(self, coord: "CacheCoordinator"
                         ) -> List[AuditViolation]:
        """Join artifacts must only exist for resident chunks."""
        out: List[AuditViolation] = []
        artifacts = getattr(self.backend, "artifacts", None)
        if artifacts is None:
            return out
        cached = coord.cache.cached
        for cid in artifacts.chunk_ids():
            if cid not in cached:
                out.append(AuditViolation(
                    "artifacts⊆residency",
                    f"join artifacts live for evicted chunk {cid}"))
        audit_fn = getattr(artifacts, "audit", None)
        if callable(audit_fn):
            out.extend(AuditViolation("artifact-index", detail)
                       for detail in audit_fn())
        return out

    def _check_coverage(self, coord: "CacheCoordinator"
                        ) -> List[AuditViolation]:
        """Coverage-index entries must be resident with exact extents."""
        out: List[AuditViolation] = []
        coverage = coord.cache.coverage
        if not len(coverage):
            return out
        cached = coord.cache.cached
        for cid in coverage.ids():
            if cid not in cached:
                out.append(AuditViolation(
                    "coverage⊆residency",
                    f"coverage index advertises evicted chunk {cid}"))
                continue
            meta = coord.chunks.meta_of(cid)
            extent = coverage.box_of(cid)
            if meta is not None and extent is not None \
                    and extent != meta.box:
                out.append(AuditViolation(
                    "coverage-extents",
                    f"chunk {cid} coverage extent {extent} != "
                    f"metadata extent {meta.box}"))
        return out

    def _check_replicas(self, coord: "CacheCoordinator"
                        ) -> List[AuditViolation]:
        """Location tuples well-formed + byte accounting consistent."""
        out = [AuditViolation("replica-locations", detail)
               for detail in coord.cache.audit_locations(coord.n_nodes)]
        chunk_bytes = coord.chunks.size_tables()[0]
        per_node = coord.cache.bytes_by_node(chunk_bytes)
        total = coord.cache.cached_bytes(chunk_bytes)
        if sum(per_node.values()) != total:
            out.append(AuditViolation(
                "replica-bytes",
                f"per-node byte totals {sum(per_node.values())} != "
                f"global replica-charged total {total}"))
        return out

    def _check_result_versions(self, coord: "CacheCoordinator"
                               ) -> List[AuditViolation]:
        """Result-cache residency version must be monotonic."""
        out: List[AuditViolation] = []
        rc = getattr(coord, "result_cache", None)
        if rc is None:
            return out
        version = rc.version
        if (self._last_result_version is not None
                and version < self._last_result_version):
            out.append(AuditViolation(
                "result-version-monotonic",
                f"result-cache version went backwards: "
                f"{self._last_result_version} -> {version}"))
        self._last_result_version = version
        return out

    # -------------------------------------------------------- reporting

    def report(self) -> str:
        """Multi-line human-readable summary of cumulative audit state."""
        lines = [f"audits_run={self.audits_run} "
                 f"violations={self.violations_total} "
                 f"reconciles_seen={self.reconciles}"]
        lines.extend(f"  VIOLATION {v}" for v in self.violations)
        return "\n".join(lines)
