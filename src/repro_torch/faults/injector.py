"""Seeded, schedule-driven fault injection behind one ``fault_point`` seam.

The coordinator and both backends arm *named fault points* — the five
operation sites of the pipeline::

    scan.read        raw-file scan / decode (planner, raw fallback)
    ship.transfer    replica-to-node chunk transfer (backends)
    prep.build       host-side join prep (artifact build)
    dispatch.kernel  per-node kernel dispatch
    recover.readmit  post-crash re-admission of a lost chunk

by calling :meth:`FaultInjector.fault_point` wherever the real operation
happens. With no injector configured (``faults="off"``, the default) the
seam is never consulted and behavior is bit-for-bit the fault-free seed.

Determinism: each site draws from its **own** RNG stream, derived from
``(seed, crc32(site name))``, and consumes exactly one uniform draw per
crossing (plus per-fire draws for kind/byte choices). A site's schedule
therefore depends only on its own crossing count — re-running the same
seeded workload reproduces the identical injection schedule, and adding
a new fault point never perturbs the others.

Three fault kinds:

* ``"error"``   — raise :class:`~repro_torch.faults.errors.InjectedFaultError`
  (a transient failure the :class:`~repro_torch.faults.retry.Retrier` retries).
* ``"latency"`` — a straggler: delay the crossing by ``delay_s`` (via
  ``clock.advance`` when the injected clock supports it, else a real
  sleep) and let the operation succeed.
* ``"corrupt"`` — return a bit-flipped **copy** of the crossing's
  payload; the caller verifies it against the
  :class:`ChecksumRegistry` and the resulting
  :class:`~repro_torch.faults.errors.ChecksumError` is retried like any other
  transient fault. Crossings without a payload fall back to ``"error"``.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.faults.errors import ChecksumError, InjectedFaultError
from repro_torch.obs.clock import Clock, as_clock

FAULT_POINTS: Tuple[str, ...] = ("scan.read", "ship.transfer", "prep.build",
                                 "dispatch.kernel", "recover.readmit")
FAULT_KINDS: Tuple[str, ...] = ("error", "latency", "corrupt")

#: Cap on how long a latency fault may really sleep (wall-clock clocks
#: only); manual clocks advance by the full ``delay_s`` virtually.
_REAL_SLEEP_CAP_S = 0.005


@dataclass(frozen=True)
class FaultSpec:
    """Schedule for one fault point: fire with probability ``rate`` per
    crossing, choosing uniformly among ``kinds``; ``delay_s`` sizes
    latency faults and ``max_fires`` (optional) caps total fires."""

    point: str
    rate: float
    kinds: Tuple[str, ...] = ("error",)
    delay_s: float = 0.002
    max_fires: Optional[int] = None

    def __post_init__(self) -> None:
        """Validate the point name, rate range, and kind names."""
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"expected one of {FAULT_POINTS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")
        for k in self.kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}; "
                                 f"expected one of {FAULT_KINDS}")
        if not self.kinds:
            raise ValueError("FaultSpec.kinds must not be empty")


def payload_checksum(payload: Any) -> int:
    """CRC32 of a chunk payload's raw bytes (host copy, contiguous)."""
    arr = np.ascontiguousarray(np.asarray(payload))
    return zlib.crc32(arr.tobytes())


class ChecksumRegistry:
    """Per-chunk payload checksums for end-to-end transfer integrity.

    ``record`` memoizes the CRC of a chunk's clean host payload the
    first time it ships; ``verify`` recomputes the CRC of the received
    payload and raises :class:`~repro_torch.faults.errors.ChecksumError` on a
    mismatch (counted in ``mismatches``).
    """

    def __init__(self) -> None:
        """Start with no recorded checksums and a zero mismatch count."""
        self._crc: Dict[int, int] = {}
        self.mismatches = 0

    def record(self, chunk_id: int, payload: Any) -> int:
        """Record (once) and return the clean CRC for ``chunk_id``."""
        if chunk_id not in self._crc:
            self._crc[chunk_id] = payload_checksum(payload)
        return self._crc[chunk_id]

    def verify(self, chunk_id: int, payload: Any) -> None:
        """Raise :class:`ChecksumError` if ``payload`` does not match the
        recorded CRC for ``chunk_id`` (unknown chunks are recorded)."""
        got = payload_checksum(payload)
        expected = self._crc.setdefault(chunk_id, got)
        if got != expected:
            self.mismatches += 1
            raise ChecksumError(chunk_id, expected, got)

    def forget(self, chunk_id: int) -> None:
        """Drop the recorded CRC for a retired chunk id (split/evict)."""
        self._crc.pop(chunk_id, None)

    def __len__(self) -> int:
        """Number of chunks with a recorded checksum."""
        return len(self._crc)

    # ------------------------- CacheState listener (lifecycle hygiene)

    def on_drop(self, chunk_id: int) -> None:
        """Listener hook: a dropped chunk's CRC must not survive — a
        later chunk reusing the id would trip a false mismatch."""
        self.forget(chunk_id)

    def on_split(self, parent_id: int, *args: Any) -> None:
        """Listener hook: the split parent's payload is retired with it;
        children record fresh CRCs on their first ship."""
        self.forget(parent_id)

    def reconcile(self, state: Any) -> None:
        """Listener hook: drop CRCs of chunks no longer resident."""
        for cid in [c for c in self._crc if c not in state.cached]:
            self.forget(cid)


class FaultInjector:
    """Deterministic, seeded transient-fault injector.

    Constructed from per-point :class:`FaultSpec` schedules (or a plain
    ``{point: rate}`` mapping via :func:`make_faults` /
    :meth:`FaultInjector.storm`) and threaded through the stack like the
    injectable ``Clock``. Counters (total fires, per point × kind, delay
    seconds) are cumulative; backends snapshot/delta them to attribute
    injections to individual queries. ``schedule_log`` records every
    fire as ``(point, crossing_index, kind)`` so two same-seed runs can
    be asserted identical.
    """

    def __init__(self, specs: Iterable[FaultSpec], seed: int = 0,
                 clock: Optional[Clock] = None) -> None:
        """``specs`` give at most one schedule per point; ``seed`` roots
        every per-site RNG stream; ``clock`` (optional) makes latency
        faults virtual when it supports ``advance``."""
        self.specs: Dict[str, FaultSpec] = {}
        for spec in specs:
            if spec.point in self.specs:
                raise ValueError(f"duplicate FaultSpec for {spec.point!r}")
            self.specs[spec.point] = spec
        self.seed = int(seed)
        self.clock = as_clock(clock) if clock is not None else None
        self._rng: Dict[str, np.random.Generator] = {
            name: np.random.default_rng([self.seed, zlib.crc32(name.encode())])
            for name in FAULT_POINTS}
        self.crossings: Dict[str, int] = {n: 0 for n in FAULT_POINTS}
        self.injected = 0
        self.by_point: Dict[str, Dict[str, int]] = {}
        self.latency_s = 0.0
        self.schedule_log: List[Tuple[str, int, str]] = []

    # ------------------------------------------------------------ seam

    def fault_point(self, name: str, payload: Any = None,
                    **context: Any) -> Any:
        """One crossing of the named fault point.

        Returns ``payload`` unchanged when no fault fires (or a
        bit-flipped copy for a ``"corrupt"`` fire); raises
        :class:`InjectedFaultError` for an ``"error"`` fire; sleeps and
        returns for a ``"latency"`` fire. ``context`` decorates the
        raised error only — it never influences the schedule.
        """
        if name not in self._rng:
            raise ValueError(f"unknown fault point {name!r}; "
                             f"expected one of {FAULT_POINTS}")
        crossing = self.crossings[name]
        self.crossings[name] = crossing + 1
        spec = self.specs.get(name)
        if spec is None or spec.rate <= 0.0:
            return payload
        fired = sum(self.by_point.get(name, {}).values())
        if spec.max_fires is not None and fired >= spec.max_fires:
            return payload
        rng = self._rng[name]
        if rng.random() >= spec.rate:
            return payload
        kind = spec.kinds[0] if len(spec.kinds) == 1 else \
            spec.kinds[int(rng.integers(len(spec.kinds)))]
        if kind == "corrupt" and payload is None:
            kind = "error"
        self.injected += 1
        self.by_point.setdefault(name, {}).setdefault(kind, 0)
        self.by_point[name][kind] += 1
        self.schedule_log.append((name, crossing, kind))
        if kind == "error":
            raise InjectedFaultError(name, crossing=crossing, **context)
        if kind == "latency":
            self._delay(spec.delay_s)
            return payload
        return self._corrupt(payload, rng)

    # ------------------------------------------------------- internals

    def _delay(self, delay_s: float) -> None:
        """Apply a straggler delay: virtually via ``clock.advance`` when
        available, else a (capped) real sleep."""
        self.latency_s += delay_s
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(delay_s)
        else:
            time.sleep(min(delay_s, _REAL_SLEEP_CAP_S))

    @staticmethod
    def _corrupt(payload: Any, rng: np.random.Generator) -> Any:
        """Return a copy of ``payload`` with one byte bit-flipped."""
        arr = np.array(np.asarray(payload), copy=True)
        flat = arr.reshape(-1).view(np.uint8)
        if flat.size == 0:
            return arr
        flat[int(rng.integers(flat.size))] ^= 0xFF
        return arr

    # ------------------------------------------------------- reporting

    def counters(self) -> Dict[str, float]:
        """Cumulative counters: total fires, per ``point.kind`` fires,
        and total injected latency seconds."""
        out: Dict[str, float] = {"injected": self.injected,
                                 "latency_s": self.latency_s}
        for point, kinds in sorted(self.by_point.items()):
            for kind, n in sorted(kinds.items()):
                out[f"{point}.{kind}"] = n
        return out

    # ----------------------------------------------------- constructors

    @classmethod
    def storm(cls, rate: float, seed: int = 0,
              kinds: Tuple[str, ...] = FAULT_KINDS,
              points: Tuple[str, ...] = FAULT_POINTS,
              delay_s: float = 0.002,
              clock: Optional[Clock] = None) -> "FaultInjector":
        """Uniform fault storm: every point in ``points`` fires each of
        ``kinds`` (uniformly chosen) at per-crossing probability
        ``rate`` — the acceptance-criteria configuration."""
        return cls([FaultSpec(p, rate, kinds=kinds, delay_s=delay_s)
                    for p in points], seed=seed, clock=clock)


def make_faults(spec: Union[str, None, FaultInjector, Mapping[str, float]],
                seed: int = 0,
                clock: Optional[Clock] = None) -> Optional[FaultInjector]:
    """Normalize a ``faults=`` knob (mirrors ``as_clock``/``make_telemetry``).

    ``None``/``"off"`` → ``None`` (seam disabled, seed-exact);
    a :class:`FaultInjector` passes through; a ``{point: rate}`` mapping
    builds an error-only injector with the given ``seed``/``clock``.
    """
    if spec is None or spec == "off":
        return None
    if isinstance(spec, FaultInjector):
        return spec
    if isinstance(spec, Mapping):
        return FaultInjector([FaultSpec(p, r) for p, r in spec.items()],
                             seed=seed, clock=clock)
    raise ValueError(f"faults must be 'off', None, a FaultInjector, or a "
                     f"{{point: rate}} mapping, got {spec!r}")
