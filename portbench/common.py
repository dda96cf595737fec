"""What the harness and the drivers share: a run's options and outcome,
the numbers compared and their limits, and the profiler's reading of a
traced window."""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict, List

import torch

#: Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Options:
    """One run: ``--seed``, ``--seconds``, ``--trace``, the device, and
    the host clock at the process's start."""
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics, the record the
    per-layer readers read (with ``--trace 1``, the traced tail's reading
    under ``trace``), the checks, the counts and the device's peak
    memory."""
    e2e: Dict[str, float]
    record: dict
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int

    @property
    def correct(self) -> bool:
        return all(c.ok for c in self.checks)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def no_span(name: str):
    """The untraced steps' span: nothing."""
    return contextlib.nullcontext()


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_peak(dev: torch.device) -> int:
    """The device's peak of allocated bytes so far in this process."""
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def reference_mode(dev: torch.device) -> None:
    """Float32 products in float32: TF32 off for the references."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Profiled:
    """A traced window: ``torch.profiler`` over the host and the device,
    the driver's spans inside it as ``record_function`` ranges, and the
    window's host-clock length."""

    WINDOW = "portbench_traced_window"

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.wall = 0.0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        synchronize(self.dev)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.window = torch.profiler.record_function(self.WINDOW)
        self.window.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self.dev)
        self.wall = time.perf_counter() - self.t0
        self.window.__exit__(*exc)
        self.prof.__exit__(*exc)

    @staticmethod
    def span(name: str):
        """A host span inside the window."""
        return torch.profiler.record_function(name)

    def result(self) -> dict:
        """``window_s`` (host clock), ``busy_s`` (the union of the device
        activity intervals inside the window), ``kernels`` (device
        seconds by name), ``device_ops`` (the ten names with the most
        device time) and ``idle_gaps`` (device-idle seconds by the
        innermost host span they fall in, the ten largest)."""
        events = self.prof.profiler.kineto_results.events()
        win = [e for e in events if e.name() == self.WINDOW and
               e.device_type() == torch.autograd.DeviceType.CPU]
        lo = min(e.start_ns() for e in win)
        hi = max(e.end_ns() for e in win)
        dev = [(max(e.start_ns(), lo), min(e.end_ns(), hi), e.name())
               for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()
               and e.end_ns() > lo and e.start_ns() < hi]
        spans = [(e.start_ns(), e.end_ns(), e.name()) for e in events
                 if e.is_user_annotation() and e.name() != self.WINDOW
                 and e.device_type() == torch.autograd.DeviceType.CPU]
        kernels: Dict[str, float] = {}
        for s, t, name in dev:
            kernels[name] = kernels.get(name, 0.0) + (t - s) / 1e9
        busy, gaps, end = 0, [], lo
        for s, t, _ in sorted(dev):
            if s > end:
                gaps.append((end, s))
            if t > end:
                busy += t - max(s, end)
                end = t
        if end < hi:
            gaps.append((end, hi))
        idle: Dict[str, float] = {}
        for s, t in gaps:
            mid = (s + t) / 2
            inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            name = min(inside, key=lambda sp: sp[1] - sp[0])[2] \
                if inside else "outside the driver's spans"
            idle[name] = idle.get(name, 0.0) + (t - s) / 1e9
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"window_s": self.wall, "busy_s": busy / 1e9,
                "kernels": kernels,
                "device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:10]]}


def idle_share(record: dict):
    """The traced window's device-idle share, %: none without a trace
    in which the device ran something."""
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0 or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def kernel_seconds(record: dict, marker: str) -> float:
    """Device seconds of the traced window's kernels whose name holds
    ``marker``."""
    return sum(t for name, t in record.get("trace", {}).get(
        "kernels", {}).items() if marker in name)
