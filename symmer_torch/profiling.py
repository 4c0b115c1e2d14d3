"""Lightweight tracing/observability.

The reference has no profiling beyond tqdm bars and a time-boxed DFS
(SURVEY §5.1).  Here:

  - ``kernel_stats``: counters for host/device kernel dispatches, so users can
    see where the auto-dispatch sent their workload;
  - ``trace(log_dir)``: context manager around ``torch.profiler`` (host
    activity, and the card's kernels when a card is present), writing a
    Chrome trace that TensorBoard and Perfetto open;
  - ``timed(label)``: wall-clock section timer accumulating into
    ``kernel_stats.timings``.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class KernelStats:
    host_calls: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    device_calls: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    # calls that ran on a mesh (symmer_torch.use_mesh), also in device_calls
    mesh_calls: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    timings: Dict[str, float] = field(default_factory=lambda: defaultdict(float))

    def record(self, name: str, device: bool, mesh: bool = False) -> None:
        if mesh:
            self.mesh_calls[name] += 1
        (self.device_calls if device else self.host_calls)[name] += 1

    def reset(self) -> None:
        self.host_calls.clear()
        self.device_calls.clear()
        self.mesh_calls.clear()
        self.timings.clear()

    def summary(self) -> str:
        lines = ["kernel dispatch summary:"]
        for name, n in sorted(self.host_calls.items()):
            lines.append(f"  host   {name:<24} x{n}")
        for name, n in sorted(self.device_calls.items()):
            lines.append(f"  device {name:<24} x{n}")
        for name, n in sorted(self.mesh_calls.items()):
            lines.append(f"  mesh   {name:<24} x{n}")
        for name, t in sorted(self.timings.items()):
            lines.append(f"  timer  {name:<24} {t * 1e3:.2f} ms")
        return "\n".join(lines)


kernel_stats = KernelStats()


@contextlib.contextmanager
def timed(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        kernel_stats.timings[label] += time.perf_counter() - t0



@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write its trace,
    ``<log_dir>/<worker>.<time>.pt.trace.json`` (TensorBoard's torch
    profiler plugin or Perfetto open it).  Yields the profiler, whose
    ``key_averages()`` tabulate the block's operators and kernels."""
    import torch
    from torch import profiler

    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    prof = profiler.profile(activities=activities,
                            on_trace_ready=profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
