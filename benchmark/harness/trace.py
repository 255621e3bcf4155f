"""The device trace of a traced run: ``torch.profiler`` (CUPTI, device
activity only, which costs the host little) from before the traffic to
the window's end, reduced over the window to what the per-layer metrics
read.

- ``kernels``: every device activity (kernels, copies, sets) as (name,
  start, end) in ``time.monotonic`` seconds;
- ``busy_s``: the union of their intervals, the seconds in which the
  device ran anything;
- ``stage_s``: kernel seconds by stage (``kernel_stages.json``), and the
  kernels no stage claims;
- ``device_ops``: the ten kernel names that took the most device time;
- ``idle_gaps``: the device's idle time split by what the host's stage
  threads were doing meanwhile (the stage spans recorded by the program,
  ``utils/profiling.py`` ``STAGES``), the ten largest.
"""

from __future__ import annotations

import collections
import json
import pathlib
import re
import time

import numpy as np

STAGE_MAP = json.loads((pathlib.Path(__file__).resolve().parent.parent
                        / "kernel_stages.json").read_text())["stages"]


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self._prof.start()
        # the profiler's clock against the monotonic one
        self._wall_minus_mono = time.time_ns() - time.monotonic_ns()

    def stop(self, t0: float, t1: float) -> None:
        """Stop, keeping what ran in [t0, t1] (monotonic seconds)."""
        import torch

        torch.cuda.synchronize()
        self._prof.stop()
        self.t0, self.t1 = t0, t1

    def kernels(self) -> list[tuple[str, float, float]]:
        from torch.autograd import DeviceType

        results = self._prof.profiler.kineto_results
        base = self._wall_minus_mono
        if abs(results.trace_start_ns() - time.monotonic_ns()) < abs(
                results.trace_start_ns() - time.time_ns()):
            base = 0  # the profiler reads the monotonic clock
        out = []
        for e in results.events():
            if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
                continue
            start = (e.start_ns() - base) / 1e9
            end = start + e.duration_ns() / 1e9
            if end > self.t0 and start < self.t1:
                out.append((e.name(), max(start, self.t0),
                            min(end, self.t1)))
        return out


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def stage_of(name: str) -> str | None:
    for stage, pattern in STAGE_MAP:
        if re.search(pattern, name):
            return stage
    return None


def reduce(kernels: list, t0: float, t1: float,
           host_spans: list[tuple[str, float, float]]) -> dict:
    """What the metrics read from the traced window [t0, t1]."""
    busy = _union([(a, b) for _, a, b in kernels])
    busy_s = sum(b - a for a, b in busy)
    by_name: collections.Counter = collections.Counter()
    stage_s: collections.Counter = collections.Counter()
    unmapped: collections.Counter = collections.Counter()
    for name, a, b in kernels:
        by_name[name] += b - a
        stage = stage_of(name)
        if stage is None:
            unmapped[name] += b - a
        else:
            stage_s[stage] += b - a
    return {
        "busy_s": busy_s, "window_s": t1 - t0,
        "stage_s": dict(stage_s),
        "unmapped": [[n, s] for n, s in unmapped.most_common(10)],
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": idle_by_host_stage(busy, t0, t1, host_spans),
    }


def idle_by_host_stage(busy: list, t0: float, t1: float,
                       host_spans: list, step: float = 1e-4) -> list:
    """The device's idle seconds in [t0, t1], split by the set of host
    stages active at the time (sampled every ``step`` seconds), the ten
    largest: [["decode+device_ycbcr", s], ["no_stage", s], ...]."""
    n = max(1, int((t1 - t0) / step))

    def mask(intervals):
        edges = np.zeros(n + 1, np.int64)
        for a, b in intervals:
            i, j = int((a - t0) / step), int((b - t0) / step)
            i, j = max(0, min(n, i)), max(0, min(n, j))
            edges[i] += 1
            edges[j] -= 1
        return np.cumsum(edges[:n]) > 0

    idle = ~mask(busy)
    # the stage threads' spans ("e2e" spans a frame's whole life)
    names = sorted({s for s, _, _ in host_spans} - {"e2e"})
    active = {s: mask([(a, b) for name, a, b in host_spans if name == s])
              for s in names}
    code = np.zeros(n, np.int64)
    for bit, s in enumerate(names):
        code |= active[s].astype(np.int64) << bit
    out = collections.Counter()
    values, counts = np.unique(code[idle], return_counts=True)
    for v, c in zip(values, counts):
        label = "+".join(s for bit, s in enumerate(names) if v >> bit & 1)
        out[label or "no_stage"] += float(c) * step
    return [[k, v] for k, v in out.most_common(10)]
