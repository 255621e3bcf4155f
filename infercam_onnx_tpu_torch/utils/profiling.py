"""Per-stage latency instrumentation and the device trace
(``infercam_onnx_tpu/utils/profiling.py``).

- ``StageTimer``: per-stage wall-clock histograms (decode / upload /
  device / draw / encode / e2e) with p50/p95/p99 summaries, drained by the
  meter logger every period and by ``chip_smoke.py``'s serve phase;
- ``device_trace``: a ``torch.profiler`` trace of a serving window, written
  as a Chrome trace into ``log_dir``
  (``python -m infercam_onnx_tpu_torch.serve --profile-dir DIR``).
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from collections import defaultdict

# samples kept per stage between drains (a uniform reservoir beyond that)
MAX_SAMPLES_PER_STAGE = 4096


class StageTimer:
    """Records wall-clock samples per named stage; drainable summaries."""

    def __init__(self):
        self._samples: dict[str, list[float]] = defaultdict(list)
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._rng = random.Random(0)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            # reservoir sample: a uniform subset over the whole period,
            # exact count and total always
            self._counts[name] += 1
            self._totals[name] += seconds
            samples = self._samples[name]
            if len(samples) < MAX_SAMPLES_PER_STAGE:
                samples.append(seconds)
            else:
                j = self._rng.randrange(self._counts[name])
                if j < MAX_SAMPLES_PER_STAGE:
                    samples[j] = seconds

    def drain(self) -> dict[str, dict[str, float]]:
        """{stage: {count, p50_ms, p95_ms, p99_ms, total_ms}} and reset."""
        with self._lock:
            out = {}
            for name, samples in self._samples.items():
                if not samples:
                    continue
                s = sorted(samples)
                n = len(s)
                out[name] = {
                    "count": self._counts[name],
                    "p50_ms": s[n // 2] * 1e3,
                    "p95_ms": s[min(n - 1, int(n * 0.95))] * 1e3,
                    "p99_ms": s[min(n - 1, int(n * 0.99))] * 1e3,
                    "total_ms": self._totals[name] * 1e3,
                }
            self._samples.clear()
            self._counts.clear()
            self._totals.clear()
            return out

    def format_drain(self) -> str:
        """`drain` as one log line: ``"<stage> p50 <ms>ms p95 <ms>ms
        x<count>"`` per stage, by name, joined by "; "."""
        return "; ".join(
            f"{name} p50 {st['p50_ms']:.1f}ms p95 {st['p95_ms']:.1f}ms "
            f"x{st['count']}" for name, st in sorted(self.drain().items()))


STAGES = StageTimer()


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Trace host and CUDA activity with ``torch.profiler`` for the life
    of the block and write it to ``log_dir/trace.json`` (no-op if None)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:  # a server stopped by Ctrl-C still writes its trace
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
