"""Per-stage latency instrumentation and the device trace
(``infercam_onnx_tpu/utils/profiling.py``).

- ``StageTimer``: per-stage wall-clock histograms (decode / upload /
  device / draw / encode / e2e, and the device and publish stages' parts)
  with p50/p95/p99 summaries, drained by the meter logger every period
  and by ``chip_smoke.py``'s serve phase. A stage thread's top-level span
  also adds the thread's own CPU seconds inside it into a named CPU total
  (`StageTimer.cpu_totals`, which the Meter exports);
- ``device_trace``: a ``torch.profiler`` trace of a serving window, written
  as a Chrome trace into ``log_dir``
  (``python -m infercam_onnx_tpu_torch.serve --profile-dir DIR``), with
  every stage span as a ``record_function`` range beside the kernels.

Spans time on ``time.monotonic``, the clock of ``InferJob.enqueued_at``.
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


class Span:
    """One span of `StageTimer.stage`; ``seconds`` is its duration once
    closed."""

    __slots__ = ("_timer", "_name", "_cpu", "_range", "_t0", "_c0",
                 "seconds")

    def __init__(self, timer: StageTimer, name: str, cpu: str | None):
        self._timer, self._name, self._cpu = timer, name, cpu
        self._range = None
        self.seconds = 0.0

    def __enter__(self) -> Span:
        if self._timer.ranges:
            from torch.autograd.profiler import record_function

            self._range = record_function(self._name)
            self._range.__enter__()
        if self._cpu is not None:
            self._c0 = time.thread_time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic()
        if self._cpu is not None:
            self._timer.add_cpu(self._cpu, time.thread_time() - self._c0)
        self.seconds = t1 - self._t0
        # recorded as it ends: a tap on ``record`` stamps the end
        self._timer.record(self._name, self.seconds)
        if self._range is not None:
            self._range.__exit__(*exc)


class StageTimer:
    """Records wall-clock samples per named stage; drainable summaries."""

    def __init__(self):
        self._samples: dict[str, list[float]] = defaultdict(list)
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        # CPU seconds by total name, since start-up (never drained)
        self._cpu: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._rng = random.Random(0)
        # open a ``record_function`` range per span (`device_trace` sets it)
        self.ranges = False

    def stage(self, name: str, cpu: str | None = None) -> Span:
        """A span of ``name`` on the wall clock (``with STAGES.stage(name)
        as span:``). ``cpu``: the CPU total that the calling thread's own
        CPU seconds inside the span are added into; give it only on a
        stage thread's top-level spans, so no CPU second counts twice."""
        return Span(self, name, cpu)

    def add_cpu(self, total: str, seconds: float) -> None:
        with self._lock:
            self._cpu[total] += seconds

    def cpu_totals(self) -> dict[str, float]:
        """{CPU total name: CPU seconds since start-up}."""
        with self._lock:
            return dict(self._cpu)

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
    """Trace host and CUDA activity, on every thread, with
    ``torch.profiler`` for the life of the block and write it to
    ``log_dir/trace.json`` (no-op if None); each `STAGES` span is a
    ``record_function`` range meanwhile."""
    if not log_dir:
        yield
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # every thread: the stage threads run the host path, not this one
    prof = profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))
    prof.start()
    # only this trace gets the ranges: another session that sums the
    # CUDA events of its trace would count each range around launches
    # (a ``gpu_user_annotation``) as device time
    STAGES.ranges = True
    try:
        yield
    finally:  # a server stopped by Ctrl-C still writes its trace
        STAGES.ranges = False
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
