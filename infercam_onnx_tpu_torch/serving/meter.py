"""FPS meter (``infercam_onnx_tpu/serving/meter.py``; reference
infer_server/src/meter.rs).

Counts items delivered to stream viewers (per-viewer deliveries, as the
reference does) and unique inferred/raw frames, dropped frames and
batches. A logger task drains and logs every ``period_s`` seconds.

Unlike the JAX copy, the counters sit behind a lock: the worker's decode,
device and publish threads tick them while the event loop drains them,
and an unlocked ``+=`` racing a drain's reset loses the tick.

The totals also hold where the host's time goes: the batcher's queue
wait (``queue_wait_s`` over ``queued_frames``) and each stage thread's
CPU seconds (``cpu_s_decode``, ``cpu_s_upload``, ``cpu_s_device``,
``cpu_s_readback_wait``, ``cpu_s_publish``: `StageTimer.cpu_totals`, as
of the drain). ``graph_captures`` counts the programs the worker's
warm-up captured as CUDA graphs, ``graph_replays`` the units the device
stage ran by replaying them (`detector.ProgramGraphs`).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time

from infercam_onnx_tpu_torch.utils.profiling import STAGES

log = logging.getLogger("infercam.meter")

_COUNTERS = ("raw_delivered", "inferred_delivered", "raw_unique",
             "inferred_unique", "dropped", "batches", "batched_frames",
             "queued_frames", "queue_wait_s", "graph_captures",
             "graph_replays")
# the totals' key of each counter summed into them
_TOTALS = {"raw_delivered": "raw_fps_delivered",
           "inferred_delivered": "inferred_fps_delivered",
           "raw_unique": "raw_unique", "inferred_unique": "inferred_unique",
           "dropped": "dropped", "batches": "batches",
           "batched_frames": "batched_frames",
           "queued_frames": "queued_frames", "queue_wait_s": "queue_wait_s",
           "graph_captures": "graph_captures",
           "graph_replays": "graph_replays"}


class Meter:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        for name in _COUNTERS:
            setattr(self, name, 0)
        self._lat_samples: list[float] = []
        # cumulative totals + last drained window, served by /stats
        self.totals: dict[str, float] = {}
        self.last_window: dict = {}
        self.last_stages: dict = {}
        self.started_at = time.time()

    def _add(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    # per-viewer deliveries (reference parity)
    def tick_raw(self) -> None:
        self._add("raw_delivered")

    def tick_inferred(self) -> None:
        self._add("inferred_delivered")

    # per-unique-frame counters
    def tick_raw_unique(self) -> None:
        self._add("raw_unique")

    def tick_inferred_unique(self, n: int = 1) -> None:
        self._add("inferred_unique", n)

    def tick_dropped(self, n: int = 1) -> None:
        self._add("dropped", n)

    def tick_batch(self, batch_size: int, latency_s: float) -> None:
        with self._lock:
            self.batches += 1
            self.batched_frames += batch_size
            self._lat_samples.append(latency_s)

    def tick_queue(self, frames: int, wait_s: float) -> None:
        """A gather handed to the decode stage: its frames and the seconds
        they waited since the router queued them, summed."""
        with self._lock:
            self.queued_frames += frames
            self.queue_wait_s += wait_s

    def tick_graph_captures(self, n: int = 1) -> None:
        self._add("graph_captures", n)

    def tick_graph_replays(self, n: int = 1) -> None:
        self._add("graph_replays", n)

    def drain(self) -> dict:
        """The counters since the last drain, added into ``totals``, and
        reset; the stage threads' CPU totals copied in."""
        cpu = STAGES.cpu_totals()
        with self._lock:
            counts = {name: getattr(self, name) for name in _COUNTERS}
            lat = sorted(self._lat_samples)
            for name in _COUNTERS:
                setattr(self, name, 0)
            self._lat_samples = []
            for name, key in _TOTALS.items():
                self.totals[key] = self.totals.get(key, 0) + counts[name]
            self.totals.update(cpu)
        return {
            "raw_fps_delivered": counts["raw_delivered"],
            "inferred_fps_delivered": counts["inferred_delivered"],
            "raw_unique": counts["raw_unique"],
            "inferred_unique": counts["inferred_unique"],
            "dropped": counts["dropped"],
            "batches": counts["batches"],
            "graph_captures": counts["graph_captures"],
            "graph_replays": counts["graph_replays"],
            "mean_batch": (counts["batched_frames"] / counts["batches"]
                           if counts["batches"] else 0.0),
            "p50_batch_latency_ms": (
                lat[len(lat) // 2] * 1e3 if lat else 0.0),
        }

    def stats(self) -> dict:
        """Cumulative + last-window stats for the /stats endpoint."""
        return {
            "uptime_s": round(time.time() - self.started_at, 1),
            "totals": dict(self.totals),
            "window": dict(self.last_window),
            "stages": dict(self.last_stages),
        }

    def prometheus(self) -> str:
        """Prometheus text exposition of the same counters (/metrics)."""
        s = self.stats()
        lines = [
            "# TYPE infercam_uptime_seconds gauge",
            f"infercam_uptime_seconds {s['uptime_s']}",
        ]
        for key, val in sorted(s["totals"].items()):
            name = f"infercam_{key}_total"
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {val}")
        window = s["window"]
        for key in ("raw_fps", "inferred_fps", "mean_batch",
                    "p50_batch_latency_ms"):
            if key in window:
                name = f"infercam_window_{key}"
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {window[key]}")
        for stage, st in sorted(s["stages"].items()):
            for q in ("p50_ms", "p95_ms", "p99_ms"):
                name = f"infercam_stage_{stage}_{q}"
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {st[q]}")
        return "\n".join(lines) + "\n"


METER = Meter()


async def meter_logger(period_s: float = 2.0):
    """Log FPS every period (reference meter.rs:41-64)."""
    while True:
        start = time.monotonic()
        await asyncio.sleep(period_s)
        elapsed = time.monotonic() - start
        snap = METER.drain()
        raw = snap["raw_fps_delivered"] / elapsed
        inf = snap["inferred_fps_delivered"] / elapsed
        METER.last_window = {
            **snap,
            "raw_fps": round(raw, 2),
            "inferred_fps": round(inf, 2),
            "window_s": round(elapsed, 2),
        }
        if snap["raw_fps_delivered"]:
            log.info("Raw frames per second: %.2f", raw)
        if snap["inferred_fps_delivered"]:
            log.info(
                "Infered frames per second: %.2f "
                "(unique %.2f, mean batch %.1f, p50 device %.1f ms, "
                "dropped %d)",
                inf, snap["inferred_unique"] / elapsed,
                snap["mean_batch"], snap["p50_batch_latency_ms"],
                snap["dropped"])
            stage_stats = STAGES.drain()
            METER.last_stages = stage_stats
            if stage_stats:
                log.info("Stage latency: %s", "; ".join(
                    f"{name} p50 {s['p50_ms']:.1f}ms "
                    f"p95 {s['p95_ms']:.1f}ms x{s['count']}"
                    for name, s in sorted(stage_stats.items())))
