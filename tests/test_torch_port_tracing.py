"""The serving host path's tracing: `utils.profiling.StageTimer` spans with
the calling thread's CPU time, the ``record_function`` ranges of the
operator's trace, and what a live ``ycbcr`` serve records: the device
stage's launch and readback spans, the publish stage's spans, the stage
threads' CPU totals and the batcher's queue wait in the Meter's totals.
"""

import asyncio
import json
import sys
import threading
import time

import pytest
import torch

from infercam_onnx_tpu_torch.client.sender import send_stream
from infercam_onnx_tpu_torch.config import (ClientConfig, DetectorConfig,
                                            EngineConfig, ServerConfig)
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.serving.app import start_server
from infercam_onnx_tpu_torch.serving.meter import METER, Meter
from infercam_onnx_tpu_torch.serving.router import stream_key
from infercam_onnx_tpu_torch.utils.profiling import (STAGES, StageTimer,
                                                     device_trace)

from tests.test_goldens_fixtures import SYNTH_PICS, WEIGHTS

# the spans and Meter totals the tracing adds
NEW_SPANS = ("launch_input", "launch_trunk", "launch_post", "launch_annot",
             "readback", "readback_wait", "publish")
CPU_TOTALS = ("cpu_s_decode", "cpu_s_upload", "cpu_s_device",
              "cpu_s_readback_wait", "cpu_s_publish")
QUEUE_TOTALS = ("queue_wait_s", "queued_frames")


def _tap(timer: StageTimer) -> list:
    """Every sample ``timer`` records as (name, start, end), stamped as
    the benchmark's harness stamps them: the end when it is recorded
    (``del timer.record`` undoes it)."""
    spans = []
    record = timer.record

    def tap(name, seconds):
        end = time.monotonic()
        spans.append((name, end - seconds, end))
        record(name, seconds)

    timer.record = tap
    return spans


def test_a_span_spinning_the_cpu_records_its_cpu_time():
    timer = StageTimer()
    spans = _tap(timer)
    spin = 0.05
    with timer.stage("busy", cpu="cpu_s_busy") as span:
        c0 = time.thread_time()
        while time.thread_time() - c0 < spin:
            pass
    cpu = timer.cpu_totals()["cpu_s_busy"]
    assert spin <= cpu <= span.seconds + 1e-3
    (name, start, end), = spans
    assert name == "busy" and end - start == pytest.approx(span.seconds)


def test_a_span_that_sleeps_records_near_zero_cpu():
    timer = StageTimer()
    with timer.stage("idle", cpu="cpu_s_idle") as span:
        time.sleep(0.05)
    assert span.seconds >= 0.05
    assert timer.cpu_totals()["cpu_s_idle"] < 0.01
    # a span without ``cpu`` adds to no CPU total
    with timer.stage("child"):
        pass
    assert set(timer.cpu_totals()) == {"cpu_s_idle"}


def test_a_span_lies_between_monotonic_stamps_around_it():
    timer = StageTimer()
    spans = _tap(timer)
    before = time.monotonic()
    with timer.stage("work"):
        sum(range(10000))
    after = time.monotonic()
    (_, start, end), = spans
    assert before <= start <= end <= after


def test_cpu_totals_lose_no_add_to_concurrent_threads():
    timer, n_threads, n_adds = StageTimer(), 8, 2000
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            timer.add_cpu("cpu_s_x", 1.0) for _ in range(n_adds)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    assert timer.cpu_totals()["cpu_s_x"] == n_threads * n_adds


def test_the_operators_trace_carries_the_stage_spans(tmp_path):
    """Under `device_trace` (``serve --profile-dir``; a CPU torch.profiler
    session here) a stage span is a ``record_function`` range of its name;
    under no session, and under another torch.profiler session, none is
    opened."""
    from torch.profiler import ProfilerActivity, profile

    def span():
        with STAGES.stage("tracing_test_span"):
            torch.ones(8).sum()

    assert STAGES.ranges is False
    with device_trace(str(tmp_path)):
        assert STAGES.ranges is True
        span()
        # a stage thread's span, as the worker's threads record them
        thread = threading.Thread(target=span)
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
    assert STAGES.ranges is False
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    threads = {e["tid"] for e in events
               if e.get("name") == "tracing_test_span"}
    assert len(threads) == 2

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with STAGES.stage("tracing_test_span"):
            torch.ones(8).sum()
        with STAGES.stage("tracing_test_span") as span:
            assert span._range is None
    assert "tracing_test_span" not in {e.key for e in prof.key_averages()}


def test_meter_exports_the_queue_and_cpu_totals():
    meter = Meter()
    meter.tick_queue(3, 0.3)
    meter.tick_queue(2, 0.1)
    STAGES.add_cpu("cpu_s_decode", 0.0)
    meter.drain()
    assert meter.totals["queued_frames"] == 5
    assert meter.totals["queue_wait_s"] == pytest.approx(0.4)
    assert meter.totals["cpu_s_decode"] == STAGES.cpu_totals()["cpu_s_decode"]
    text = meter.prometheus()
    for name in ("queued_frames", "queue_wait_s", "cpu_s_decode"):
        assert f"\ninfercam_{name}_total " in text


# -- a live serve on the CPU ---------------------------------------------


@pytest.fixture(scope="module")
def detector():
    return Detector(DetectorConfig(compute_dtype="float32"),
                    weights=str(WEIGHTS), device="cpu")


async def _until(cond, *, timeout=60.0, desc=""):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"not met within {timeout}s: {desc}")
        await asyncio.sleep(0.02)


async def _open(port: int, path: str):
    """A viewer of ``path``: (its connection, the task that reads it)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()

    async def read():
        while await reader.read(65536):
            pass

    return writer, asyncio.ensure_future(read())


def _subscribed(server, name: str, kind: str) -> bool:
    table = {"inferred": server.router._inferred,
             "detections": server.router._detections}[kind]
    chan = table.get(stream_key(name))
    return chan is not None and chan.receiver_count >= 1


@pytest.fixture(scope="module")
def ycbcr_serve(detector):
    """A ``ycbcr`` serve with device annotation (a detection viewer on one
    stream, a ``/face_stream`` viewer on another): the spans recorded,
    the Meter totals' deltas over the serve, the frames handed to the
    decode stage, and each unit's ``tick_batch`` latency."""
    datas = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]
    ticks = []
    tick_batch = METER.tick_batch

    def tap_tick(batch_size, latency_s):
        ticks.append(latency_s)
        tick_batch(batch_size, latency_s)

    async def run():
        server = await start_server(
            ServerConfig(http_address="127.0.0.1:0",
                         socket_address="127.0.0.1:0"),
            engine_config=EngineConfig(
                batch_buckets=(1, 2, 4), decode_mode="ycbcr",
                annotate_mode="device", decode_scale=2,
                coalesce_streams=False, queue_capacity=16),
            detector=detector)
        gathered = []
        decode = server.worker._decode

        def tap_decode(jobs):
            gathered.append(len(jobs))
            return decode(jobs)

        server.worker._decode = tap_decode
        try:
            port = server.http_port
            viewers = [await _open(port, "/detections?name=d"),
                       await _open(port, "/face_stream?name=f")]
            await _until(lambda: _subscribed(server, "d", "detections")
                         and _subscribed(server, "f", "inferred"),
                         desc="viewers")
            METER.drain()
            base = dict(METER.totals)
            frames = [(name, data) for name in ("d", "f") for data in datas]

            class Source:
                def __init__(self, name):
                    self.name = name

                async def frames(self):
                    for name, data in frames:
                        if name == self.name:
                            yield data

            address = f"127.0.0.1:{server.socket_port}"
            await asyncio.gather(*(send_stream(
                Source(name), ClientConfig(address=address, channel=name))
                for name in ("d", "f")))
            await _until(lambda: sum(gathered) == len(frames)
                         and sum(1 for s in spans if s[0] == "e2e")
                         >= len(frames), desc="every frame published")
            METER.drain()
            cur = dict(METER.totals)
            for writer, task in viewers:
                writer.close()
                task.cancel()
            return base, cur, sum(gathered)
        finally:
            await server.close()

    spans = _tap(STAGES)
    METER.tick_batch = tap_tick
    try:
        base, cur, gathered = asyncio.run(run())
    finally:
        del METER.tick_batch, STAGES.record
    delta = {k: cur[k] - base.get(k, 0) for k in cur}
    return {"spans": spans, "delta": delta, "gathered": gathered,
            "ticks": ticks}


def test_serve_leaves_every_new_meter_total(ycbcr_serve):
    delta = ycbcr_serve["delta"]
    for name in CPU_TOTALS + QUEUE_TOTALS:
        assert name in delta and delta[name] >= 0, name
    assert delta["queued_frames"] == ycbcr_serve["gathered"] > 0
    # the device thread's CPU inside its spans is at most their wall
    device_wall = sum(b - a for name, a, b in ycbcr_serve["spans"]
                      if name.startswith("device"))
    assert 0 < delta["cpu_s_device"] <= device_wall + 1e-3


def test_serve_records_each_new_span_under_a_new_name(ycbcr_serve):
    names = {name for name, _, _ in ycbcr_serve["spans"]}
    assert set(NEW_SPANS) <= names
    for name in NEW_SPANS:
        assert not name.startswith("device") and name not in ("decode",
                                                                "e2e")


def test_device_stage_times_its_batch_latency_once(ycbcr_serve):
    """``tick_batch`` gets the device span's own duration."""
    device = [b - a for name, a, b in ycbcr_serve["spans"]
              if name.startswith("device")]
    assert len(device) == len(ycbcr_serve["ticks"]) > 0
    assert device == pytest.approx(ycbcr_serve["ticks"])
