"""One run of one cell: the port's server under the cell's traffic.

Set-up (all counted in ``setup_s``): the streams' frames and the weights
from the seed, the detector, `serving.app.start_server` with the cell's
settings (``link_adaptive`` off, the decode, annotate and tiled upload
modes fixed, the warm-up at the cell's resolution and buckets), the load
generator's process, in a traced run the device trace, and
``warm_traffic_s`` of the cell's own traffic. Then the window of
``seconds``. Then, outside every timing: the device's memory peak, the
server closed, and the reference run over every frame the streams sent
to judge every record that answers a frame sent in the window.

The harness reads the program from outside: the ``Meter``'s counters as
deltas over the window, every ``STAGES`` sample as it is recorded (the
meter's own drains keep only a reservoir), the router's submissions, the
process's CPU time over the window and, traced, the device trace.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import pathlib
import resource
import sys
import time

import torch

from harness import compare, frames, trace, weights, work
from reference import ultraface as ref

LOADGEN = pathlib.Path(__file__).resolve().parent / "loadgen.py"
# seconds past the window's end allowed for its last frames to publish
DRAIN_S = 60.0


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    cfg: dict
    traffic: dict
    setup_s: float
    t0: float
    t1: float
    meter: dict          # Meter totals' deltas over the window
    submitted: list      # router submission times (monotonic)
    spans: list          # (stage, start, end) of every STAGES sample
    load: dict           # the load generator's report
    device: dict
    server_cpu_s: float = 0.0  # CPU seconds the server used in the window
    trace: dict | None = None
    work: dict | None = None
    checks: dict | None = None

    def spans_in(self, *names: str, start: float | None = None,
                 end: float | None = None) -> list[float]:
        """Durations of the samples of ``names`` (a name ending in ``*``
        is a prefix) that ended in [start, end] (default: the window)."""
        lo = self.t0 if start is None else start
        hi = self.t1 if end is None else end
        out = []
        for name, a, b in self.spans:
            if lo <= b <= hi and any(
                    name == n or (n.endswith("*") and name.startswith(n[:-1]))
                    for n in names):
                out.append(b - a)
        return out

    def received(self) -> int:
        """Frames the server received in the window (routed to the
        worker, dropped or not)."""
        return sum(self.t0 <= t < self.t1 for t in self.submitted)

    def latencies(self) -> list[float]:
        """The ``e2e`` seconds of the frames received in the window and
        published (up to the drain after it)."""
        return sorted(b - a for name, a, b in self.spans
                      if name == "e2e" and self.t0 <= a < self.t1)


def engine_config(traffic: dict):
    from infercam_onnx_tpu_torch.config import EngineConfig

    return EngineConfig(
        batch_buckets=tuple(traffic["batch_buckets"]),
        queue_capacity=traffic["queue_capacity"],
        batch_window_ms=traffic["batch_window_ms"],
        coalesce_streams=traffic["coalesce_streams"],
        decode_scale=traffic["decode_scale"],
        decode_mode=traffic["decode_mode"],
        annotate_mode=traffic["annotate_mode"],
        link_adaptive=False,
        tiled_upload=traffic["tiled_upload"],
        tile_min_pixels=traffic["tile_min_pixels"],
        tile_grid=tuple(traffic["tile_grid"]),
        tile_overlap=traffic["tile_overlap"])


def _taps(server):
    """Record every STAGES sample (stage, start, end) and every router
    submission's time; returns them and an undo."""
    from infercam_onnx_tpu_torch.utils.profiling import STAGES

    spans, submitted = [], []
    record = STAGES.record
    submit = server.router._submit_infer

    def tap_record(name, seconds):
        end = time.monotonic()
        spans.append((name, end - seconds, end))
        record(name, seconds)

    def tap_submit(job):
        submitted.append(time.monotonic())
        return submit(job)

    STAGES.record = tap_record
    server.router._submit_infer = tap_submit

    def undo():
        STAGES.record = record
        server.router._submit_infer = submit

    return spans, submitted, undo


def _own_cpu_s() -> float:
    """CPU seconds this process (every thread of the server) has used."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_utime + usage.ru_stime


def _meter_totals() -> dict:
    from infercam_onnx_tpu_torch.serving.meter import METER

    METER.drain()  # adds the counts since the last drain into the totals
    return dict(METER.totals)


def _unsettled(spans: list, submitted: list, base: dict, t0: float,
               t1: float) -> int:
    """Frames received in [t0, t1] that are neither published (an ``e2e``
    sample) nor counted as shed since t0."""
    received = sum(t0 <= t < t1 for t in submitted)
    published = sum(name == "e2e" and t0 <= a < t1 for name, a, _ in spans)
    shed = _meter_totals().get("dropped", 0) - base.get("dropped", 0)
    return received - published - shed


async def _sleep_until(t: float) -> None:
    delay = t - time.monotonic()
    if delay > 0:
        await asyncio.sleep(delay)


async def run_window(cfg: dict, traffic: dict, traffic_path: pathlib.Path,
                     seed: int, seconds: float, *, device: torch.device,
                     t_process: float, traced: bool = False,
                     program_fault=None) -> Run:
    """Set up, serve the window, close; the reference is not run here.
    ``traced``: on a card the device trace runs through the window (the
    per-layer metrics read it; the end-to-end ones are taken with it
    off). ``program_fault``: a function that wraps the worker's device
    program (the fault tests)."""
    from infercam_onnx_tpu_torch.config import DetectorConfig, ServerConfig
    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.serving.app import start_server

    jpegs = frames.stream_jpegs(traffic, seed)
    grid = tuple(traffic["tile_grid"]) if traffic["tile_min_pixels"] else None
    # the weights are calibrated on each camera's first frame
    inputs = ref.network_inputs(cfg, [s[0] for s in jpegs],
                                scale=traffic["decode_scale"],
                                device=device, tile_grid=grid,
                                tile_overlap=traffic["tile_overlap"])
    params = weights.make_params(cfg, seed, device, inputs)
    del inputs
    detector = Detector(DetectorConfig(
        variant=cfg["variant"], min_confidence=cfg["min_confidence"],
        max_iou=cfg["max_iou"], top_k=cfg["top_k"],
        max_detections=cfg["max_detections"],
        compute_dtype=cfg["compute_dtype"]),
        params=weights.as_numpy(params), device=device)
    server = await start_server(
        ServerConfig(http_address="127.0.0.1:0", socket_address="127.0.0.1:0"),
        engine_config=engine_config(traffic), detector=detector,
        warmup_resolutions=[(traffic["frame_height"], traffic["frame_width"])],
        device=device, data_parallel="off")
    if program_fault is not None:
        server.worker._program = program_fault(server.worker._program)
    spans, submitted, undo = _taps(server)
    proc = await asyncio.create_subprocess_exec(
        sys.executable, str(LOADGEN), "--http-port", str(server.http_port),
        "--socket-port", str(server.socket_port), "--traffic",
        str(traffic_path), "--seed", str(seed),
        stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
        limit=1 << 30)  # the report is one line
    try:
        line = await asyncio.wait_for(proc.stdout.readline(), 120)
        if line.strip() != b"ready":
            raise RuntimeError(f"the load generator did not start: {line!r}")
        dev_trace = None
        if traced and device.type == "cuda":
            # started before the traffic: starting the profiler blocks the
            # event loop for seconds
            dev_trace = trace.DeviceTrace()
            dev_trace.start()
        t_send = time.monotonic() + 0.1
        t0 = t_send + traffic["warm_traffic_s"]
        t1 = t0 + seconds
        proc.stdin.write(f"start {t_send} {t0} {t1}\n".encode())
        await proc.stdin.drain()
        await _sleep_until(t0)
        base = _meter_totals()
        setup_s = time.monotonic() - t_process
        cpu0 = _own_cpu_s()
        await _sleep_until(t1)
        cur = _meter_totals()
        server_cpu_s = _own_cpu_s() - cpu0
        if dev_trace is not None:
            dev_trace.stop(t0, t1)
        # the senders stop at t1: wait until every frame received in the
        # window is published or shed (a late answer is late, not lost)
        deadline = time.monotonic() + DRAIN_S
        while (time.monotonic() < deadline
               and _unsettled(spans, submitted, base, t0, t1) > 0):
            await asyncio.sleep(0.1)
        proc.stdin.write(b"finish\n")
        await proc.stdin.drain()
        line = await asyncio.wait_for(proc.stdout.readline(), 60)
        load = json.loads(line)
    finally:
        if proc.returncode is None:
            proc.stdin.close()
        await asyncio.wait_for(proc.wait(), 60)
        undo()
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (
                       torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)}
    run = Run(cfg=cfg, traffic=traffic, setup_s=setup_s, t0=t0, t1=t1,
              meter={k: cur.get(k, 0) - base.get(k, 0) for k in cur},
              submitted=submitted, spans=spans, load=load,
              device=device_info,
              server_cpu_s=server_cpu_s)
    if dev_trace is not None:
        run.trace = trace.reduce(dev_trace.kernels(), dev_trace.t0,
                                 dev_trace.t1, spans)
        run.trace["t0"], run.trace["t1"] = dev_trace.t0, dev_trace.t1
    await server.close()
    del server, detector
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.work = {"params": params}
    return run


def references(cfg: dict, traffic: dict, seed: int, params: dict,
               device: torch.device, *, control: str | None = None) -> dict:
    """{stream name: [(conf, boxes, detections) of each sensor-noise
    draw]} by the reference in the configuration's precision, or with
    ``control`` in a precision below it ("tf32": the resample's operands
    in TF32; "bf16": the resample in bfloat16; "fp8": the trunk in float8
    e4m3)."""
    from harness.loadgen import stream_name

    dtype = getattr(torch, cfg["compute_dtype"])
    net = ref.Network(params, cfg, dtype=dtype, fp8=control == "fp8")
    grid = tuple(traffic["tile_grid"]) if traffic["tile_min_pixels"] else None
    out = {}
    for k, draws in enumerate(frames.stream_jpegs(traffic, seed)):
        out[stream_name(k)] = []
        for data in draws:
            resample = control if control in ("tf32", "bf16") else "float32"
            rgb = ref.decode_rgb(data, traffic["decode_scale"], resample)
            conf, boxes = ref.candidates(
                net, cfg, rgb, device=device, tile_grid=grid,
                tile_overlap=traffic["tile_overlap"], resample=resample)
            out[stream_name(k)].append((conf, boxes,
                                        ref.nms(conf, boxes, cfg)))
    return out


def as_record(dets: list, size) -> dict:
    """Detections as a ``/detections`` record (without its timestamp)."""
    return {"width": size[0], "height": size[1],
            "detections": [{"bbox": [float(v) for v in box],
                            "confidence": c} for box, c in dets]}


def decoded_size(traffic: dict) -> tuple[int, int]:
    s = traffic["decode_scale"]
    return traffic["frame_width"] // s, traffic["frame_height"] // s


def pair(run: Run, refs: dict) -> tuple[list, int]:
    """Each record paired with the frame it answers (`compare.assign`):
    ``[(stream, draw, record, size)]`` of the records that answer a frame
    sent in the window, and the number of records (of the whole run) that
    answer none."""
    judged, unmatched = [], 0
    size = decoded_size(run.traffic)
    for stream, records in run.load["records"].items():
        sent_at = run.load["sent_at"][stream]
        draws = [dets for _, _, dets in refs[stream]]
        for (_, record), j in zip(records,
                                  compare.assign(records, sent_at, draws)):
            if j is None:
                unmatched += 1
            elif run.t0 <= sent_at[j] < run.t1:
                judged.append((stream, j % len(draws), record, size))
    return judged, unmatched


def judge(run: Run, seed: int, device: torch.device) -> dict:
    """The numbers `correct` compares: every record that answers a frame
    sent in the window against the reference's answer for that frame."""
    refs = references(run.cfg, run.traffic, seed, run.work["params"], device)
    judged, unmatched = pair(run, refs)
    out = compare.compare(judged, refs, run.cfg)
    out["unmatched"] = float(unmatched)
    return out


def work_counts(run: Run, device: torch.device) -> dict:
    """Per-frame work of the cell (traced runs)."""
    flops_f32, bytes_resize = work.resample_flops(run.cfg, run.traffic)
    return {"resize_flops": flops_f32, "resize_bytes": bytes_resize,
            "trunk_flops": work.trunk_flops(run.cfg, run.traffic,
                                            run.work["params"], device),
            "nms_bytes": work.nms_bytes(run.cfg)}
