"""Headline benchmark of the port: frames/s per card, UltraFace-320 over
16 streams of 640x480 (the counterpart of the root ``bench.py``).

    python -m infercam_onnx_tpu_torch.bench [--device cuda|cpu]
        [--anchors PATH]

It measures BASELINE.json's north-star configuration on one GPU: 16
concurrent 640x480 streams micro-batched into one device program, against
a CPU baseline that mirrors the reference's tract pipeline (one frame at a
time: decode, the same resize matrices, the conv stack in float32 on the
CPU, the NumPy reference NMS). The phases, their order, the MUST set with
its estimates and the JSON keys are the JAX bench's:

- ``cpu_baseline``; ``detector_init``;
- ``anchor`` (`bench_anchor`): FLOPs per frame, the on-chip time of a
  batch of 64 (``onchip_ms_per_batch``, ``mfu_pct``), the device-resident
  dispatch rate of a batch of 16 (``device_only_fps``) and their
  difference per batch (``anchor_dispatch_ms``);
- ``pipeline`` (`bench_gpu`): the 3-deep pipeline (decode + upload on a
  thread || dispatch || readback) on packed YCbCr planes and on host RGB,
  the device-annotated and host-annotated output paths, and a p50 of one
  unpipelined batch;
- ``annotate_fullres``: the splice transcode against host draw + encode
  at full resolution;
- ``serving_window``, ``latency_preset``, ``lossless``: the real server
  (`serving.app.start_server`) in this process under replay senders;
- ``tiled_core``: 1080p through `parallel.tiling.TiledDetector`, both
  upload routes, RGB and the device ceiling, beside the link probe's A/B
  pick;
- the optional ``lossless_depth2`` and ``deep_queue_latency``, run when the
  budget after the MUST phases' reserve covers them.

Every phase drives the hand NMS kernel (``csrc/nms.cu``) on a GPU; the
line reports its launches (``nms_launches``). ``--device cpu`` runs the
same phases on the CPU (the tests use that); a CUDA device with no GPU
raises.

Prints ONE JSON line on stdout (progress goes to stderr): the JAX bench's
keys plus ``device`` (the card's name), ``power_limit`` (``nvidia-smi``'s),
``flops_per_frame_f32`` and ``flops_per_frame_bf16`` (the FLOPs split by
the operands' dtype) and ``nms_launches``. Where it differs from the JAX
bench by design:

- a phase that fails, or a MUST phase skipped at the hard wall, is
  labelled in ``skipped_phases`` (``name:failed``, ``name``) as there, and
  the line still prints, but the exit code is 1; a phase is not retried;
- a signal (SIGTERM, or the SIGALRM of ``BENCH_TOTAL_WALL_S``) prints the
  snapshot of what was measured, labelled ``partial``, and exits 1;
- the anchor row goes to ``--anchors PATH`` (one JSON line appended) and
  nowhere else; by default no file is written;
- the servers bind free ports (port 0);
- the on-chip time is the device busy time per iteration: the sum of the
  kernel durations that torch.profiler (CUPTI) records over K back-to-back
  calls on a device-resident input perturbed by the call's index (the JAX
  bench loops the program K times inside one executable). On the CPU it
  is the host clock's time per call;
- ``latch_s`` is the time of the first operation on the device (CUDA
  context creation); ``h2d_probe_mbps`` is `serving.link.probe_h2d_mbps`
  (4 MB pinned), ``slow_link`` its 250 MB/s threshold;
- the device phases' weights are the random ones the JAX detector falls
  back to offline, ``init_params(0, background_bias=0.75)``, given
  explicitly (the weights chain would try a download); the CPU baseline
  runs the port's own model on ``init_params(0, background_bias=2.0)``,
  which keeps the detections sparse, where the JAX baseline runs a torch
  twin (torch's own init, +4 on the background logits) that is not part
  of the port;
- the frames are the synthetic pictures in ``resources/test_pics_synthetic``
  padded with seeded noise frames (the JAX bench reads a directory of
  reference photos first where the machine has one).

Environment knobs (the JAX bench's): ``BENCH_BATCH`` (16),
``BENCH_SECONDS`` (8), ``BENCH_BUDGET_S`` (420), ``BENCH_HARD_WALL_S``
(900), ``BENCH_TOTAL_WALL_S`` (1440).
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import datetime
import io
import json
import os
import pathlib
import queue as pyqueue
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from PIL import Image

from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.client.sender import ReplaySource, send_stream
from infercam_onnx_tpu_torch.config import (ClientConfig, DetectorConfig,
                                            EngineConfig, ServerConfig,
                                            resolve_device)
from infercam_onnx_tpu_torch.detector import (Detector, detect_program,
                                              pack_coefficient_batch)
from infercam_onnx_tpu_torch.draw import draw_detections
from infercam_onnx_tpu_torch.models import ultraface as uf
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops import nms
from infercam_onnx_tpu_torch.ops import reference_impl as ref
from infercam_onnx_tpu_torch.ops.jpeg_device import read_coefficient_batch
from infercam_onnx_tpu_torch.ops.jpeg_encode_device import (splice_blocks,
                                                            split_coefs)
from infercam_onnx_tpu_torch.ops.preprocess import (MEAN, STD,
                                                    triangle_resize_matrix)
from infercam_onnx_tpu_torch.parallel.tiling import TiledDetector
from infercam_onnx_tpu_torch.serving import link
from infercam_onnx_tpu_torch.serving.app import start_server
from infercam_onnx_tpu_torch.serving.meter import METER
from infercam_onnx_tpu_torch.utils.profiling import STAGES

REPO = pathlib.Path(__file__).resolve().parent.parent
SYNTH_PICS = REPO / "resources" / "test_pics_synthetic"
METRIC = ("fps/chip, UltraFace-320, 16x 640x480 streams micro-batched "
          "(decode+preproc+CNN+NMS)")
# The random weights of the device phases (the JAX detector's offline
# fallback).
BACKGROUND_BIAS = 0.75
# The CPU baseline's background bias: sparse detections, as real weights
# give (fewer than 16 a synthetic picture; with 0.75 more than 64,
# tests/test_torch_port_bench.py), so the reference's Python NMS, quadratic
# in them, does not set the baseline's pace; the JAX baseline biases its
# torch twin by +4 for the same reason.
BASELINE_BIAS = 2.0
# Dense bf16 tensor-core peaks (NVIDIA data sheets) by card name.
BF16_PEAKS = (("H100 PCIe", 756.5e12), ("H100 80GB HBM3", 989.4e12),
              ("H100 SXM", 989.4e12))
# MUST phases and their warm-cache estimates in seconds (the JAX bench's).
MUST_ESTIMATES = dict(cpu_baseline=12, detector_init=10, anchor=35,
                      pipeline=95, annotate_fullres=35, serving_window=60,
                      tiled_core=60, latency_preset=50, lossless=60)
SLOW_LINK_MBPS = 250.0  # EngineConfig.link_healthy_h2d_mbps
PIPELINE_DEPTH = 3


def note(msg: str) -> None:
    """A progress line on stderr (stdout holds the one JSON line)."""
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _jpeg(im, quality: int = 90) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _load_frames(n_streams: int = 16) -> list[bytes]:
    """640x480 quality-90 JPEGs of the synthetic pictures (sorted), padded
    to ``n_streams`` with noise frames from ``default_rng(0)``."""
    frames = []
    for f in sorted(os.listdir(SYNTH_PICS)):
        if f.lower().endswith(".jpg"):
            with Image.open(SYNTH_PICS / f) as im:
                frames.append(_jpeg(im.convert("RGB").resize(
                    (640, 480), Image.BILINEAR)))
    rng = np.random.default_rng(0)
    while len(frames) < n_streams:
        arr = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
        frames.append(_jpeg(Image.fromarray(arr)))
    return frames[:n_streams]


def _hd_frames(count: int = 4) -> list[bytes]:
    """1080p quality-90 JPEGs: the first ``count`` frames upscaled."""
    out = []
    for f in _load_frames(count):
        with Image.open(io.BytesIO(f)) as im:
            out.append(_jpeg(im.convert("RGB").resize((1920, 1080),
                                                      Image.BILINEAR)))
    return out


def random_params(variant: str = "RFB-320",
                  background_bias: float = BACKGROUND_BIAS) -> dict:
    """The weights the device phases run: ``init_params(0,
    background_bias=0.75)`` of the variant's arch."""
    return uf.init_params(0, background_bias=background_bias,
                          arch=uf.arch_of(variant))


def make_detector(device: torch.device,
                  variant: str = "RFB-320") -> Detector:
    return Detector(DetectorConfig(variant=variant),
                    params=random_params(variant), device=device)


# -- device time and FLOPs -------------------------------------------------


def device_time(fn, iters: int, device: torch.device) -> dict:
    """``fn(i)`` for i in 0..iters-1, back to back after one warm call.

    On a GPU: ``busy_ms``, the sum of the kernel durations torch.profiler
    (CUPTI) records over the window, per call; ``wall_ms``, CUDA events
    around the same window, per call; ``source`` "cupti". Raises where the
    trace holds no device time. On the CPU: both are the host clock's time
    per call, ``source`` "host_clock"."""
    fn(0)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        ms = (time.perf_counter() - t0) / iters * 1e3
        return {"busy_ms": ms, "wall_ms": ms, "source": "host_clock"}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        torch.cuda.synchronize(device)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if not busy_us:
        raise RuntimeError("the profiler recorded no device time")
    return {"busy_ms": busy_us / iters / 1e3,
            "wall_ms": start.elapsed_time(end) / iters, "source": "cupti"}


def count_flops(fn) -> tuple[int, dict[str, int]]:
    """FLOPs of one call of ``fn()``: the total from
    ``torch.utils.flop_counter.FlopCounterMode`` and the same ops' FLOPs
    split by the dtype of their first tensor operand."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    by_dtype: collections.Counter = collections.Counter()

    class ByDtype(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            formula = flop_registry.get(func._overloadpacket)
            if formula is None and func is not torch.ops.prim.device.default:
                # a composite op (matmul under inference mode): count the
                # ops it decomposes into, as FlopCounterMode does
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            if formula is not None:
                first = next(a for a in args if isinstance(a, torch.Tensor))
                by_dtype[str(first.dtype).removeprefix("torch.")] += int(
                    formula(*args, **kwargs, out_val=out))
            return out

    counter = FlopCounterMode(display=False)
    with counter, ByDtype():
        fn()
    return counter.get_total_flops(), dict(by_dtype)


def bf16_peak(device_name: str) -> float | None:
    return next((v for k, v in BF16_PEAKS if k in device_name), None)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def power_limit() -> str | None:
    """The first card's power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` prints it; None where nvidia-smi does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        note(f"nvidia-smi did not run: {e!r}")
        return None
    line = out.strip().splitlines()[0] if out.strip() else ""
    return line.split(",", 1)[1].strip() if "," in line else None


# -- host <-> device transfers ---------------------------------------------


class _Transfers:
    """The serving worker's transfer discipline (``serving/inferer.py``):
    uploads from pinned host tensors on a copy stream, the program on a
    compute stream that waits for them, readbacks into pinned host
    tensors and an event to wait on. On the CPU, plain tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy = torch.cuda.Stream(device) if self.cuda else None
        self.compute = torch.cuda.Stream(device) if self.cuda else None

    def upload(self, arrays: list[np.ndarray]):
        """``arrays`` on the device (uint16 as int32) and the event after
        which they are there (None on the CPU)."""
        hosts = [torch.from_numpy(np.ascontiguousarray(
            a.astype(np.int32) if a.dtype == np.uint16 else a))
            for a in arrays]
        if not self.cuda:
            return hosts, None
        with torch.cuda.stream(self.copy):
            devs = [h.pin_memory().to(self.device, non_blocking=True)
                    for h in hosts]
            ready = torch.cuda.Event()
            ready.record(self.copy)
        for d in devs:
            d.record_stream(self.compute)
        return devs, ready

    def run(self, ready, program):
        """``program()``'s outputs (a tensor or a tuple) copied back into
        host tensors, and the event after which they may be read."""
        if not self.cuda:
            outs = program()
            return (outs if isinstance(outs, tuple) else (outs,)), None
        with torch.cuda.stream(self.compute):
            if ready is not None:
                self.compute.wait_event(ready)
            outs = program()
            hosts = []
            for out in (outs if isinstance(outs, tuple) else (outs,)):
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                hosts.append(host)
            done = torch.cuda.Event()
            done.record(self.compute)
        return tuple(hosts), done

    @staticmethod
    def wait(done) -> None:
        if done is not None:
            done.synchronize()


def _producer(make_item, depth: int):
    """A daemon thread that puts ``make_item(i)`` (i counting batches)
    into a queue of ``depth``; returns (queue, stop event). An error stops
    the thread and is put on the queue, where `_get` raises it."""
    q: pyqueue.Queue = pyqueue.Queue(maxsize=depth)
    stop = threading.Event()

    def loop():
        i = 0
        while not stop.is_set():
            try:
                item = make_item(i)
            except Exception as e:  # surfaced by _get
                item = e
            while not stop.is_set():
                try:
                    q.put(item, timeout=1.0)
                    break
                except pyqueue.Full:
                    continue
            if isinstance(item, Exception):
                return
            i += 1

    threading.Thread(target=loop, daemon=True).start()
    return q, stop


def _get(q: pyqueue.Queue):
    item = q.get(timeout=120.0)
    if isinstance(item, Exception):
        raise item
    return item


def _batch_of(frames: list[bytes], i: int, batch: int) -> list[bytes]:
    return [frames[(i * batch + j) % len(frames)] for j in range(batch)]


def _pipelined_fps(xfer: _Transfers, make, dispatch, *, batch: int,
                   seconds: float, queue_depth: int) -> float:
    """Frames/s over ``seconds`` of ``dispatch(*item)`` on the items a
    `_producer` thread makes (up to ``queue_depth`` ready), with two
    batches' readbacks in flight: decode + upload || dispatch ||
    readback. One warm batch goes first."""
    q, stop = _producer(make, queue_depth)
    try:
        xfer.wait(dispatch(*_get(q))[1])
        pending: collections.deque = collections.deque()
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            pending.append(dispatch(*_get(q))[1])
            while len(pending) > 2:
                xfer.wait(pending.popleft())
                done += batch
        while pending:
            xfer.wait(pending.popleft())
            done += batch
        return done / (time.perf_counter() - t0)
    finally:
        stop.set()


def _pipeline_fps(detector: Detector, frames: list[bytes], *, mode: str,
                  batch: int, seconds: float, decode_scale: int = 2
                  ) -> float:
    """Throughput of the 3-stage pipeline: decode + upload (thread) ||
    dispatch || readback. ``mode``: "ycbcr" (packed planes) or "pixels"
    (host RGB decode)."""
    n = native_jpeg.load()
    xfer = _Transfers(detector.device)

    def make(i):
        datas = _batch_of(frames, i, batch)
        if mode == "ycbcr":
            packed, geom = n.decode_ycbcr_batch(datas, scale=decode_scale)
            return (*xfer.upload([packed]), geom)
        imgs = np.stack(codec.decode_batch(datas, scale=decode_scale))
        return (*xfer.upload([imgs]), None)

    def dispatch(arrs, ready, geom):
        if mode == "ycbcr":
            return xfer.run(ready, lambda: detector.run_device_ycbcr_packed(
                arrs[0], geom, pack_output=True))
        return xfer.run(ready, lambda: detector.run_device(
            arrs[0], pack_output=True))

    return _pipelined_fps(xfer, make, dispatch, batch=batch,
                          seconds=seconds, queue_depth=PIPELINE_DEPTH)


def _annotated_fps(detector: Detector, frames: list[bytes], *, mode: str,
                   batch: int, seconds: float, decode_scale: int = 2,
                   quality: int = 95) -> float:
    """End-to-end annotated-output throughput (the /face_stream path): per
    frame, a finished annotated JPEG on the host.

    "device": packed planes up, detect + overlay + FDCT/quantize on the
    device, the host entropy-codes. "splice": the coefficient transcode at
    full resolution: 12-bit packed blocks up, only the blocks the overlay
    touched down, the host splices them into its own coefficients and
    entropy-codes (a frame over the block budget, or with two chroma
    tables, pays the host decode + draw + encode, as the server does).
    "host": host RGB decode, device detection, host draw + encode. The
    host tail runs on a finisher thread of its own; the device work stays
    on this thread."""
    n = native_jpeg.load()
    quant = n.quant_tables(quality)
    splice_k = EngineConfig.annotate_splice_blocks  # the server's default
    xfer = _Transfers(detector.device)

    def make(i):
        datas = _batch_of(frames, i, batch)
        if mode == "device":
            packed, geom = n.decode_ycbcr_batch(datas, scale=decode_scale)
            return (*xfer.upload([packed]), geom, None)
        if mode == "splice":
            planes = read_coefficient_batch(datas)
            packed12, q, shapes = pack_coefficient_batch(*planes[:4])
            return (*xfer.upload([packed12, q]), shapes, (planes, datas))
        imgs = np.stack(codec.decode_batch(datas, scale=decode_scale))
        return (*xfer.upload([imgs]), None, imgs)

    def dispatch(arrs, ready, geom, host):
        if mode == "device":
            return xfer.run(ready, lambda: detector.run_device_ycbcr_annotated(
                arrs[0], geom, quality=quality))
        if mode == "splice":
            planes = host[0]
            return xfer.run(
                ready,
                lambda: detector.run_device_coefficients_annotated_packed(
                    arrs[0], arrs[1], wh=planes[4], shapes=geom,
                    sampling=planes[5], k=splice_k))
        return xfer.run(ready, lambda: detector.run_device(
            arrs[0], pack_output=True))

    def host_annotate(img, pdet_row):
        cnt = int(pdet_row[:, 5].sum())
        dets = [(pdet_row[d, :4], float(pdet_row[d, 4]))
                for d in range(cnt)]
        codec.encode_rgb(draw_detections(img, dets), quality, "420")

    def finish(outs, done, geom, host) -> int:
        """The host tail of one batch; returns its frame count."""
        xfer.wait(done)
        outs = [o.numpy() for o in outs]
        pdet = outs[-1]
        for i in range(pdet.shape[0]):
            if mode == "device":
                yq, cbq, crq = split_coefs(outs[0][i], geom)
                n.encode_coefs(yq, cbq, crq, (geom["width"], geom["height"]),
                               geom["sampling"], quant)
            elif mode == "splice":
                (y, cb, cr, qt, wh, samp), datas = host
                blocks, meta = outs[0][i], outs[1][i]
                if (int(meta[0]) <= splice_k
                        and np.array_equal(qt[i][1], qt[i][2])):
                    ys, cbs, crs = splice_blocks(y[i], cb[i], cr[i], meta,
                                                 blocks)
                    n.encode_coefs(ys, cbs, crs, wh, samp, qt[i][:2])
                else:
                    host_annotate(codec.decode_rgb(datas[i]), pdet[i])
            else:
                host_annotate(host[i], pdet[i])
        return pdet.shape[0]

    q, stop = _producer(make, PIPELINE_DEPTH)
    finishq: pyqueue.Queue = pyqueue.Queue(maxsize=2)
    count = [0]
    errors: list[BaseException] = []

    def finisher():
        while True:
            item = finishq.get()
            if item is None:
                return
            try:
                count[0] += finish(*item)
            except Exception as e:  # surfaced on the dispatching thread
                errors.append(e)
                return

    try:
        arrs, ready, geom, host = _get(q)
        finish(*dispatch(arrs, ready, geom, host), geom, host)  # warm
        ft = threading.Thread(target=finisher, daemon=True)
        ft.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and not errors:
            arrs, ready, geom, host = _get(q)
            outs, done = dispatch(arrs, ready, geom, host)
            while ft.is_alive():
                try:
                    finishq.put((outs, done, geom, host), timeout=1.0)
                    break
                except pyqueue.Full:
                    continue
        while ft.is_alive():
            try:
                finishq.put(None, timeout=1.0)
                break
            except pyqueue.Full:
                continue
        ft.join(timeout=120.0)
        if errors:
            raise errors[0]
        if ft.is_alive():
            raise RuntimeError("the finisher thread did not end")
        return count[0] / (time.perf_counter() - t0)
    finally:
        stop.set()


# -- phases ----------------------------------------------------------------


def bench_mfu(detector: Detector, *, batch: int = 64,
              iters: int = 30) -> dict:
    """FLOPs of the detect program (FlopCounterMode over one call) and its
    on-chip time (`device_time` over ``iters`` calls on a resident batch,
    perturbed by the call's index), as a share of the card's dense bf16
    peak where the card's name is known."""
    dev = detector.device
    h, w = detector.height * 2, detector.width * 2
    r_h, r_w = detector.preprocessor.matrices(w, h)
    images = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=dev)
    thresholds = detector._thresholds()

    def step(i):
        return detect_program(detector.model, detector.priors,
                              images + i % 256, r_h, r_w, pack_output=True,
                              **thresholds)

    flops, by_dtype = count_flops(lambda: step(0))
    t = device_time(step, iters, dev)
    onchip_ms = t["busy_ms"]
    onchip_fps = batch / onchip_ms * 1e3
    out = {
        "flops_per_frame": round(flops / batch),
        "flops_per_frame_f32": round(by_dtype.get("float32", 0) / batch),
        "flops_per_frame_bf16": round(by_dtype.get("bfloat16", 0) / batch),
        "onchip_fps": round(onchip_fps, 1),
        "onchip_ms_per_batch": round(onchip_ms, 3),
        "onchip_wall_ms_per_batch": round(t["wall_ms"], 3),
        "onchip_time_source": t["source"],
        "mfu_batch": batch,
    }
    achieved = flops / batch * onchip_fps
    out["achieved_tflops"] = round(achieved / 1e12, 2)
    peak = bf16_peak(device_name(dev)) if dev.type == "cuda" else None
    if peak:
        out["mfu_pct"] = round(achieved / peak * 100, 2)
    return out


def bench_anchor(detector: Detector, *, batch: int = 16,
                 decode_scale: int = 2, mfu_batch: int = 64) -> dict:
    """The fixed anchor triplet: ``onchip_ms_per_batch`` (batch 64, device
    busy time: moves only with the compute path), ``device_only_fps``
    (batch 16, resident input, 50 dispatches back to back, one wait: adds
    the dispatch path) and ``anchor_dispatch_ms``, the wall per batch-16
    program minus its on-chip share (the host's dispatch cost);
    ``h2d_probe_mbps`` (from `main`) is the transfer layer."""
    mfu = bench_mfu(detector, batch=mfu_batch)
    dev = detector.device
    h0, w0 = 480 // decode_scale, 640 // decode_scale
    resident = torch.zeros((batch, h0, w0, 3), dtype=torch.uint8,
                           device=dev)
    detector.run_device(resident, pack_output=True)
    _sync(dev)
    n_pipe = 50
    t0 = time.perf_counter()
    for _ in range(n_pipe):
        detector.run_device(resident, pack_output=True)
    _sync(dev)
    device_ms = (time.perf_counter() - t0) / n_pipe * 1e3
    onchip_b = mfu["onchip_ms_per_batch"] * (batch / mfu["mfu_batch"])
    return {
        **mfu,
        "device_compute_ms_per_batch": round(device_ms, 2),
        "device_only_fps": round(batch / (device_ms / 1e3), 1),
        "anchor_dispatch_ms": round(device_ms - onchip_b, 2),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_gpu(detector: Detector, frames: list[bytes], *,
              seconds: float = 8.0, batch: int = 16, decode_scale: int = 2,
              slow_link: bool = False, latch_s: float = 0.0) -> dict:
    """The headline pipeline windows (the JAX bench's ``bench_tpu``): a
    p50 of one unpipelined packed-plane batch with its readback, the best
    of 3 ycbcr and 2 pixels pipeline windows (1 and 1 on a slow link), and
    the device- and host-annotated output paths."""
    n = native_jpeg.load()
    packed, geom = n.decode_ycbcr_batch(frames[:batch], scale=decode_scale)
    detector.run_device_ycbcr_packed(packed, geom, pack_output=True).cpu()
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        detector.run_device_ycbcr_packed(packed, geom,
                                         pack_output=True).cpu()
        lat.append(time.perf_counter() - t0)
    lat.sort()

    def best(mode, windows):
        return max(_pipeline_fps(detector, frames, mode=mode, batch=batch,
                                 seconds=seconds, decode_scale=decode_scale)
                   for _ in range(windows))

    fps_ycbcr = best("ycbcr", 1 if slow_link else 3)
    fps_pixels = best("pixels", 1 if slow_link else 2)
    fps_annot_dev = _annotated_fps(detector, frames, mode="device",
                                   batch=batch, seconds=seconds,
                                   decode_scale=decode_scale)
    fps_annot_host = _annotated_fps(detector, frames, mode="host",
                                    batch=batch, seconds=seconds,
                                    decode_scale=decode_scale)
    return {
        "fps": max(fps_ycbcr, fps_pixels),
        "fps_ycbcr": fps_ycbcr,
        "fps_pixels": fps_pixels,
        "fps_annotated_device": fps_annot_dev,
        "fps_annotated_host": fps_annot_host,
        "latch_s": round(latch_s, 1),
        "slow_rig": slow_link,
        "p50_batch_ms": lat[len(lat) // 2] * 1e3,
        "p50_frame_ms": lat[len(lat) // 2] * 1e3 / batch,
    }


def bench_annotate_fullres(detector: Detector, frames: list[bytes], *,
                           batch: int = 16, seconds: float = 4.0) -> dict:
    """The full-resolution annotated family: the splice transcode (no
    IDCT scaling in the coefficients mode) against host annotation of
    full-resolution decodes."""
    return {
        "fps_annotated_splice_fullres": _annotated_fps(
            detector, frames, mode="splice", batch=batch, seconds=seconds),
        "fps_annotated_host_fullres": _annotated_fps(
            detector, frames, mode="host", batch=batch, seconds=seconds,
            decode_scale=1),
    }


def bench_tiled(detector: Detector, *, seconds: float = 6.0,
                batch: int = 4, full: bool = True) -> dict:
    """1080p tiled detection (BASELINE config 5), 2x2 grid, ``batch``
    streams a dispatch. The core: the serving worker's two upload routes
    of decode-scale-2 packed planes, "rows" (a copy a frame, stacked on
    the device) and "stacked" (one copy), the same geometry's RGB window
    and its device-resident ceiling, beside `serving.link`'s A/B probe and
    the route it picks. ``full`` adds the full-resolution RGB and packed
    windows and the 1080p ceiling."""
    n = native_jpeg.load()
    frames = _hd_frames()
    dev = detector.device
    tiled = TiledDetector(detector, (1920, 1080), grid=(2, 2))
    tiled_s2 = TiledDetector(detector, (960, 540), grid=(2, 2))

    def pipeline(mode: str, scale: int = 1) -> float:
        t_det = tiled_s2 if scale == 2 else tiled
        xfer = _Transfers(dev)

        def make(i):
            datas = _batch_of(frames, i, batch)
            if mode in ("ycbcr", "ycbcr_rows"):
                packed, geom = n.decode_ycbcr_batch(datas, scale=scale)
                rows = ([packed] if mode == "ycbcr"
                        else [packed[j] for j in range(len(datas))])
                return (*xfer.upload(rows), geom)
            imgs = np.stack(codec.decode_batch(datas, scale=scale))
            return (*xfer.upload([imgs]), None)

        def dispatch(arrs, ready, geom):
            if mode == "ycbcr":
                return xfer.run(ready, lambda: t_det.run_device_ycbcr_packed(
                    arrs[0], geom, pack_output=True))
            if mode == "ycbcr_rows":
                return xfer.run(ready, lambda: t_det.run_device_ycbcr_rows(
                    arrs, geom, pack_output=True))
            return xfer.run(ready, lambda: t_det.run_device(
                arrs[0], pack_output=True))

        return _pipelined_fps(xfer, make, dispatch, batch=batch,
                              seconds=seconds, queue_depth=2)

    def ceiling(t_det, h, w) -> float:
        """Device-resident rate, frames/s: 20 dispatches, one wait."""
        frame = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=dev)
        t_det.run_device(frame, pack_output=True)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            t_det.run_device(frame, pack_output=True)
        _sync(dev)
        return batch / ((time.perf_counter() - t0) / 20)

    ab_stacked_ms, ab_rows_ms = link.probe_tiled_route_ms(device=dev)
    ab_pick, _ = link.decide_tiled_route(
        "auto", 0.0, 0.0, ab_ms=(ab_stacked_ms, ab_rows_ms))
    fps_rows_s2 = pipeline("ycbcr_rows", scale=2)
    fps_ycbcr_s2 = pipeline("ycbcr", scale=2)
    dev_s2_fps = ceiling(tiled_s2, 540, 960)
    fps_rgb_s2 = pipeline("rgb", scale=2)
    winner = "rows" if fps_rows_s2 > fps_ycbcr_s2 else "stacked"
    out = {
        "tiled_1080p_rgb_scaled_fps": round(fps_rgb_s2, 1),
        "tiled_1080p_ycbcr_scaled_fps": round(fps_ycbcr_s2, 1),
        "tiled_1080p_ycbcr_rows_fps": round(fps_rows_s2, 1),
        "tiled_1080p_batch": batch,
        "tiled_1080p_device_scaled_fps": round(dev_s2_fps, 1),
        "tiled_delivered_vs_ceiling": round(
            max(fps_rows_s2, fps_ycbcr_s2) / max(dev_s2_fps, 1e-9), 3),
        "tiled_route_ab_stacked_ms": round(ab_stacked_ms, 4),
        "tiled_route_ab_rows_ms": round(ab_rows_ms, 4),
        "tiled_route_ab_pick": ab_pick,
        "tiled_route_measured_winner": winner,
        "tiled_route_ab_correct": ab_pick == winner,
    }
    best = max(fps_rows_s2, fps_ycbcr_s2, fps_rgb_s2)
    if full:
        fps_rgb = pipeline("rgb")
        fps_ycbcr = pipeline("ycbcr")
        out["tiled_1080p_rgb_fps"] = round(fps_rgb, 1)
        out["tiled_1080p_ycbcr_fps"] = round(fps_ycbcr, 1)
        out["tiled_1080p_device_fps"] = round(ceiling(tiled, 1080, 1920), 1)
        best = max(best, fps_rgb, fps_ycbcr)
    out["tiled_1080p_fps"] = round(best, 1)
    return out


@contextlib.contextmanager
def _stage_samples():
    """Every `utils.profiling.STAGES` sample recorded within the block, by
    stage (the meter drains STAGES every period, so they are taken as they
    are recorded)."""
    samples: dict[str, list[float]] = collections.defaultdict(list)
    orig = STAGES.record

    def record(name: str, seconds: float) -> None:
        samples[name].append(seconds)
        orig(name, seconds)

    STAGES.record = record  # type: ignore[method-assign]
    try:
        yield samples
    finally:
        STAGES.record = orig  # type: ignore[method-assign]


def _write_pics(directory: str, frames: list[bytes]) -> None:
    for i, f in enumerate(frames):
        pathlib.Path(directory, f"f{i}.jpg").write_bytes(f)


async def _open_viewer(port: int, path: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    return writer, asyncio.create_task(reader.read(-1))


async def _close_tasks(tasks: list[asyncio.Task]) -> None:
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


def _p(sorted_vals: list[float], q: float) -> float:
    n = len(sorted_vals)
    return sorted_vals[min(n - 1, int(n * q))]


def bench_serving_latency(detector: Detector, *, frames_count: int = 40,
                          fps_in: float = 5.0, cut_through: bool = False,
                          trim: bool = False) -> dict:
    """BASELINE config 2: one live stream through the real server (TCP
    ingest -> router -> micro-batcher -> device -> annotate -> MJPEG
    publish), a /face_stream viewer on it, at an input rate below one
    dispatch's, so it measures latency, not throughput. ``cut_through``:
    the ``--preset latency`` configuration (no batch window, ycbcr decode
    at scale 1, a queue of 4), reported as ``serving_latency_*``. ``trim``:
    buckets (1,) instead of (1, 2). Reports the e2e p50/p95, the three
    largest e2e samples with their arrival index and each stage's p95."""
    buckets = (1,) if trim else (1, 2)
    if cut_through:
        engine = EngineConfig(batch_buckets=buckets, batch_window_ms=0.0,
                              queue_capacity=4, decode_mode="ycbcr",
                              decode_scale=1)
    else:
        engine = EngineConfig(batch_buckets=buckets, batch_window_ms=4.0)

    async def run(pics: str):
        server = await start_server(
            server_config=ServerConfig(http_address="127.0.0.1:0",
                                       socket_address="127.0.0.1:0"),
            engine_config=engine, detector=detector, data_parallel="off",
            warmup_resolutions=[(480, 640)])
        try:
            writer, drain = await _open_viewer(server.http_port,
                                               "/face_stream?name=bench")
            await asyncio.sleep(0.3)
            await send_stream(
                ReplaySource(pics, fps=fps_in),
                ClientConfig(address=f"127.0.0.1:{server.socket_port}",
                             channel="bench"),
                max_frames=frames_count)
            await asyncio.sleep(1.0)
            writer.close()
            await _close_tasks([drain])
        finally:
            await server.close()

    with tempfile.TemporaryDirectory(prefix="bench_replay_") as pics, \
            _stage_samples() as stages:
        _write_pics(pics, _load_frames(4))
        asyncio.run(run(pics))
    pre = "serving_latency_" if cut_through else "serving_"
    e2e = stages.get("e2e", [])
    if not e2e:
        return {f"{pre}p50_e2e_ms": -1.0, f"{pre}frames": 0}
    order = sorted(range(len(e2e)), key=lambda i: e2e[i], reverse=True)
    stage_p95 = {name: round(_p(sorted(vals), 0.95) * 1e3, 1)
                 for name, vals in stages.items() if name != "e2e" and vals}
    e2e_sorted = sorted(e2e)
    return {
        f"{pre}p50_e2e_ms": round(_p(e2e_sorted, 0.5) * 1e3, 1),
        f"{pre}p95_e2e_ms": round(_p(e2e_sorted, 0.95) * 1e3, 1),
        f"{pre}frames": len(e2e),
        f"{pre}tail": [{"i": i, "ms": round(e2e[i] * 1e3, 1)}
                       for i in order[:3]],
        f"{pre}stage_p95_ms": stage_p95,
    }


def bench_serving_throughput(detector: Detector, *, streams: int = 16,
                             seconds: float = 10.0, fps_in: float = 30.0,
                             coalesce: bool = True,
                             max_batch: int | None = None,
                             batch_buckets: tuple | None = None) -> dict:
    """Delivered throughput of the real serving tier: ``streams`` live TCP
    streams at ``fps_in`` -> router -> micro-batcher (ycbcr decode at
    scale 2, a queue of 3 batches) -> device -> a /detections viewer per
    stream, over a ``seconds`` window after 3 s of warm traffic, from the
    meter's totals; the window's e2e p50/p95 beside it. ``coalesce=False``
    is the lossless configuration: every queued frame is processed,
    several of one stream in one batch."""
    top = max_batch or streams
    detector.warmup(top, 240, 320, pack_output=True)

    async def run(pics: str, stages: dict) -> dict:
        server = await start_server(
            server_config=ServerConfig(http_address="127.0.0.1:0",
                                       socket_address="127.0.0.1:0"),
            engine_config=EngineConfig(
                batch_buckets=batch_buckets or tuple(sorted(
                    {1, 2, 4, 8, 16, top})),
                batch_window_ms=6.0 if coalesce else 15.0, decode_scale=2,
                decode_mode="ycbcr", queue_capacity=3 * top,
                coalesce_streams=coalesce),
            detector=detector, data_parallel="off",
            warmup_resolutions=[(480, 640)])
        # the writers are kept: a writer that is collected closes its
        # connection, and the router serves only streams with a viewer
        viewers, tasks = [], []
        try:
            for k in range(streams):
                viewers.append(await _open_viewer(
                    server.http_port, f"/detections?name=s{k}"))
            await asyncio.sleep(0.5)
            tasks = [asyncio.create_task(send_stream(
                ReplaySource(pics, fps=fps_in),
                ClientConfig(address=f"127.0.0.1:{server.socket_port}",
                             channel=f"s{k}"),
                max_frames=int(fps_in * (seconds + 8))))
                for k in range(streams)]
            await asyncio.sleep(3.0)  # the live geometry's programs warm
            base = dict(METER.totals)
            base_n = len(stages["e2e"])
            t0 = time.time()
            await asyncio.sleep(seconds)
            elapsed = time.time() - t0
            cur = dict(METER.totals)
            window = sorted(stages["e2e"][base_n:])
        finally:
            for writer, _ in viewers:
                writer.close()
            await _close_tasks(tasks + [drain for _, drain in viewers])
            await server.close()
        done = cur.get("inferred_unique", 0) - base.get("inferred_unique", 0)
        batches = cur.get("batches", 0) - base.get("batches", 0)
        out = {"serving_delivered_fps": round(done / elapsed, 1),
               "serving_mean_batch": round(done / max(batches, 1), 1)}
        if window:
            out["serving_p50_e2e_ms"] = round(_p(window, 0.5) * 1e3, 1)
            out["serving_p95_e2e_ms"] = round(_p(window, 0.95) * 1e3, 1)
            out["serving_frames"] = len(window)
        return out

    with tempfile.TemporaryDirectory(prefix="bench_serving_") as pics, \
            _stage_samples() as stages:
        _write_pics(pics, _load_frames(8))
        return asyncio.run(run(pics, stages))


def cpu_baseline_runner(params: dict | None = None):
    """``run_one(jpeg) -> detections``: the reference's one-frame pipeline
    on the CPU: decode, the Triangle resize as two float32 einsums, the
    u8 round (``floor(x + 0.5)``), normalize, the conv stack in float32
    (`models.UltraFace`, ``params``, by default ``init_params(0,
    background_bias=BASELINE_BIAS)``), and the NumPy reference postprocess
    (``ops/reference_impl.py``)."""
    if params is None:
        params = random_params(background_bias=BASELINE_BIAS)
    model = uf.UltraFace.create("RFB-320", params, device="cpu")
    r_h = triangle_resize_matrix(480, 240)
    r_w = triangle_resize_matrix(640, 320)

    def run_one(data: bytes):
        img = codec.decode_rgb(data).astype(np.float32)
        x = np.einsum("oH,HWc->oWc", r_h, img)
        x = np.einsum("oW,hWc->hoc", r_w, x)
        x = (np.clip(np.floor(x + 0.5), 0, 255) / 255.0 - MEAN) / STD
        with torch.no_grad():
            scores, boxes = model(torch.from_numpy(
                np.ascontiguousarray(x[None], np.float32)))
        return ref.postprocess(scores[0].numpy(), boxes[0].numpy())

    return run_one


def bench_cpu_baseline(frames: list[bytes], *, max_frames: int = 12) -> dict:
    """The reference-style CPU pipeline one frame at a time, on the CPU
    on purpose: it is the baseline."""
    torch.set_num_threads(os.cpu_count() or 1)
    run_one = cpu_baseline_runner()
    run_one(frames[0])  # warm
    t0 = time.perf_counter()
    for n in range(max_frames):
        run_one(frames[n % len(frames)])
    elapsed = time.perf_counter() - t0
    return {"fps": max_frames / elapsed,
            "ms_per_frame": elapsed / max_frames * 1e3}


# -- planning and the run --------------------------------------------------


class _Plan:
    """Starvation-proof phase scheduler (the JAX bench's).

    - MUST phases (every recorded metric family) always run, cheap
      families first; they are skipped only at the hard wall, so one
      labelled JSON line beats a killed process.
    - OPTIONAL phases run only when the remaining budget covers their
      estimate, scaled by the run's own measured cost factor, and the
      not-yet-run MUST phases' reserve.
    - after each phase ``scale`` blends toward actual/estimate, so a slow
      start inflates later estimates.
    - every phase's cost lands in ``phase_s``, every skip or failure in
      ``skipped`` (``name:failed``).
    """

    def __init__(self, budget_s: float, hard_wall_s: float, note):
        self.t0 = time.time()
        self.budget_s = budget_s
        self.hard_wall_s = hard_wall_s
        self._note = note
        self.scale = 1.0
        self.phase_s: dict[str, float] = {}
        self.skipped: list[str] = []
        self._musts: dict[str, float] = {}

    def declare_musts(self, **est_s: float) -> None:
        self._musts = dict(est_s)

    def remaining(self) -> float:
        return self.budget_s - (time.time() - self.t0)

    def wall_left(self) -> float:
        return self.hard_wall_s - (time.time() - self.t0)

    def reserve(self) -> float:
        """Budget still owed to not-yet-run MUST phases."""
        return sum(self._musts.values()) * self.scale

    def run(self, name: str, fn, *, est_s: float, must: bool = False,
            default=None):
        est = est_s * self.scale
        if must:
            self._musts.pop(name, None)
            if self.wall_left() < 15.0:
                self._note(f"{name} SKIPPED at hard wall "
                           f"(wall_left {self.wall_left():.0f}s)")
                self.skipped.append(name)
                return default
        elif (self.remaining() < est + self.reserve()
                or self.wall_left() < est + 15.0):
            self._note(f"{name} skipped (est {est:.0f}s, remaining "
                       f"{self.remaining():.0f}s, must-reserve "
                       f"{self.reserve():.0f}s)")
            self.skipped.append(name)
            return default
        t0 = time.time()
        try:
            out = fn()
        except Exception as e:
            # recorded in the artifact with the default in its place,
            # unless nothing downstream can work without it (no default)
            if default is None and must:
                raise
            dt = time.time() - t0
            self.phase_s[name] = round(dt, 1)
            self._note(f"{name} FAILED after {dt:.0f}s: {e!r}")
            self.skipped.append(f"{name}:failed")
            return default
        dt = time.time() - t0
        self.phase_s[name] = round(dt, 1)
        ratio = dt / max(est_s, 1e-9)
        self.scale = min(6.0, max(0.5, 0.7 * self.scale + 0.3 * ratio))
        return out

    def failures(self) -> list[str]:
        """The phases that failed, and the MUST phases skipped at the hard
        wall (an optional phase is skipped by design)."""
        return [s for s in self.skipped
                if s.endswith(":failed") or s in MUST_ESTIMATES]


class _Snapshot:
    """Everything measured so far, kept current by `main`; a signal
    prints it as the one JSON line (labelled ``partial``) and exits 1."""

    def __init__(self, row: dict):
        self.row: dict | None = row

    def emit_and_exit(self, signum, frame):  # pragma: no cover - signals
        row = self.row
        if row is not None:
            row = {k: (dict(v) if isinstance(v, dict) else
                       list(v) if isinstance(v, list) else v)
                   for k, v in row.items()}
            row["partial"] = True
            row["killed_by"] = f"signal {signum}"
            print(json.dumps(row), flush=True)
        os._exit(1)


def append_anchor(path: str, result: dict) -> None:
    """Append the anchor row (date, the link, the anchor triplet, the
    headline, the card) to ``path`` as one JSON line; a failed write is
    noted and never costs the JSON line."""
    row = {"date": datetime.date.today().isoformat(),
           **{k: result.get(k) for k in (
               "latch_s", "h2d_probe_mbps", "onchip_ms_per_batch",
               "device_only_fps", "anchor_dispatch_ms")},
           "headline_fps": result.get("value"),
           "device": result.get("device"),
           "power_limit": result.get("power_limit")}
    try:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
    except OSError as e:
        note(f"anchor row not written to {path}: {e!r}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Headline benchmark of the port; prints one JSON line.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--anchors", default=None, metavar="PATH",
                    help="append the anchor row to this JSON-lines file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    snapshot = _Snapshot({"metric": METRIC, "value": 0.0,
                          "unit": "frames/s", "vs_baseline": 0.0,
                          "partial_at": "latch"})
    old_handlers = {s: signal.signal(s, snapshot.emit_and_exit)
                    for s in (signal.SIGTERM, signal.SIGALRM)}
    signal.alarm(int(float(os.environ.get("BENCH_TOTAL_WALL_S", "1440"))))
    try:
        result, plan = _run(device, snapshot)
    except Exception as e:
        # a signal from here on prints nothing: this is the one line
        row, snapshot.row = snapshot.row, None
        print(json.dumps({**row, "partial": True, "error": repr(e)}),
              flush=True)
        raise
    finally:
        snapshot.row = None
        signal.alarm(0)
        for s, h in old_handlers.items():
            signal.signal(s, h)
    if args.anchors:
        append_anchor(args.anchors, result)
    print(json.dumps(result), flush=True)
    failed = plan.failures()
    if failed:
        note(f"phases failed or skipped at the hard wall: {failed}")
        return 1
    return 0


def _run(device: torch.device, snapshot: _Snapshot) -> tuple[dict, _Plan]:
    """Every phase in the JAX bench's order; returns the JSON line and the
    plan."""
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    seconds = float(os.environ.get("BENCH_SECONDS", "8"))
    name = device_name(device)
    limit = power_limit() if device.type == "cuda" else None
    note(f"device {name} ({limit}); first device operation")
    t0 = time.time()
    torch.zeros(1, device=device)
    _sync(device)
    latch_s = time.time() - t0
    h2d_mbps = link.probe_h2d_mbps(4.0, 3, device=device)
    slow_link = latch_s > 60.0 or h2d_mbps < SLOW_LINK_MBPS
    note(f"first operation {latch_s:.1f}s, h2d probe {h2d_mbps:.0f} MB/s"
         f"{' (slow link: cheap samples first)' if slow_link else ''}")
    plan = _Plan(float(os.environ.get("BENCH_BUDGET_S", "420")),
                 float(os.environ.get("BENCH_HARD_WALL_S", "900")), note)
    partial = snapshot.row
    partial.update(latch_s=round(latch_s, 1),
                   h2d_probe_mbps=round(h2d_mbps, 1), slow_link=slow_link,
                   phase_s=plan.phase_s, skipped_phases=plan.skipped,
                   device=name, power_limit=limit)

    def save(stage: str, **kv) -> None:
        partial.update(kv)
        partial["partial_at"] = stage

    save("probed")
    plan.declare_musts(**MUST_ESTIMATES)
    frames = _load_frames(batch)
    cpu = plan.run("cpu_baseline", lambda: bench_cpu_baseline(frames),
                   est_s=12, must=True,
                   default={"fps": 1.0, "ms_per_frame": 0.0})
    note(f"cpu baseline done ({cpu['fps']:.2f} fps)")
    save("cpu_baseline", cpu_baseline_fps=round(cpu["fps"], 2))

    detector = plan.run("detector_init", lambda: make_detector(device),
                        est_s=10, must=True)

    anchor = plan.run("anchor", lambda: bench_anchor(detector, batch=batch),
                      est_s=35, must=True, default={})
    if anchor:
        note(f"anchor done (onchip {anchor['onchip_ms_per_batch']} ms/b64, "
             f"device-only {anchor['device_only_fps']:.0f} fps, dispatch "
             f"{anchor['anchor_dispatch_ms']} ms/batch, "
             f"{anchor.get('mfu_pct', 'n/a')}% MFU)")
        save("anchor", **anchor)

    gpu = plan.run(
        "pipeline",
        lambda: bench_gpu(detector, frames, seconds=seconds, batch=batch,
                          slow_link=slow_link, latch_s=latch_s),
        est_s=95, must=True,
        default={"fps": 0.0, "fps_ycbcr": 0.0, "fps_pixels": 0.0,
                 "fps_annotated_device": 0.0, "fps_annotated_host": 0.0,
                 "latch_s": latch_s, "slow_rig": slow_link,
                 "p50_batch_ms": -1.0, "p50_frame_ms": -1.0})
    note(f"pipeline done ({gpu['fps']:.1f} fps, annotated dev "
         f"{gpu['fps_annotated_device']:.1f} vs host "
         f"{gpu['fps_annotated_host']:.1f}), remaining budget "
         f"{plan.remaining():.0f}s")
    save("pipeline", value=round(gpu["fps"], 2),
         vs_baseline=round(gpu["fps"] / max(cpu["fps"], 1e-9), 2),
         p50_frame_ms=round(gpu["p50_frame_ms"], 3),
         p50_batch_ms=round(gpu["p50_batch_ms"], 2),
         fps_ycbcr_path=round(gpu["fps_ycbcr"], 1),
         fps_pixels_path=round(gpu["fps_pixels"], 1),
         fps_annotated_device=round(gpu["fps_annotated_device"], 1),
         fps_annotated_host=round(gpu["fps_annotated_host"], 1))

    fullres = plan.run(
        "annotate_fullres",
        lambda: bench_annotate_fullres(
            detector, frames, batch=batch,
            seconds=4.0 if slow_link else seconds),
        est_s=35, must=True,
        default={"fps_annotated_splice_fullres": 0.0,
                 "fps_annotated_host_fullres": 0.0})
    note(f"fullres annotate done (splice "
         f"{fullres['fps_annotated_splice_fullres']:.1f} vs host "
         f"{fullres['fps_annotated_host_fullres']:.1f} fps)")
    save("annotate_fullres",
         **{k: round(v, 1) for k, v in fullres.items()})

    serving = {"serving_p50_e2e_ms": -1.0, "serving_frames": 0,
               "serving_delivered_fps": 0.0, "serving_mean_batch": 0.0,
               "serving_latency_p50_e2e_ms": -1.0}
    served = plan.run(
        "serving_window",
        lambda: bench_serving_throughput(
            detector, streams=batch, seconds=8.0 if slow_link else 10.0,
            batch_buckets=(tuple(sorted({1, max(1, batch // 2), batch}))
                           if slow_link else None)),
        est_s=60, must=True, default={})
    if served:
        serving.update(served)
        note(f"serving window done ({served['serving_delivered_fps']} fps)")
        best_now = max(partial["value"], served["serving_delivered_fps"])
        save("serving_window", **serving, value=round(best_now, 2),
             vs_baseline=round(best_now / max(cpu["fps"], 1e-9), 2))

    def tiled_core():
        # the full-resolution windows ride along only when the budget after
        # the remaining MUST phases still covers them
        full = (not slow_link) or plan.remaining() - plan.reserve() > 120
        return bench_tiled(detector, seconds=4.0 if slow_link else 6.0,
                           full=full)

    tiled = plan.run("tiled_core", tiled_core, est_s=60, must=True,
                     default={"tiled_1080p_fps": 0.0})
    if tiled.get("tiled_1080p_fps"):
        note(f"tiled done (rows {tiled['tiled_1080p_ycbcr_rows_fps']} vs "
             f"stacked {tiled['tiled_1080p_ycbcr_scaled_fps']} vs rgb "
             f"{tiled['tiled_1080p_rgb_scaled_fps']} fps, ceiling "
             f"{tiled['tiled_1080p_device_scaled_fps']})")
        save("tiled_core", **tiled)

    latency = plan.run(
        "latency_preset",
        lambda: bench_serving_latency(detector, cut_through=True,
                                      trim=slow_link),
        est_s=50, must=True, default={})
    if latency:
        serving.update(latency)
        note(f"latency preset done (p50 "
             f"{serving['serving_latency_p50_e2e_ms']} ms)")
        save("latency_preset", **latency)

    def lossless_window(depth: int):
        def go():
            out = bench_serving_throughput(
                detector, streams=batch, coalesce=False,
                max_batch=depth * batch,
                batch_buckets=(tuple(sorted({1, batch, depth * batch}))
                               if slow_link else None))
            out["serving_lossless_max_batch"] = depth * batch
            return out
        return go

    lossless = {"serving_delivered_fps": 0.0, "serving_mean_batch": 0.0,
                "serving_lossless_max_batch": 0}
    first = plan.run("lossless", lossless_window(4), est_s=60, must=True,
                     default={})
    if first:
        lossless = first
        note(f"lossless serving done ({lossless['serving_delivered_fps']} "
             f"fps)")
        best_now = max(partial["value"], lossless["serving_delivered_fps"])
        save("lossless",
             serving_lossless_fps=lossless["serving_delivered_fps"],
             serving_lossless_mean_batch=lossless["serving_mean_batch"],
             serving_lossless_max_batch=lossless[
                 "serving_lossless_max_batch"],
             value=round(best_now, 2),
             vs_baseline=round(best_now / max(cpu["fps"], 1e-9), 2))

    second = plan.run("lossless_depth2", lossless_window(2), est_s=55)
    if second and (second["serving_delivered_fps"]
                   > lossless["serving_delivered_fps"]):
        lossless = second
    deep = plan.run("deep_queue_latency",
                    lambda: bench_serving_latency(detector, trim=slow_link),
                    est_s=45)
    if deep:
        serving.update(deep)

    serving["serving_lossless_fps"] = lossless["serving_delivered_fps"]
    serving["serving_lossless_mean_batch"] = lossless["serving_mean_batch"]
    serving["serving_lossless_max_batch"] = lossless[
        "serving_lossless_max_batch"]
    serving["bench_wall_s"] = round(time.time() - plan.t0, 1)
    note(f"all phases done; skipped: {plan.skipped or 'none'}")

    # the headline: the better of the standalone pipeline and the real
    # serving tier (both decode + preprocess + CNN + NMS per frame over the
    # same streams; lossless batches several frames of a stream)
    best = max(gpu["fps"], serving.get("serving_delivered_fps", 0.0),
               serving.get("serving_lossless_fps", 0.0))
    result = {
        "metric": METRIC,
        "value": round(best, 2),
        "unit": "frames/s",
        "vs_baseline": round(best / cpu["fps"], 2),
        "p50_frame_ms": round(gpu["p50_frame_ms"], 3),
        "p50_batch_ms": round(gpu["p50_batch_ms"], 2),
        "batch": batch,
        "cpu_baseline_fps": round(cpu["fps"], 2),
        "fps_ycbcr_path": round(gpu["fps_ycbcr"], 1),
        "fps_pixels_path": round(gpu["fps_pixels"], 1),
        "fps_annotated_device": round(gpu["fps_annotated_device"], 1),
        "fps_annotated_host": round(gpu["fps_annotated_host"], 1),
        "fps_annotated_splice_fullres": round(
            fullres["fps_annotated_splice_fullres"], 1),
        "fps_annotated_host_fullres": round(
            fullres["fps_annotated_host_fullres"], 1),
        **anchor,
        **tiled,
        **serving,
        "latch_s": round(latch_s, 1),
        "h2d_probe_mbps": round(h2d_mbps, 1),
        "slow_link": slow_link,
        "phase_s": plan.phase_s,
        "skipped_phases": plan.skipped,
        "nms_launches": nms.kernel.launches,
        "device": name,
        "power_limit": limit,
    }
    return result, plan


if __name__ == "__main__":
    sys.exit(main())
