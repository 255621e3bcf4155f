"""Micro-batched inference worker on one device: the port of
``infercam_onnx_tpu/serving/inferer.py`` for the pixels and ycbcr decode
modes and host annotation.

The same shape as the JAX worker:

- a bounded submit queue with drop-on-full backpressure;
- a gather window that collects frames across streams, coalescing to the
  latest frame per stream unless ``coalesce_streams`` is off;
- batches grouped by frame size and padded to the smallest bucket that
  holds them;
- three stages on three single-thread executors, decode(k+2) ||
  device(k+1) || draw + encode + publish(k), with NDJSON detections and
  annotated MJPEG parts published to each stream's broadcasts;
- in ``decode_mode="ycbcr"``, detection-only frames are decoded to packed
  YCbCr planes in one batched call of the native shim (entropy decode and
  IDCT on its thread pool, the GIL released), grouped by geometry, and
  uploaded as one ``[bucket, n]`` uint8 batch; the device upsamples
  chroma and converts colour before the same detect program
  (``Detector.run_device_ycbcr_packed``, stage ``"device_ycbcr"``).
  Frames with a ``/face_stream`` viewer need host pixels to draw on and
  take the pixels path, as the JAX worker's do without device annotation;
  a frame the packed decode refuses is pixel-decoded instead of dropped.

What changes is the transfer discipline, written for a CUDA device:

- **upload** (decode thread): the padded batch (frames, or packed plane
  rows) is written into a fresh pinned host tensor and copied to the
  device with ``non_blocking=True`` on a dedicated copy stream, which then
  records an event. PyTorch's
  caching host allocator records the copy on the pinned block and hands
  the block out again only once that copy has completed, so the staging
  buffers of both directions are reused without a ring of our own. The
  device tensor is ``record_stream``-ed onto the compute stream, so the
  caching allocator does not hand its memory out again before the compute
  stream is done with it.
- **compute** (device thread): the compute stream waits on that event,
  then ``Detector.run_device(batch, pack_output=True)`` (or
  ``run_device_ycbcr_packed``) runs under ``torch.cuda.stream(compute)``.
  Every launch in it, the NMS kernel's included (``ops/nms.py`` launches
  on ``torch.cuda.current_stream()``), lands on the compute stream.
- **readback** (device thread): the packed ``[B, D, 6]`` output is copied
  into a fresh pinned host tensor with ``non_blocking=True`` and an event
  is recorded after it. The publish thread waits on that event before it
  reads a single number: a non-blocking device-to-host copy read early
  gives whatever the buffer held, silently.

On ``device="cpu"`` there are no streams and no pinned memory: the batch
is a plain tensor and the output is read as soon as it is returned.
"""

from __future__ import annotations

import asyncio
import bisect
import collections
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.config import EngineConfig, ServerConfig
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.draw import draw_detections
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.protocol import as_jpeg_stream_item
from infercam_onnx_tpu_torch.serving.meter import METER
from infercam_onnx_tpu_torch.serving.router import InferJob
from infercam_onnx_tpu_torch.utils.profiling import STAGES

log = logging.getLogger("infercam.inferer")

class InferenceWorker:
    def __init__(
        self,
        detector: Detector,
        engine_config: EngineConfig = EngineConfig(),
        server_config: ServerConfig = ServerConfig(),
    ):
        self._detector = detector
        self._cfg = engine_config
        self._server_cfg = server_config
        self._queue: asyncio.Queue[InferJob] = asyncio.Queue(
            maxsize=engine_config.queue_capacity)
        self._buckets = sorted(engine_config.batch_buckets)
        self.device = detector.device
        self._copy_stream = self._compute_stream = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._copy_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.Stream(self.device)
        # Each stage runs on its own thread, bound to the worker's device.
        # The device thread is the only one that runs float32 convs and
        # matmuls (detect_program, warm-up), so the process-wide precision
        # that config.full_float32 sets while it runs reaches no other
        # work of this worker.
        self._decode_exec, self._device_exec, self._publish_exec = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix=name,
                               initializer=self._bind_device)
            for name in ("decode", "device", "publish"))
        self._loop: asyncio.AbstractEventLoop | None = None
        # device warm-up in progress (surfaced as /stats "warming")
        self.warming = False

    def _bind_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def close(self) -> None:
        """Wait for the stages' threads to finish their work and stop."""
        for ex in (self._decode_exec, self._device_exec, self._publish_exec):
            ex.shutdown(wait=True)

    # -- submission (called from the router on the event loop) -------------

    def submit(self, job: InferJob) -> bool:
        """Non-blocking enqueue; False = dropped (queue full)."""
        try:
            self._queue.put_nowait(job)
            return True
        except asyncio.QueueFull:
            return False

    # -- worker loop -------------------------------------------------------

    def _bucket_size(self, n: int) -> int:
        i = bisect.bisect_left(self._buckets, n)
        return self._buckets[min(i, len(self._buckets) - 1)]

    async def run(self) -> None:
        """decode(k+2) || device(k+1) || draw+encode+publish(k), each
        stage on its own single-thread executor."""
        self._loop = asyncio.get_running_loop()
        max_bucket = self._buckets[-1]
        window = self._cfg.batch_window_ms / 1e3
        inflight: asyncio.Future | None = None
        publish_futs: collections.deque = collections.deque()

        async def flush_inflight():
            nonlocal inflight
            results = await inflight
            inflight = None
            publish_futs.append(self._loop.run_in_executor(
                self._publish_exec, self._publish_results, results))
            while len(publish_futs) > 2:  # bound publish backlog
                await publish_futs.popleft()

        get_task: asyncio.Future | None = None
        try:
            while True:
                # wait for the next job, but publish the in-flight batch
                # as soon as it finishes: the last batch of a burst must
                # not wait for the next burst
                get_task = asyncio.ensure_future(self._queue.get())
                while inflight is not None:
                    done, _ = await asyncio.wait(
                        {get_task, inflight},
                        return_when=asyncio.FIRST_COMPLETED)
                    if inflight in done:
                        await flush_inflight()
                    if get_task in done:
                        break
                jobs = [await get_task]
                deadline = self._loop.time() + window
                while len(jobs) < max_bucket:
                    timeout = deadline - self._loop.time()
                    if timeout <= 0:
                        break
                    try:
                        jobs.append(await asyncio.wait_for(
                            self._queue.get(), timeout))
                    except asyncio.TimeoutError:
                        break
                if self._cfg.coalesce_streams:
                    # latest frame per stream wins
                    latest: dict[int, InferJob] = {}
                    for job in jobs:
                        if job.key in latest:
                            METER.tick_dropped()
                        latest[job.key] = job
                    jobs = list(latest.values())
                units = await self._loop.run_in_executor(
                    self._decode_exec, self._decode, jobs)
                if inflight is not None:
                    await flush_inflight()
                inflight = self._loop.run_in_executor(
                    self._device_exec, self._device_stage, units)
        finally:
            # on cancellation (shutdown, supervisor restart) leave no
            # pending queue get behind
            if get_task is not None:
                get_task.cancel()

    # -- stage 1: decode + batch assembly + upload (decode thread) ---------

    def _decode(self, jobs: list[InferJob]) -> list[dict]:
        """Decode the jobs' JPEGs, group them into padded batches and
        start each batch's upload. In ycbcr mode detection-only jobs take
        the packed-plane decode, grouped by JPEG geometry; every other job
        is pixel-decoded and grouped by frame size. A frame nothing can
        decode is dropped and counted, not fatal."""
        scale = self._cfg.decode_scale
        ycbcr = self._cfg.decode_mode == "ycbcr"
        pixel_jobs = [j for j in jobs if j.reply is not None or not ycbcr]
        ycbcr_jobs = [j for j in jobs if j.reply is None and ycbcr]
        frames: list[tuple[InferJob, np.ndarray]] = []

        def pixel_decode(job: InferJob, why) -> None:
            try:
                frames.append((job, codec.decode_rgb(job.data, scale)))
            except ValueError as e:
                log.warning("dropping corrupt frame on stream %x (%s)",
                            job.key, why or e)
                METER.tick_dropped()

        with STAGES.stage("decode"):
            if pixel_jobs:
                try:
                    decoded = codec.decode_batch(
                        [j.data for j in pixel_jobs], scale)
                    frames = list(zip(pixel_jobs, decoded))
                except ValueError:
                    for job in pixel_jobs:
                        pixel_decode(job, None)
            groups = (self._decode_ycbcr(ycbcr_jobs, pixel_decode)
                      if ycbcr_jobs else [])

        units: list[dict] = []
        with STAGES.stage("upload"):
            by_shape: dict[tuple[int, int], list] = {}
            for job, frame in frames:
                by_shape.setdefault(frame.shape[:2], []).append((job, frame))
            units.extend(self._unit(members) for members in
                         by_shape.values())
            units.extend(self._unit(members, geom)
                         for members, geom in groups)
        return units

    def _decode_ycbcr(self, jobs: list[InferJob], pixel_decode):
        """[(members, geom)]: the jobs' packed YCbCr rows grouped by JPEG
        geometry, members as (job, row). One batched call when every frame
        shares a geometry (the common case: the same cameras); on a mixed
        or corrupt batch, one call a frame, and a frame the packed decode
        refuses (a grayscale or 4:1:1 JPEG, a corrupt one) goes to
        ``pixel_decode``."""
        native = native_jpeg.load()
        scale = self._cfg.decode_scale
        try:
            packed, geom = native.decode_ycbcr_batch([j.data for j in jobs],
                                                     scale=scale)
            return [(list(zip(jobs, packed)), geom)]
        except ValueError:
            pass
        by_geom: dict[tuple, tuple[list, dict]] = {}
        for job in jobs:
            try:
                packed, geom = native.decode_ycbcr_batch([job.data],
                                                         scale=scale)
            except ValueError as e:
                pixel_decode(job, e)
                continue
            by_geom.setdefault(tuple(geom.items()), ([], geom))[0].append(
                (job, packed[0]))
        return list(by_geom.values())

    def _unit(self, members: list, geom: dict | None = None) -> dict:
        """One padded batch of ``members`` (job, frame or packed row),
        uploading: the device stage's work item. ``geom`` is the packed
        rows' geometry, None for pixel frames."""
        if geom is None:
            h, w = members[0][1].shape[:2]
        else:
            w, h = geom["width"], geom["height"]
        bucket = self._bucket_size(len(members))
        extra = len(members) - bucket
        if extra > 0:
            # the gather window stops at the largest bucket, so this
            # should not happen; count it if it does
            log.warning("batch group overflow: dropping %d frames beyond "
                        "bucket %d", extra, bucket)
            METER.tick_dropped(extra)
            members = members[:bucket]
        batch, ready = self._upload([r for _, r in members], bucket)
        if geom is not None:  # nothing to draw on: the rows are planes
            members = [(job, None) for job, _ in members]
        return {"members": members, "n": len(members), "batch": batch,
                "ready": ready, "geom": geom, "w": w, "h": h}

    def _upload(self, rows: list[np.ndarray], bucket: int
                ) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """The [bucket, *row shape] uint8 batch of ``rows`` (frames or
        packed plane rows), zero-padded, on the device, and the event
        after which it is there (None on the CPU)."""
        shape = (bucket, *rows[0].shape)
        if self._copy_stream is None:
            batch = np.zeros(shape, np.uint8)
            batch[:len(rows)] = rows
            return torch.from_numpy(batch), None
        host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        view = host.numpy()
        view[:len(rows)] = rows
        view[len(rows):] = 0
        with torch.cuda.stream(self._copy_stream):
            batch = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        batch.record_stream(self._compute_stream)
        return batch, ready

    # -- stage 2: dispatch + readback (device thread) ----------------------

    def _device_stage(self, units: list[dict]) -> list[dict]:
        """Dispatch each uploaded batch and start its readback; returns
        the publish stage's entries."""
        results = []
        for unit in units:
            t0 = time.monotonic()
            with STAGES.stage("device" if unit["geom"] is None
                              else "device_ycbcr"):
                packed, done = self._run_detection(unit)
            METER.tick_batch(unit["n"], time.monotonic() - t0)
            results.append({"members": unit["members"], "packed": packed,
                            "done": done, "w": unit["w"], "h": unit["h"]})
        return results

    def _detect(self, unit: dict) -> torch.Tensor:
        if unit["geom"] is None:
            return self._detector.run_device(unit["batch"], pack_output=True)
        return self._detector.run_device_ycbcr_packed(
            unit["batch"], unit["geom"], pack_output=True)

    def _run_detection(self, unit: dict):
        """The packed [B, D, 6] detections of one padded batch as a host
        tensor, and the event after which they may be read (None on the
        CPU, where they are ready on return)."""
        if self._compute_stream is None:
            return self._detect(unit), None
        with torch.cuda.stream(self._compute_stream):
            self._compute_stream.wait_event(unit["ready"])
            packed = self._detect(unit)
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._compute_stream)
        return host, done

    # -- stage 3: draw + encode + publish (publish thread) ------------------

    def _publish(self, chan, item: bytes) -> None:
        self._loop.call_soon_threadsafe(chan.publish, item)

    def _tick_e2e(self, job: InferJob) -> None:
        """Per-frame end-to-end latency, router enqueue to publish."""
        if job.enqueued_at:
            STAGES.record("e2e", time.monotonic() - job.enqueued_at)

    def _detections_json(self, packed_row: np.ndarray, w: int,
                         h: int) -> bytes:
        count = int(packed_row[:, 5].sum())
        return (json.dumps({
            "ts": round(time.time(), 4),
            "width": w,
            "height": h,
            "detections": [
                {"bbox": [float(v) for v in packed_row[d, :4]],
                 "confidence": float(packed_row[d, 4])}
                for d in range(count)
            ],
        }) + "\n").encode()

    def _publish_results(self, results: list[dict]) -> None:
        dims = self._server_cfg.assume_frame_dims
        for entry in results:
            if entry["done"] is not None:
                entry["done"].synchronize()  # the readback has landed
            packed = entry["packed"].numpy()
            w, h = entry["w"], entry["h"]
            for i, (job, frame) in enumerate(entry["members"]):
                if job.det_reply is not None:
                    self._publish(job.det_reply,
                                  self._detections_json(packed[i], w, h))
                if job.reply is not None:
                    count = int(packed[i, :, 5].sum())
                    dets = [(packed[i, d, :4], float(packed[i, d, 4]))
                            for d in range(count)]
                    with STAGES.stage("draw"):
                        annotated = draw_detections(frame, dets, dims)
                    with STAGES.stage("encode"):
                        jpeg = codec.encode_rgb(
                            annotated, self._server_cfg.jpeg_quality,
                            self._server_cfg.jpeg_subsampling)
                    self._publish(job.reply, as_jpeg_stream_item(jpeg))
                self._tick_e2e(job)
            METER.tick_inferred_unique(len(entry["members"]))

    def warmup(self, resolutions: list[tuple[int, int]] | None = None):
        """Run the detect program once for every bucket at each (h, w)
        resolution as senders send it (decode_scale applied), so kernel
        builds, cuDNN's algorithm choices and the resize matrices are done
        before traffic. In ycbcr mode a 4:2:0 probe JPEG of each
        resolution also runs every bucket through the packed-plane path
        (the shim's build included). `serving.app` runs it on the device
        thread."""
        s = self._cfg.decode_scale
        for (h, w) in resolutions or [(480, 640)]:
            for b in self._buckets:
                self._detector.warmup(b, h // s, w // s)
            if self._cfg.decode_mode != "ycbcr":
                continue
            probe = codec.encode_rgb(np.zeros((h, w, 3), np.uint8), 90,
                                     "420")
            for b in self._buckets:
                packed, geom = native_jpeg.load().decode_ycbcr_batch(
                    [probe] * b, scale=s)
                self._detector.run_device_ycbcr_packed(packed, geom,
                                                       pack_output=True)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
