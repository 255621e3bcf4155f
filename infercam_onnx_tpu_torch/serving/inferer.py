"""Micro-batched inference worker: the port of
``infercam_onnx_tpu/serving/inferer.py`` for the pixels, ycbcr and
coefficients decode modes, both annotate modes, tiled high-resolution
detection and the link probe, on one device or over a mesh of replicas.

The same shape as the JAX worker:

- a bounded submit queue with drop-on-full backpressure;
- a gather window that collects frames across streams, coalescing to the
  latest frame per stream unless ``coalesce_streams`` is off;
- batches grouped by frame size (packed planes and coefficients: by JPEG
  geometry) and padded to the smallest bucket that holds them;
- three stages on three single-thread executors, decode(k+2) ||
  device(k+1) || encode + publish(k), with NDJSON detections and annotated
  MJPEG parts published to each stream's broadcasts.

Each gather becomes units, one device program each:

- ``pixels``: host RGB frames grouped by (size, needs annotation), so
  detection-only frames never pay an annotated program's readback. With
  ``annotate_mode="device"`` the annotated ones run
  `Detector.run_device_annotated` (stage ``"device"``): the overlay, the
  FDCT and the quantization run on the device, and the publish stage only
  entropy-codes (``native/jpeg.py`` `encode_coefs`, stage ``"encode"``).
  With ``"host"`` it draws with PIL and encodes the whole JPEG.
- ``ycbcr`` (``decode_mode="ycbcr"``): packed YCbCr planes, decoded in one
  batched call of the native shim (the GIL released), stage
  ``"device_ycbcr"``; a frame the packed decode refuses is pixel-decoded
  instead of dropped. ``ycbcr_annot``: the frames with a ``/face_stream``
  viewer, when annotating on the device, through
  `run_device_ycbcr_annotated` (stage ``"device_annot"``). They are a
  unit of their own, a second program in a gather that holds both.
- ``coef`` (``decode_mode="coefficients"``): the host only entropy-decodes
  (`read_coefficient_batch`, one ctypes call a frame), stage
  ``"device_coef"``. ``coef_annot``: the viewers' frames through the
  splice transcode (`run_device_coefficients_annotated_packed`, stage
  ``"device_annot"``): only the blocks the overlay touched come back, and
  `_finish_splice` writes them into the stream's own coefficients, so the
  output is bit-exact to the input elsewhere. A frame whose overlay
  touched more than ``annotate_splice_blocks`` blocks, or whose two
  chroma quant tables differ, is annotated on the host from its JPEG
  bytes, as the JAX worker does (the reference's semantics for that
  frame, counted in ``splice_fallbacks``).

With ``annotate_mode="host"`` a viewer's frame takes the pixels path in
every decode mode.

Frames of at least ``tile_min_pixels`` pixels (after decode) tile, by the
JAX worker's rules, through a `parallel.tiling.TiledDetector` cached per
frame size:

- a ``pixels`` unit of such frames runs `TiledDetector.run_device`; an
  annotated one is drawn on the host (its unit's ``annotate`` is false);
- ``ycbcr_tiled`` (stage ``"device_tiled"``): the detection-only packed
  rows of such frames through `run_device_ycbcr_packed`;
  ``ycbcr_tiled_rows``: the same through `run_device_ycbcr_rows` when the
  tiled upload route is "rows", each row uploaded from a pinned tensor
  of its own;
- ycbcr-annotate and splice frames that would tile are pixel-decoded and
  drawn on the host; detection-only coefficients frames do not tile.

The effective decode mode, tiled upload route and annotate mode are the
configured ones (``tiled_upload="auto"``: "rows" while a probe is due,
else "stacked") until `probe_and_adapt` re-selects them by the measured
link (``serving/link.py``); `_decode` reads the decode mode once a
gather.

What changes is the transfer discipline, written for a CUDA device:

- **upload** (decode thread): every input array of a unit (frames, packed
  plane rows, coefficient blocks, quant tables; for ``ycbcr_tiled_rows``
  each row) is written into a fresh pinned host tensor and copied to the
  device with ``non_blocking=True`` on a dedicated copy stream, which
  then records one event after the last copy. PyTorch's
  caching host allocator records the copy on the pinned block and hands
  the block out again only once that copy has completed, so the staging
  buffers of both directions are reused without a ring of our own. The
  device tensors are ``record_stream``-ed onto the compute stream, so the
  caching allocator does not hand their memory out again before the
  compute stream is done with them.
- **compute** (device thread): the compute stream waits on that event,
  then the unit's program runs under ``torch.cuda.stream(compute)``. Every
  launch in it, the NMS kernel's included (``ops/nms.py`` launches on
  ``torch.cuda.current_stream()``), lands on the compute stream.
- **readback** (device thread): every output of the program (packed
  detections, coefficients, the splice's blocks and meta) is copied into
  a fresh pinned host tensor with ``non_blocking=True`` and one event is
  recorded after the last. The publish thread waits on that event before
  it reads a single number: a non-blocking device-to-host copy read early
  gives whatever the buffer held, silently.

On a mesh (a list of devices, `parallel.mesh`) the detector is a
`parallel.data_parallel.ShardedDetector` (a plain one is wrapped), and the
batches pad to a multiple of its ``batch_granularity``. The decode thread
then leaves each unit's inputs in their pinned host tensors: the detector
copies each replica's shard on that replica's copy stream, and gathers the
outputs onto the first device, ordered on the compute stream, so the
readback covers every replica. The per-row tiled upload is a one-device
route; on a mesh such units take the stacked one. A lockstep member
(`parallel.lockstep.LockstepDetector`) takes tiled units through its own
``run_device_tiled`` and ``run_device_tiled_ycbcr``, inside the cluster's
rounds.

On ``device="cpu"`` there are no streams and no pinned memory: the inputs
are plain tensors and the outputs are read as soon as they are returned.

Tracing (`utils.profiling.STAGES` spans, the Meter's totals): each stage
thread's top-level spans (``decode`` and ``upload``; ``device*``;
``readback_wait`` and ``publish``) add the thread's own CPU seconds into
``cpu_s_<stage>`` totals; inside a ``device*`` span the programs' launch
spans (`detector`) and ``readback`` (the readback's enqueue); inside
``publish``, ``draw`` and ``encode``. A gather handed to the decode stage
adds its frames' wait since the router queued them into ``queue_wait_s``.

On a plain CUDA `Detector` the warm-up also captures the ``ycbcr`` units'
program as CUDA graphs at every bucket of each warmed JPEG geometry
(`Detector.capture_ycbcr_graphs`, counted in ``graph_captures``); a
``ycbcr`` unit of such a bucket and geometry then replays them inside its
program call, under the same launch spans (``graph_replays``). Every other
unit, geometry and detector launches eagerly.
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
from infercam_onnx_tpu_torch.detector import Detector, pack_coefficient_batch
from infercam_onnx_tpu_torch.draw import draw_detections
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops.jpeg_device import read_coefficient_batch
from infercam_onnx_tpu_torch.ops.jpeg_encode_device import (
    SUBSAMPLING_FACTORS, plane_geometry, splice_blocks, split_coefs)
from infercam_onnx_tpu_torch.parallel.data_parallel import ShardedDetector
from infercam_onnx_tpu_torch.parallel.tiling import TiledDetector
from infercam_onnx_tpu_torch.protocol import as_jpeg_stream_item
from infercam_onnx_tpu_torch.serving import link
from infercam_onnx_tpu_torch.serving.meter import METER
from infercam_onnx_tpu_torch.serving.router import InferJob
from infercam_onnx_tpu_torch.utils.profiling import STAGES

log = logging.getLogger("infercam.inferer")

# host dtype of each uploaded array -> its pinned staging dtype (the quant
# tables' uint16 goes up as int32: torch's uint16 has few ops)
_STAGING = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
            np.dtype(np.uint16): torch.int32}

# the stage each unit kind's program is timed under
_DEVICE_STAGE = {"pixels": "device", "ycbcr": "device_ycbcr",
                 "ycbcr_annot": "device_annot", "coef": "device_coef",
                 "coef_annot": "device_annot", "ycbcr_tiled": "device_tiled",
                 "ycbcr_tiled_rows": "device_tiled"}


class InferenceWorker:
    def __init__(
        self,
        detector: Detector,
        engine_config: EngineConfig = EngineConfig(),
        server_config: ServerConfig = ServerConfig(),
        mesh: list | None = None,
    ):
        """``mesh``: a list of devices to split batches over (a detector
        already built over a mesh, a `ShardedDetector` or a lockstep
        member, brings its own and is taken as it is); None with a plain
        detector serves on its one device."""
        if engine_config.tile_min_pixels and getattr(detector, "graph",
                                                     None) is not None:
            raise ValueError("--runtime graph does not support tiling")
        if mesh is not None and getattr(detector, "mesh", None) is None:
            # a graph detector re-binds its own programs to the mesh
            detector = (detector.to_mesh(mesh) if hasattr(detector, "to_mesh")
                        else ShardedDetector(detector, mesh))
        self._mesh = getattr(detector, "mesh", None)
        self._detector = detector
        self._cfg = engine_config
        self._server_cfg = server_config
        # device annotation needs the shim's entropy coder: build it now,
        # and raise here rather than serve the host draw path instead
        self._annotate_device = engine_config.annotate_mode == "device"
        if self._annotate_device or engine_config.decode_mode != "pixels":
            native_jpeg.load()
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
        # The device thread runs every program (and the warm-up), so the
        # units of one worker reach the device in gather order.
        self._decode_exec, self._device_exec, self._publish_exec = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix=name,
                               initializer=self._bind_device)
            for name in ("decode", "device", "publish"))
        self._loop: asyncio.AbstractEventLoop | None = None
        # device warm-up in progress (surfaced as /stats "warming")
        self.warming = False
        # splice frames annotated on the host instead (publish thread)
        self.splice_fallbacks = 0
        # the paths in effect until a link probe re-selects them; "auto"
        # is "rows" while a probe is due to decide it, else "stacked"
        self._effective_decode_mode = engine_config.decode_mode
        self._effective_annotate_mode = engine_config.annotate_mode
        if engine_config.tiled_upload != "auto":
            self._effective_tiled_route = engine_config.tiled_upload
        elif engine_config.link_adaptive:
            self._effective_tiled_route = "rows"
        else:
            self._effective_tiled_route = "stacked"
        # the last probe's verdict (/stats "link")
        self.link_status: dict = {
            "probed": False,
            "configured_decode_mode": engine_config.decode_mode,
            "decode_mode": engine_config.decode_mode,
        }
        # tiled detectors by decoded frame (h, w), built at first use
        self._tiled: dict[tuple[int, int], TiledDetector] = {}

    def probe_and_adapt(self, probe=None, probe_tiled=None) -> dict:
        """Probe the host->device link and re-select every transfer-
        sensitive path by `link.decide`: decode mode, tiled upload route,
        annotate mode. Run it on the device thread, so that it never
        interleaves with a dispatch; a recovered link restores the
        configured paths. Returns the new `link_status`.

        ``probe`` returns MB/s (default `link.probe_h2d_mbps` on the
        worker's device). The tiled route also gets an A/B timing of both
        upload routes (``probe_tiled``, default `link.probe_tiled_route_ms`)
        when it is "auto", ``link_tiled_ab_probe`` is on and
        ``tile_min_pixels`` is set; an injected ``probe`` without a
        ``probe_tiled`` takes no A/B."""
        cfg = self._cfg
        if probe is None:
            def probe():
                return link.probe_h2d_mbps(device=self.device)
            if probe_tiled is None:
                def probe_tiled():
                    return link.probe_tiled_route_ms(device=self.device)
        mbps = float(probe())
        ab = None
        if (probe_tiled is not None and cfg.tiled_upload == "auto"
                and cfg.link_tiled_ab_probe and cfg.tile_min_pixels):
            stacked_ms, rows_ms = probe_tiled()
            ab = (float(stacked_ms), float(rows_ms))
        decisions = link.decide(cfg, mbps, tiled_ab_ms=ab)
        for label, attr, key in (
                ("decode mode", "_effective_decode_mode", "decode_mode"),
                ("tiled upload", "_effective_tiled_route", "tiled_upload"),
                ("annotate mode", "_effective_annotate_mode",
                 "annotate_mode")):
            new = decisions[key]["effective"]
            if new != getattr(self, attr):
                log.warning("link-adaptive: %s %s -> %s (%s)", label,
                            getattr(self, attr), new, decisions[key]["why"])
            setattr(self, attr, new)
        self.link_status = {
            "probed": True,
            "h2d_mbps": round(mbps, 1),
            "healthy_mbps": cfg.link_healthy_h2d_mbps,
            "degraded": mbps < cfg.link_healthy_h2d_mbps,
            "configured_decode_mode": cfg.decode_mode,
            "decode_mode": decisions["decode_mode"]["effective"],
            "why": decisions["decode_mode"]["why"],
            "decisions": decisions,
            "tiled_ab_ms": (None if ab is None else
                            {"stacked": round(ab[0], 1),
                             "rows": round(ab[1], 1)}),
        }
        return self.link_status

    @property
    def _annotate_device_active(self) -> bool:
        """Device annotation configured and kept by the last probe."""
        return (self._annotate_device
                and self._effective_annotate_mode == "device")

    def _is_tiled(self, w: int, h: int) -> bool:
        """Whether a decoded w x h frame gets its detections from the tile
        grid (every call site shares this threshold)."""
        return bool(self._cfg.tile_min_pixels
                    and w * h >= self._cfg.tile_min_pixels)

    def _get_tiled(self, w: int, h: int) -> TiledDetector:
        tiled = self._tiled.get((h, w))
        if tiled is None:
            tiled = self._tiled[(h, w)] = TiledDetector(
                self._detector, (w, h), grid=self._cfg.tile_grid,
                overlap=self._cfg.tile_overlap, mesh=self._mesh)
        return tiled

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
        bucket = self._buckets[min(i, len(self._buckets) - 1)]
        if self._mesh is not None:
            # pad to a multiple of the replicas here, so the sharded
            # programs never pad again (a lockstep member's granularity is
            # its own replica count)
            m = self._detector.batch_granularity
            bucket = ((bucket + m - 1) // m) * m
        return bucket

    async def run(self) -> None:
        """decode(k+2) || device(k+1) || encode+publish(k), each stage on
        its own single-thread executor."""
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
                now = self._loop.time()
                stamped = [now - j.enqueued_at for j in jobs if j.enqueued_at]
                METER.tick_queue(len(stamped), sum(stamped))
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
        start each batch's upload (the module docstring lists the unit
        kinds). A frame nothing can decode is dropped and counted, not
        fatal."""
        scale = self._cfg.decode_scale
        mode = self._effective_decode_mode  # one read a gather
        annotate_device = self._annotate_device_active
        # in ycbcr and coefficients modes a viewer's frame rides the
        # device annotate tail when annotating on the device
        device_tail = mode != "pixels"
        annot = [j for j in jobs if j.reply is not None
                 and annotate_device and device_tail]
        pixel_jobs = [j for j in jobs if j not in annot
                      and (j.reply is not None or not device_tail)]
        plain = [j for j in jobs if j.reply is None and device_tail]
        frames: list[tuple[InferJob, np.ndarray]] = []

        def pixel_decode(job: InferJob, why) -> None:
            try:
                frames.append((job, codec.decode_rgb(job.data, scale)))
            except ValueError as e:
                log.warning("dropping corrupt frame on stream %x (%s)",
                            job.key, why or e)
                METER.tick_dropped()

        groups: list[tuple[str, list, dict | None]] = []
        with STAGES.stage("decode", cpu="cpu_s_decode"):
            if pixel_jobs:
                try:
                    decoded = codec.decode_batch(
                        [j.data for j in pixel_jobs], scale)
                    frames = list(zip(pixel_jobs, decoded))
                except ValueError:
                    for job in pixel_jobs:
                        pixel_decode(job, None)
            decoders = {"coef": self._decode_coefficients,
                        "ycbcr": self._decode_ycbcr}
            plain_base = "coef" if mode == "coefficients" else "ycbcr"
            # a detector without the splice transcode (a graph detector)
            # annotates coefficients-mode frames on the ycbcr tail, as the
            # JAX worker does
            annot_base = ("coef" if mode == "coefficients" and hasattr(
                self._detector, "run_device_coefficients_annotated")
                else "ycbcr")
            for kind, base, chosen in (("", plain_base, plain),
                                       ("_annot", annot_base, annot)):
                for members, geom in (decoders[base](chosen, pixel_decode)
                                      if chosen else ()):
                    w, h = ((geom["width"], geom["height"]) if geom
                            else members[0][1][4])  # coefficients: wh
                    if not self._is_tiled(w, h):
                        groups.append((base + kind, members, geom))
                    elif kind == "_annot":
                        # its detections must come from the tile grid:
                        # pixel-decode it and draw on the host
                        for job, _ in members:
                            pixel_decode(job, "tiled stream: host annotate")
                    elif base == "ycbcr":
                        groups.append((
                            "ycbcr_tiled_rows"
                            if (self._effective_tiled_route == "rows"
                                and self._mesh is None)
                            else "ycbcr_tiled", members, geom))
                    else:  # detection-only coefficients do not tile
                        groups.append((base, members, geom))

        units: list[dict] = []
        with STAGES.stage("upload", cpu="cpu_s_upload"):
            by_shape: dict[tuple, list] = {}
            for job, frame in frames:
                needs_annot = annotate_device and job.reply is not None
                by_shape.setdefault((frame.shape[:2], needs_annot),
                                    []).append((job, frame))
            for ((h, w), needs_annot), members in by_shape.items():
                # a frame that tiles is annotated on the host
                units.append(self._unit(
                    "pixels", members,
                    annotate=needs_annot and not self._is_tiled(w, h)))
            units.extend(self._unit(kind, members, geom)
                         for kind, members, geom in groups)
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

    def _decode_coefficients(self, jobs: list[InferJob], pixel_decode):
        """[(members, None)]: the jobs' entropy-decoded coefficients
        grouped by JPEG geometry, members as (job, `read_coefficient_batch`
        of that one frame). A frame the coefficient export refuses goes to
        ``pixel_decode``."""
        by_geom: dict[tuple, list] = {}
        for job in jobs:
            try:
                planes = read_coefficient_batch([job.data])
            except ValueError as e:
                pixel_decode(job, e)
                continue
            key = (planes[4], planes[5], planes[0].shape, planes[1].shape)
            by_geom.setdefault(key, []).append((job, planes))
        return [(members, None) for members in by_geom.values()]

    def _unit(self, kind: str, members: list, geom: dict | None = None, *,
              annotate: bool = False) -> dict:
        """One padded batch of ``members`` (job, frame | packed row |
        coefficient planes), uploading: the device stage's work item.
        ``batch`` is the uploaded tensor, for coefficient kinds the tuple
        of them, for ``ycbcr_tiled_rows`` the tuple of its [n] rows;
        ``geom`` the packed rows' geometry (ycbcr kinds)."""
        bucket = self._bucket_size(len(members))
        extra = len(members) - bucket
        if extra > 0:
            # the gather window stops at the largest bucket, so this
            # should not happen; count it if it does
            log.warning("batch group overflow: dropping %d frames beyond "
                        "bucket %d", extra, bucket)
            METER.tick_dropped(extra)
            members = members[:bucket]
        unit = {"kind": kind, "members": members, "n": len(members),
                "geom": geom, "annotate": annotate}
        rows = [r for _, r in members]
        if kind == "pixels":
            unit["h"], unit["w"] = rows[0].shape[:2]
            columns = [(rows, 0)]
        elif kind.startswith("ycbcr"):
            unit["w"], unit["h"] = geom["width"], geom["height"]
            columns = [(rows, 0)]
        else:  # coefficients: (y, cb, cr, quant, wh, sampling) each
            (unit["w"], unit["h"]), unit["sampling"] = rows[0][4:6]
            y, cb, cr, quant = ([r[i][0] for r in rows] for i in range(4))
            if kind == "coef":
                columns = [(y, 0), (cb, 0), (cr, 0), (quant, 0)]
            else:
                # pack the zero-padded batch as the JAX worker does; quant
                # pads with ones, so padded rows stay finite through the
                # dequantize/requantize round trip
                pad = bucket - len(rows)
                y, cb, cr, quant = (np.concatenate([np.stack(p), np.full(
                    (pad, *p[0].shape), fill, p[0].dtype)]) for p, fill in (
                        (y, 0), (cb, 0), (cr, 0), (quant, 1)))
                packed12, quant, unit["shapes"] = pack_coefficient_batch(
                    y, cb, cr, quant)
                columns = [(list(packed12), 0), (list(quant), 1)]
        if kind.startswith("ycbcr") or kind.startswith("coef"):
            # packed rows and coefficients carry no frame to draw on
            unit["members"] = [(job, None if kind != "coef_annot" else r)
                               for job, r in members]
        if kind == "ycbcr_tiled_rows":
            # one pinned tensor and one copy a row, padding rows included
            pad = [np.zeros_like(rows[0])] * (bucket - len(rows))
            batch, unit["ready"] = self._to_device(
                [self._staged([r], 0, 1)[0] for r in rows + pad])
            unit["batch"] = tuple(batch)
            return unit
        batch, unit["ready"] = self._to_device(
            [self._staged(col, fill, bucket) for col, fill in columns])
        unit["batch"] = batch[0] if len(batch) == 1 else tuple(batch)
        return unit

    def _staged(self, rows: list[np.ndarray], fill, bucket: int
                ) -> torch.Tensor:
        """``rows`` as a [bucket, *row shape] host tensor (pinned for a
        CUDA device), its rows after ``len(rows)`` set to ``fill``."""
        host = torch.empty((bucket, *rows[0].shape),
                           dtype=_STAGING[rows[0].dtype],
                           pin_memory=self._copy_stream is not None)
        view = host.numpy()
        view[:len(rows)] = rows
        view[len(rows):] = fill
        return host

    def _to_device(self, hosts: list[torch.Tensor]
                   ) -> tuple[list[torch.Tensor], torch.cuda.Event | None]:
        """``hosts`` on the device, and the one event after which all of
        them are there (None on the CPU, where they are used as they
        are, and on a mesh, where the detector copies each replica's
        shard from them)."""
        if self._copy_stream is None or self._mesh is not None:
            return hosts, None
        with torch.cuda.stream(self._copy_stream):
            batches = [h.to(self.device, non_blocking=True) for h in hosts]
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        for batch in batches:
            batch.record_stream(self._compute_stream)
        return batches, ready

    # -- stage 2: dispatch + readback (device thread) ----------------------

    def _device_stage(self, units: list[dict]) -> list[dict]:
        """Dispatch each uploaded unit and start its readback; returns the
        publish stage's entries."""
        results = []
        graphs = self._detector.graphs
        replays = graphs.replays if graphs is not None else 0
        for unit in units:
            with STAGES.stage(_DEVICE_STAGE[unit["kind"]],
                              cpu="cpu_s_device") as span:
                outs, done = self._run_unit(unit)
            METER.tick_batch(unit["n"], span.seconds)
            entry = {"members": unit["members"], "done": done,
                     "w": unit["w"], "h": unit["h"], "coefs": None,
                     "geom": None, "splice": None, "packed": outs[-1]}
            if unit["kind"] == "coef_annot":
                entry["splice"] = {"blocks": outs[0], "meta": outs[1],
                                   "k": self._cfg.annotate_splice_blocks}
            elif unit["kind"] == "ycbcr_annot" or unit["annotate"]:
                entry["coefs"] = outs[0]
                entry["geom"] = unit["geom"] or plane_geometry(
                    unit["w"], unit["h"], SUBSAMPLING_FACTORS[
                        self._server_cfg.jpeg_subsampling])
            results.append(entry)
        if graphs is not None and graphs.replays > replays:
            METER.tick_graph_replays(graphs.replays - replays)
        return results

    def _program(self, unit: dict):
        """The unit's device program: its outputs, packed detections
        last."""
        det, cfg, srv = self._detector, self._cfg, self._server_cfg
        kind, batch = unit["kind"], unit["batch"]
        dims = srv.assume_frame_dims
        if kind == "pixels" and unit["annotate"]:
            return det.run_device_annotated(
                batch, quality=srv.jpeg_quality,
                subsampling=srv.jpeg_subsampling, disp_dims=dims)
        tile_kw = dict(grid=cfg.tile_grid, overlap=cfg.tile_overlap)
        if kind == "pixels" and self._is_tiled(unit["w"], unit["h"]):
            if hasattr(det, "run_device_tiled"):  # inside a lockstep round
                return det.run_device_tiled(batch, (unit["w"], unit["h"]),
                                            **tile_kw)
            return self._get_tiled(unit["w"], unit["h"]).run_device(
                batch, pack_output=True)
        if kind == "pixels":
            return det.run_device(batch, pack_output=True)
        if kind == "ycbcr_tiled" and hasattr(det, "run_device_tiled_ycbcr"):
            return det.run_device_tiled_ycbcr(batch, unit["geom"], **tile_kw)
        if kind in ("ycbcr_tiled", "ycbcr_tiled_rows"):
            tiled = self._get_tiled(unit["w"], unit["h"])
            run = (tiled.run_device_ycbcr_rows if kind == "ycbcr_tiled_rows"
                   else tiled.run_device_ycbcr_packed)
            return run(batch, unit["geom"], pack_output=True)
        if kind == "ycbcr":
            return det.run_device_ycbcr_packed(batch, unit["geom"],
                                               pack_output=True)
        if kind == "ycbcr_annot":
            return det.run_device_ycbcr_annotated(
                batch, unit["geom"], quality=srv.jpeg_quality,
                disp_dims=dims)
        if kind == "coef":
            return det.run_device_coefficients_arrays(
                *batch, (unit["w"], unit["h"]), sampling=unit["sampling"],
                pack_output=True)
        return det.run_device_coefficients_annotated_packed(
            *batch, wh=(unit["w"], unit["h"]), shapes=unit["shapes"],
            sampling=unit["sampling"], k=cfg.annotate_splice_blocks,
            disp_dims=dims)

    def _run_unit(self, unit: dict):
        """The unit's outputs (packed detections last) as host tensors,
        and the event after which they may be read (None on the CPU, where
        they are ready on return). The ``readback`` span times the
        readback's enqueue."""
        if self._compute_stream is None:
            outs = self._program(unit)
            with STAGES.stage("readback"):
                return (outs if isinstance(outs, tuple) else (outs,)), None
        with torch.cuda.stream(self._compute_stream):
            if unit["ready"] is not None:
                self._compute_stream.wait_event(unit["ready"])
            outs = self._program(unit)
            with STAGES.stage("readback"):
                hosts = []
                for out in (outs if isinstance(outs, tuple) else (outs,)):
                    host = torch.empty(out.shape, dtype=out.dtype,
                                       pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    hosts.append(host)
                done = torch.cuda.Event()
                done.record(self._compute_stream)
        return tuple(hosts), done

    # -- stage 3: encode + publish (publish thread) ---------------------------

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
        for entry in results:
            with STAGES.stage("readback_wait", cpu="cpu_s_readback_wait"):
                if entry["done"] is not None:
                    entry["done"].synchronize()  # the readback has landed
            with STAGES.stage("publish", cpu="cpu_s_publish"):
                self._publish_entry(entry)

    def _publish_entry(self, entry: dict) -> None:
        """One unit's records and annotated parts to its streams."""
        packed = entry["packed"].numpy()
        w, h = entry["w"], entry["h"]
        for i, (job, frame) in enumerate(entry["members"]):
            if job.det_reply is not None:
                self._publish(job.det_reply,
                              self._detections_json(packed[i], w, h))
            if job.reply is not None:
                jpeg = self._annotated_jpeg(entry, i, frame)
                if jpeg is not None:
                    self._publish(job.reply, as_jpeg_stream_item(jpeg))
            self._tick_e2e(job)
        METER.tick_inferred_unique(len(entry["members"]))

    def _annotated_jpeg(self, entry: dict, i: int, frame) -> bytes | None:
        """Row ``i``'s annotated output JPEG: the splice's, the device
        tail's coefficients entropy-coded, or the host's draw + encode of
        the frame; None when the frame is dropped."""
        packed_row = entry["packed"].numpy()[i]
        job = entry["members"][i][0]
        if entry["splice"] is not None:
            splice = entry["splice"]
            return self._finish_splice(job, frame, packed_row,
                                       splice["meta"].numpy()[i],
                                       splice["blocks"].numpy()[i],
                                       splice["k"])
        if entry["coefs"] is not None:
            geom = entry["geom"]
            with STAGES.stage("encode"):
                yq, cbq, crq = split_coefs(entry["coefs"].numpy()[i], geom)
                return native_jpeg.load().encode_coefs(
                    yq, cbq, crq, (geom["width"], geom["height"]),
                    geom["sampling"], native_jpeg.quant_tables_cached(
                        self._server_cfg.jpeg_quality))
        return self._host_annotate(frame, packed_row)

    def _host_annotate(self, frame: np.ndarray,
                       packed_row: np.ndarray) -> bytes:
        """Draw the detections on the frame with PIL and encode it."""
        count = int(packed_row[:, 5].sum())
        dets = [(packed_row[d, :4], float(packed_row[d, 4]))
                for d in range(count)]
        with STAGES.stage("draw"):
            annotated = draw_detections(frame, dets,
                                        self._server_cfg.assume_frame_dims)
        with STAGES.stage("encode"):
            return codec.encode_rgb(annotated, self._server_cfg.jpeg_quality,
                                    self._server_cfg.jpeg_subsampling)

    def _finish_splice(self, job: InferJob, planes, packed_row: np.ndarray,
                       meta: np.ndarray, blocks: np.ndarray,
                       k: int) -> bytes | None:
        """The host tail of the splice transcode for one frame: the
        device's touched blocks written into the frame's own
        entropy-decoded coefficients, then entropy-coded with the frame's
        own tables. A frame over the block budget, or whose chroma quant
        tables differ (the coder takes one chroma table), is annotated on
        the host from its JPEG bytes instead; None if those do not
        decode."""
        y_o, cb_o, cr_o, quant, wh, sampling = planes
        n_touched = int(meta[0])
        if n_touched <= k and np.array_equal(quant[0, 1], quant[0, 2]):
            with STAGES.stage("encode"):
                ys, cbs, crs = splice_blocks(y_o[0], cb_o[0], cr_o[0], meta,
                                             blocks)
                return native_jpeg.load().encode_coefs(ys, cbs, crs, wh,
                                                       sampling, quant[0, :2])
        self.splice_fallbacks += 1
        log.debug("splice fallback on stream %x (%d blocks > %d)", job.key,
                  n_touched, k)
        try:
            frame = codec.decode_rgb(job.data)
        except ValueError:
            return None
        return self._host_annotate(frame, packed_row)

    def warmup(self, resolutions: list[tuple[int, int]] | None = None):
        """Run every program the configuration serves once for every
        bucket at each (h, w) resolution as senders send it (decode_scale
        applied), so kernel builds, cuDNN's algorithm choices and the
        resize matrices are done before traffic: detection, the annotated
        program of the decode mode when annotating on the device, and in
        the ycbcr and coefficients modes their programs on a 4:2:0 probe
        JPEG of each resolution. At a resolution that tiles, the tiled
        programs stand in for detection and no annotated program runs
        (such frames are drawn on the host), as in serving; detection-only
        coefficients keep their untiled program. After the untiled ycbcr
        program's eager run at a bucket, the detector captures it as CUDA
        graphs where it can (`Detector.capture_ycbcr_graphs`). The modes
        are the effective ones, so a probe first warms what will serve.
        `serving.app` runs it on the device thread."""
        det, srv = self._detector, self._server_cfg
        s, mode = self._cfg.decode_scale, self._effective_decode_mode
        annotate_device = self._annotate_device_active
        dims = srv.assume_frame_dims
        for (h, w) in resolutions or [(480, 640)]:
            probe = codec.encode_rgb(np.zeros((h, w, 3), np.uint8), 90,
                                     "420")
            tiled = (self._get_tiled(w // s, h // s)
                     if self._is_tiled(w // s, h // s) else None)
            for b in self._buckets:
                frames = np.zeros((b, h // s, w // s, 3), np.uint8)
                if tiled is not None:
                    tiled.run_device(frames, pack_output=True)
                else:
                    det.warmup(b, h // s, w // s, pack_output=True)
                if annotate_device and mode == "pixels" and tiled is None:
                    det.run_device_annotated(
                        frames, quality=srv.jpeg_quality,
                        subsampling=srv.jpeg_subsampling, disp_dims=dims)
                if mode == "ycbcr":
                    packed, geom = native_jpeg.load().decode_ycbcr_batch(
                        [probe] * b, scale=s)
                    gw, gh = geom["width"], geom["height"]
                    if self._is_tiled(gw, gh):
                        self._get_tiled(gw, gh).run_device_ycbcr_packed(
                            packed, geom, pack_output=True)
                    else:
                        det.run_device_ycbcr_packed(packed, geom,
                                                    pack_output=True)
                        if det.capture_ycbcr_graphs(packed, geom):
                            METER.tick_graph_captures()
                    if annotate_device and not self._is_tiled(gw, gh):
                        det.run_device_ycbcr_annotated(
                            packed, geom, quality=srv.jpeg_quality,
                            disp_dims=dims)
                if mode == "coefficients":
                    y, cb, cr, q, wh, samp = read_coefficient_batch(
                        [probe] * b)
                    det.run_device_coefficients_arrays(
                        y, cb, cr, q, wh, sampling=samp, pack_output=True)
                    if not annotate_device or self._is_tiled(*wh):
                        continue
                    if hasattr(det, "run_device_coefficients_annotated"):
                        det.run_device_coefficients_annotated(
                            y, cb, cr, q, wh, sampling=samp,
                            k=self._cfg.annotate_splice_blocks,
                            disp_dims=dims)
                    else:  # the ycbcr annotate tail (no splice program)
                        packed, geom = native_jpeg.load().decode_ycbcr_batch(
                            [probe] * b, scale=s)
                        det.run_device_ycbcr_annotated(
                            packed, geom, quality=srv.jpeg_quality,
                            disp_dims=dims)
            for dev in set(self._mesh or [self.device]):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
