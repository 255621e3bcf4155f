"""Configuration, device selection and float32 precision.

``DetectorConfig``, ``EngineConfig``, ``ServerConfig``,
``ClientConfig`` and ``ParallelConfig`` mirror
``infercam_onnx_tpu/config.py`` with the same names, fields and defaults
(the reference's serve-time setup: RFB-320, max_iou 0.5, min_confidence
0.5, JPEG quality 95 at 4:2:0, ingest capacity 200, broadcast rings of
20, device annotation, the link policy's thresholds, tiling off).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Detection model + post-processing configuration."""

    variant: str = "RFB-320"  # RFB-320/640 or slim-320/640
    max_iou: float = 0.5
    min_confidence: float = 0.5
    # `top_k` candidates enter NMS; `max_detections` boxes come out.
    top_k: int = 256
    max_detections: int = 64
    # dtype of the conv trunk; float32 is used by parity tests.
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Micro-batching inference engine configuration."""

    # A batch of N frames runs padded to the smallest bucket >= N.
    batch_buckets: Sequence[int] = (1, 2, 4, 8, 16)
    # Bounded device work queue; frames are DROPPED when it is full
    # (the reference's try_send backpressure, infer channel cap 10).
    queue_capacity: int = 10
    # Max time to wait for more frames before dispatching a partial batch.
    batch_window_ms: float = 4.0
    # Keep only the newest frame per stream within a gather window; False
    # batches every queued frame, several of one stream per batch.
    coalesce_streams: bool = True
    # Decode incoming JPEGs at 1/decode_scale resolution (libjpeg's IDCT
    # scaling).
    decode_scale: int = 1
    # "pixels": host JPEG decode feeds uint8 RGB frames to the device.
    # "ycbcr": frames are decoded on the host to packed YCbCr planes
    # (entropy decode + IDCT, ~half the bytes of RGB at 4:2:0); chroma
    # upsampling and colour conversion run on the device.
    # "coefficients": the host only entropy-decodes; the IDCT runs on the
    # device too. In both, frames with a /face_stream viewer take the
    # device annotate tail with annotate_mode="device" (in coefficients
    # mode the splice transcode), the pixels path with "host".
    decode_mode: str = "pixels"
    # "device": /face_stream frames get their overlay, FDCT and
    # quantization on the device, and the host only entropy-codes them.
    # It needs the native JPEG shim; where that cannot build, the server
    # raises rather than fall back to the host draw path.
    # "host": drawn with PIL and JPEG-encoded on the host.
    annotate_mode: str = "device"
    # Per-frame budget of overlay-touched 8x8 blocks the splice transcode
    # reads back; a frame whose overlay touches more is annotated on the
    # host from its JPEG bytes.
    annotate_splice_blocks: int = 768
    # Link-adaptive path selection (serving/link.py): probe the
    # host->device rate after the warm-up and re-select the decode mode,
    # the tiled upload route and the annotate mode by it; /stats shows the
    # decisions under "link".
    link_adaptive: bool = True
    # MB/s at or above which the link is healthy; below it the
    # coefficients mode serves through the packed YCbCr planes.
    link_healthy_h2d_mbps: float = 250.0
    # Re-probe every this many seconds (0: once, after the warm-up).
    link_probe_period_s: float = 0.0
    # MB/s below which device annotation gives way to the host draw.
    link_annotate_floor_mbps: float = 10.0
    # MB/s below which tiled_upload "auto" picks "rows" when no A/B
    # measurement is taken.
    link_tiled_rows_below_mbps: float = 40.0
    # Time both tiled upload routes on each probe and let "auto" pick
    # the faster (needs tile_min_pixels).
    link_tiled_ab_probe: bool = True
    # A/B gaps under this percent of the slower route pick "stacked".
    link_tiled_ab_tie_pct: float = 10.0
    # Upload of tiled packed-plane batches: "stacked" (one copy of the
    # batch), "rows" (one copy a frame, stacked on the device) or "auto"
    # (by the link probe; "rows" until the first probe when link_adaptive
    # is on, "stacked" when it is off). The thresholds above were measured
    # on the JAX package's TPU host link.
    tiled_upload: str = "auto"
    # Frames (after decode) with at least this many pixels run through an
    # overlapping tile grid with a cross-tile NMS merge
    # (parallel/tiling.py); 0 turns tiling off.
    tile_min_pixels: int = 0
    tile_grid: tuple[int, int] = (2, 2)
    tile_overlap: float = 0.2

    def __post_init__(self):
        for field, value, known in (
                ("decode_mode", self.decode_mode,
                 ("pixels", "ycbcr", "coefficients")),
                ("annotate_mode", self.annotate_mode, ("device", "host")),
                ("tiled_upload", self.tiled_upload,
                 ("auto", "rows", "stacked"))):
            if value not in known:
                raise ValueError(f"unknown {field} {value!r}; use one of "
                                 f"{known}")
        if self.annotate_splice_blocks < 1:
            raise ValueError(f"annotate_splice_blocks must be >= 1, got "
                             f"{self.annotate_splice_blocks}")
        if not self.batch_buckets or min(self.batch_buckets) < 1:
            raise ValueError(f"bad batch_buckets {self.batch_buckets!r}")
        if self.decode_scale not in (1, 2, 4, 8):
            raise ValueError(f"decode_scale must be 1, 2, 4 or 8, got "
                             f"{self.decode_scale}")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving tier configuration (TCP ingest + HTTP MJPEG). Port 0 in
    either address binds a free port; `serving.app.InferServer` reads it
    back."""

    http_address: str = "127.0.0.1:3000"
    socket_address: str = "127.0.0.1:3001"
    # Ingest channel capacity (the reference's StaticChannel<_, 200>).
    ingest_capacity: int = 200
    # Broadcast ring capacity per subscriber.
    broadcast_capacity: int = 20
    # Frames processed per router subscriber-map refresh.
    router_refresh_every: int = 4
    # Output JPEG encoding (the reference's quality 95, 4:2:0).
    jpeg_quality: int = 95
    jpeg_subsampling: str = "420"
    # FPS meter log period in seconds.
    meter_period_s: float = 2.0
    # Scale relative boxes by these (width, height) when drawing instead
    # of the decoded frame's own size (the reference hard-codes 1280x720).
    assume_frame_dims: tuple[int, int] | None = None
    # Re-exec the server process when its RSS exceeds this many MiB
    # (0 = off); senders reconnect after their backoff.
    max_rss_mb: int = 0
    # How often the RSS watchdog samples, in seconds.
    rss_check_period_s: float = 10.0


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """Edge sender configuration."""

    address: str = "127.0.0.1:3001"
    channel: str = "simon"
    reconnect_backoff_s: float = 3.0
    camera_device: str = "/dev/video0"


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Multi-GPU scale-out configuration (the JAX package's fields and
    defaults; like the JAX package, nothing reads it yet)."""

    # name of the data-parallel axis (the batch is split over it)
    data_axis: str = "data"
    # high-resolution tiled detection: tile grid (cols x rows)
    tile_grid: tuple[int, int] = (2, 2)
    # fractional overlap of adjacent tiles, so a face on a seam is seen
    # whole by at least one tile
    tile_overlap: float = 0.2


def resolve_device(device: str | torch.device | None = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on (``None`` means ``"cuda"``);
    raises rather than falling back.

    A CUDA device with no GPU present is an error, and so is an index
    beyond ``torch.cuda.device_count()``: the port never carries on
    silently on the CPU or on another card. Pass ``device="cpu"`` to run
    there on purpose.

    For the CPU it also fixes the intra-op thread count at its current
    value (`torch.set_num_threads`), which turns off MKL's dynamic mode:
    in it MKL picks each float32 matmul's thread count from the host's
    load, the resize sums split differently, and the same frames give
    other results from one run to the next.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if (dev.type == "cuda" and dev.index is not None
            and dev.index >= torch.cuda.device_count()):
        raise RuntimeError(f"{dev} does not exist: have "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        torch.set_num_threads(torch.get_num_threads())
    return dev


class _Float32Scopes:
    """The open `full_float32` scopes of the process, counted under one
    lock: the first to open saves the caller's precisions and sets
    ``"ieee"``, the last to close restores them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.saved: tuple[str, str] | None = None


_SCOPES = _Float32Scopes()


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls and cuDNN convs in IEEE float32 within the block.

    PyTorch lets cuDNN convs use TF32 by default, and any caller may turn
    it on for matmuls; TF32 moves the resize sums across the u8 rounding
    boundary and the float32 trunk off its reference. This sets both
    per-op precisions to ``"ieee"`` and restores the caller's after. It
    uses only the ``fp32_precision`` settings, which are what the CUDA
    kernels read. They are process-wide, so the scopes are counted across
    threads: the first scope to open saves the settings, the last to close
    restores them, and while any is open the whole process, other threads'
    float32 work included, runs in IEEE float32."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    with _SCOPES.lock:
        if _SCOPES.depth == 0:
            _SCOPES.saved = (matmul.fp32_precision, conv.fp32_precision)
            matmul.fp32_precision = conv.fp32_precision = "ieee"
        _SCOPES.depth += 1
    try:
        yield
    finally:
        with _SCOPES.lock:
            _SCOPES.depth -= 1
            if _SCOPES.depth == 0:
                matmul.fp32_precision, conv.fp32_precision = _SCOPES.saved
